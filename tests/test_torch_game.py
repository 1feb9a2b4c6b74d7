"""The port's ``GameServer`` against the JAX package's, packet for packet.

One packet script runs through a JAX ``GameServer(1, world, addrs)`` and
the port's (its World on ``device="cpu"``), both without a network: two
dispatcher connections that never start, whose ``send`` is a stub that
captures each packet as it would go on the wire. Both Worlds hold two
AOI Spaces at capacity 256 on the plain sweep (``ranges``/``argsort``),
the planes off, under a fake clock; ``ids.gen_entity_id`` is a seeded
sequence, alike on both sides. Each tick the script's packets enter
through ``_on_packet_netthread``, then ``pump()`` and ``tick()`` run, and
every outbound packet of the tick must be byte for byte the JAX
package's, on the same connection, in the same order.

The script: the dispatchers' acks and deployment-ready, two clients
connecting (boot entity ``Account``) and logging in (an ``Avatar`` each
in Space A), a server ``Entity.Call`` RPC, client position syncs, attr
sync, ``OnSay`` to every client that sees the speaker, random-walking
Monsters around them, the overload ladder forced to DEGRADED with
``sync_stride`` 2, ``enter_space`` from Space A to Space B, a client
disconnect, a destroy, then a freeze through the dispatchers' acks.
Each freeze file then restores into the other package's server
(``GameServer(restore=True)``): the port's file into a JAX server and
the JAX file into the port's, and the two restored servers run on,
held to the same packets.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from goworld_tpu import entity as jent
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.net import codec as jcodec
from goworld_tpu.net import game as jgame
from goworld_tpu.net import packet as jpacket
from goworld_tpu.net import proto as jproto
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.utils import ids as jids
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.net import game as tgame
from goworld_tpu_torch.net import packet as tpacket
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids as tids

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

CAP = 256
EXTENT = 600.0
GRID = dict(radius=50.0, extent_x=EXTENT, extent_z=EXTENT, k=32,
            cell_cap=12, row_block=CAP, topk_impl="sort", skin=0.0,
            precision="off", sweep_impl="ranges", sort_impl="argsort")
WORLD = dict(capacity=CAP, npc_speed=5.0, enter_cap=2048, leave_cap=2048,
             sync_cap=1024, attr_sync_cap=64, input_cap=64,
             delta_rows_cap=CAP)
ADDRS = [("127.0.0.1", 1), ("127.0.0.1", 2)]
PHASES = ["ready", "connect", "login", "server_rpc", "client_syncs",
          "attr_and_say", "monsters", "degraded_stride", "enter_space",
          "disconnect_destroy", "freeze"]


def fixed(name: str) -> str:
    return tids.gen_fixed_id(f"test_torch_game.{name}")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def game_types(pkg) -> dict:
    class Account(pkg.Entity):
        ATTRS = {"status": "client"}

        def OnClientConnected(self):
            self.attrs["status"] = "online"

        def Login_Client(self, name, x, z):
            av = self.world.create_entity(
                "Avatar", space=self.world.spaces[fixed("arenaA")],
                pos=(float(x), 0.0, float(z)))
            av.attrs["name"] = name
            self.give_client_to(av)
            self.destroy()

    class Avatar(pkg.Entity):
        ATTRS = {"name": "allclients", "level": "client",
                 "hp": "allclients"}

        def OnClientConnected(self):
            self.attrs["level"] = 1

        def Heal(self, n):
            self.attrs["hp"] = self.attrs.get("hp", 0) + n

        def Say_Client(self, text):
            self.call_all_clients("OnSay", self.id, text)

        def Travel_Client(self, x, z):
            self.enter_space(fixed("arenaB"), (float(x), 0.0, float(z)))

        def Quit_Client(self):
            self.destroy()

    class Monster(pkg.Entity):
        ATTRS = {"hp": "allclients"}

    class Arena(pkg.Space):
        pass

    return dict(Account=Account, Avatar=Avatar, Monster=Monster,
                Arena=Arena)


class Side:
    """One package's game server, its captured sends by tick."""

    def __init__(self, pkg, restore_dir=None):
        self.pkg = pkg
        self.jax = pkg is jent
        self.game = jgame if self.jax else tgame
        self.packet = jpacket if self.jax else tpacket
        self.clock = Clock()
        grid = (JGrid if self.jax else TGrid)(**GRID)
        cfg = (JConfig if self.jax else TConfig)(grid=grid, **WORLD)
        make = dict(telemetry_live=False, residency=False, audit=False)
        if not self.jax:
            make["device"] = "cpu"
        w = pkg.World(cfg, n_spaces=2, game_id=1, clock=self.clock,
                      seed=3, **make)
        types = game_types(pkg)
        for name in ("Account", "Avatar", "Monster"):
            w.register_entity(name, types[name])
        w.register_space("Arena", types["Arena"])
        if restore_dir is None:
            w.create_nil_space()
            for name in ("arenaA", "arenaB"):
                w.create_space("Arena", eid=fixed(name))
        self.world = w
        self.gs = self.game.GameServer(
            1, w, ADDRS, boot_entity="Account", sync_age=False,
            gc_freeze_on_boot=False, flightrec_ring=0,
            overload_up_ticks=1, degraded_sync_stride=2,
            restore=restore_dir is not None,
            freeze_dir=restore_dir or ".")
        self.sent: list = []
        for i, conn in enumerate(self.gs.cluster.conns):
            conn.send = (lambda p, release=True, i=i: self.sent.append(
                (i, self.packet.wire_payload(p))))

    def feed(self, frames: list) -> None:
        for didx, raw in frames:
            mt, pkt = self.packet.decode_wire(raw)
            self.gs._on_packet_netthread(didx, mt, pkt)

    def step(self, frames: list) -> list:
        self.clock.t += 1.0 / 60.0
        self.feed(frames)
        self.gs.pump()
        self.gs.tick()
        out, self.sent = self.sent, []
        return out


def frame(p) -> bytes:
    return jpacket.wire_payload(p)


def ack(disp: int) -> bytes:
    p = jpacket.new_packet(jproto.MT_SET_GAME_ID_ACK)
    p.append_u16(disp)
    p.append_data({})
    p.append_data([])
    p.append_data([1])
    return frame(p)


def client_call(eid: str, cid: str, method: str, *args) -> bytes:
    p = jproto.pack_call_entity_method(eid, method, args, cid)
    return frame(p)


def syncs(recs: list) -> bytes:
    p = jpacket.new_packet(jproto.MT_SYNC_POSITION_YAW_FROM_CLIENT)
    p.append_bytes(jcodec.encode_sync_batch(
        [r[0] for r in recs], [r[1:] for r in recs]))
    return frame(p)


def seeded_ids(monkeypatch) -> None:
    """``gen_entity_id`` on both packages: one seeded sequence each."""
    for mod in (jids, tids):
        seq = itertools.count()
        monkeypatch.setattr(
            mod, "gen_entity_id",
            lambda seq=seq, mod=mod: mod.gen_fixed_id(f"gen.{next(seq)}"))


def run_script(sides: list, tmp_path) -> dict:
    """The packet script on every side; the outbound packets of each
    tick by phase, per side."""
    got = {ph: [[] for _ in sides] for ph in PHASES}

    def ticks(phase, frames_by_tick):
        for frames in frames_by_tick:
            for i, s in enumerate(sides):
                got[phase][i].append(s.step(frames))

    c1, c2 = fixed("client1"), fixed("client2")
    b1, b2 = fixed("boot1"), fixed("boot2")
    ticks("ready", [[(0, ack(1)), (1, ack(2))],
                    [(0, frame(jpacket.new_packet(
                        jproto.MT_NOTIFY_DEPLOYMENT_READY)))]])
    ticks("connect", [[(0, frame(jproto.pack_notify_client_connected(
        b1, c1, 1))), (1, frame(jproto.pack_notify_client_connected(
            b2, c2, 1)))], []])
    ticks("login", [[(0, client_call(b1, c1, "Login_Client", "alice",
                                     100.0, 100.0)),
                     (1, client_call(b2, c2, "Login_Client", "bob",
                                     110.0, 95.0))], [], []])
    w = sides[0].world
    avatars = sorted((e.id for e in w.entities.values()
                      if e.type_name == "Avatar"),
                     key=lambda e: w.entities[e].attrs["name"])
    for s in sides[1:]:
        assert sorted((e.id for e in s.world.entities.values()
                       if e.type_name == "Avatar"),
                      key=lambda e: s.world.entities[e].attrs["name"]) \
            == avatars
    a1, a2 = avatars
    ticks("server_rpc", [[(0, frame(jproto.pack_call_entity_method(
        a1, "Heal", (7,))))], []])
    rng = np.random.default_rng(1)
    walk = []
    for t in range(4):
        walk.append([(t % 2, syncs([
            (a1, 100.0 + t, 0.0, 100.0 + 0.5 * t, 0.1 * t),
            (a2, 110.0 - t, 0.0, 95.0, float(rng.uniform(0, 6)))]))])
    ticks("client_syncs", walk)
    ticks("attr_and_say", [[(1, frame(jproto.pack_call_entity_method(
        a2, "Heal", (3,)))), (0, client_call(a1, c1, "Say_Client", "hi"))],
        []])
    for s in sides:
        arena = s.world.spaces[fixed("arenaA")]
        mrng = np.random.default_rng(9)
        for i in range(40):
            arena.create_entity(
                "Monster", pos=(float(mrng.uniform(40, 170)), 0.0,
                                float(mrng.uniform(40, 170))),
                eid=fixed(f"monster{i}"), moving=True, attrs={"hp": i})
    ticks("monsters", [[], [], []])
    shed = []
    for s in sides:
        s.gs._observe_overload(1.6 * s.gs.tick_interval, 0.0)
        assert s.world.sync_stride == 2
        ov = s.game.overload
        shed.append(ov.shed_counter(ov.CLASS_SYNC, "stride").value)
    ticks("degraded_stride", [[], [(0, syncs([(a1, 104.0, 0.0, 101.0,
                                                  0.5)]))], [], [], []])
    got["stride_shed"] = [
        s.game.overload.shed_counter(s.game.overload.CLASS_SYNC,
                                     "stride").value - before
        for s, before in zip(sides, shed)]
    ticks("enter_space", [[(0, client_call(a1, c1, "Travel_Client",
                                           300.0, 300.0))], [], []])
    p = jpacket.new_packet(jproto.MT_NOTIFY_CLIENT_DISCONNECTED)
    p.append_entity_id(c2)
    p.append_var_str(a2)
    ticks("disconnect_destroy", [[(1, frame(p))], [
        (0, client_call(a1, c1, "Quit_Client"))], []])
    for s in sides:
        s.gs.request_freeze()
    acks = []
    for disp in (1, 2):
        q = jpacket.new_packet(jproto.MT_START_FREEZE_GAME_ACK)
        q.append_u16(disp)
        acks.append((disp - 1, frame(q)))
    for i, s in enumerate(sides):
        s.feed(acks)
        s.gs.pump()
        assert s.gs.run_state == "freezing"
        s.gs.freeze_dir = str(tmp_path / ("jax" if s.jax else "port"))
        (tmp_path / ("jax" if s.jax else "port")).mkdir()
        s.gs._do_freeze()
        assert s.gs.run_state == "frozen"
        got["freeze"][i].append(s.sent)
        s.sent = []
    return got


@pytest.fixture(scope="module")
def game(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        seeded_ids(mp)
        tmp = tmp_path_factory.mktemp("game")
        sides = [Side(jent), Side(tent)]
        got = run_script(sides, tmp)
        # each package's freeze file restores into the other's server
        restored = [Side(jent, restore_dir=str(tmp / "port")),
                    Side(tent, restore_dir=str(tmp / "jax"))]
        again = []
        c3, b3 = fixed("client3"), fixed("boot3")
        script = [[(0, frame(jproto.pack_notify_client_connected(
            b3, c3, 1)))], [(0, client_call(b3, c3, "Login_Client",
                                            "carol", 120.0, 120.0))],
                  [], []]
        for frames in script:
            again.append([s.step(frames) for s in restored])
        yield dict(got=got, sides=sides, restored=restored, again=again)
    finally:
        mp.undo()


@pytest.mark.parametrize("phase", PHASES)
def test_phase_packets_match_jax(game, phase):
    """Every outbound packet of each tick of the phase, byte for byte
    and on the same connection, as the JAX package's server sends."""
    jax_ticks, port_ticks = game["got"][phase]
    assert len(jax_ticks) == len(port_ticks)
    for t, (a, b) in enumerate(zip(jax_ticks, port_ticks)):
        assert b == a, (phase, t)
    sent = sum(len(a) for a in jax_ticks)
    if phase != "ready":
        assert sent > 0, f"phase {phase} sent nothing"


def test_the_script_reached_every_plane(game):
    """The script did what it says on both sides: the Avatars moved,
    one crossed to Space B, the ladder thinned the sync fan-out, the
    freeze wrote a file and stopped the server."""
    j, t = (s.world for s in game["sides"])
    for w in (j, t):
        assert w.sync_stride == 2
        names = {e.attrs.get("name") for e in w.entities.values()
                 if e.type_name == "Avatar"}
        assert names == {"bob"}
    sent = [mt for ticks in game["got"]["degraded_stride"][0]
            for _, raw in ticks
            for mt in [int.from_bytes(raw[:2], "little") & 0x3FFF]]
    assert jproto.MT_SYNC_POSITION_YAW_ON_CLIENTS in sent
    # the stride thinned the fan-out alike: records counted as shed
    jshed, tshed = game["got"]["stride_shed"]
    assert jshed == tshed > 0
    assert all(s.gs.run_state == "frozen" for s in game["sides"])


def test_restored_servers_match_each_other(game):
    """The port's freeze file in a JAX server and the JAX file in the
    port's: the same entities, attrs and positions, then the same
    packets as a third client connects and logs in."""
    jr, tr = game["restored"]
    ents = []
    for w in (jr.world, tr.world):
        ents.append({e.id: (e.type_name, e.attrs.to_dict(), e.position,
                            e.yaw) for e in w.entities.values()
                     if not e.destroyed})
    assert ents[0] == ents[1]
    assert sum(v[0] == "Monster" for v in ents[0].values()) == 40
    for t, (a, b) in enumerate(game["again"]):
        assert b == a, t
    assert any(game["again"][1])
