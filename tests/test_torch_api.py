"""The port's normal entry: ``import goworld_tpu_torch as gw; gw.run()``.

The lazy facade against the JAX package's (submodules first, then the
names of ``api``), the ini's config against the JAX package's, a game
booted from an ini by ``gw.run([...], block=False, device="cpu")``
against the port's own dispatchers and gate and played by a strict bot,
and every setting the port does not run refused with
``NotImplementedError`` naming ROADMAP.md (no card and no
``device="cpu"`` raises as the World does).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time

import pytest
import torch

import goworld_tpu as jgw
import goworld_tpu_torch as gw
from goworld_tpu import config as jconfig
from goworld_tpu_torch import api
from goworld_tpu_torch import config as tconfig
from goworld_tpu_torch.net.botclient import BotClient
from goworld_tpu_torch.net.standalone import ClusterHarness

WAIT = 120
EXAMPLE_INI = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "test_game", "goworld_tpu.ini")


def test_facade_resolves_submodules_then_api_names():
    """``gw.<submodule>`` is the submodule, ``gw.<name>`` the api's,
    and the api exports the JAX package's names."""
    assert gw.config is tconfig
    assert gw.storage.__name__ == "goworld_tpu_torch.storage"
    assert gw.run is api.run and gw.Entity is api.Entity
    assert gw.register_entity is api.register_entity
    assert sorted(api.__all__) == sorted(jgw.api.__all__)
    with pytest.raises(AttributeError):
        gw.no_such_name


def test_config_matches_jax():
    """The defaults and the example game's ini load to the JAX
    package's values, key for key."""
    for cls in ("GameConfig", "GateConfig", "DispatcherConfig",
                "StorageConfig", "KVDBConfig"):
        assert dataclasses.asdict(getattr(tconfig, cls)()) == \
            dataclasses.asdict(getattr(jconfig, cls)()), cls
    assert tconfig.GameConfig().aoi_sweep_impl == "ranges"
    assert tconfig.GameConfig().aoi_sort_impl == "argsort"
    t, j = tconfig.load(EXAMPLE_INI), jconfig.load(EXAMPLE_INI)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dispatcher_addrs() == j.dispatcher_addrs()


class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"

    def Login_Client(self, name):
        avatar = self.world.create_entity(
            "Avatar", space=self.world.arena, pos=(50.0, 0.0, 50.0))
        avatar.attrs["name"] = name
        self.give_client_to(avatar)
        self.destroy()


class Avatar(gw.Entity):
    ATTRS = {"name": "allclients"}


class Arena(gw.Space):
    pass


def _ini(path, harness, **game) -> str:
    lines = []
    for i, (h, p) in enumerate(harness.dispatcher_addrs if harness
                               else [("127.0.0.1", 1)]):
        lines += [f"[dispatcher{i + 1}]", f"host = {h}", f"port = {p}"]
    lines += ["[game_common]", "boot_entity = Account", "capacity = 256",
              "aoi_radius = 50.0", "extent_x = 200.0", "extent_z = 200.0",
              "aoi_sweep_impl = fused", "aoi_sort_impl = pallas",
              "aoi_cell_cap = 12", "aoi_k = 32"]
    lines += [f"{k} = {v}" for k, v in game.items()]
    lines += ["[game1]", "[storage]", "kind = filesystem",
              f"directory = {path}/entity_storage", "[kvdb]",
              "kind = filesystem", f"path = {path}/kvdb_data"]
    ini = os.path.join(path, "goworld_tpu.ini")
    with open(ini, "w") as f:
        f.write("\n".join(lines) + "\n")
    return ini


@pytest.fixture()
def fresh_api():
    api._reset_for_tests()
    api._boot_callbacks.clear()
    yield
    api._reset_for_tests()
    api._boot_callbacks.clear()


async def _login(bot: BotClient) -> None:
    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        bot.call_server("Login_Client", "ann")
        for _ in range(WAIT * 20):
            if bot.player is not None and bot.player.type_name == "Avatar" \
                    and bot.player.attrs.get("name") == "ann":
                break
            await asyncio.sleep(0.05)
    finally:
        recv.cancel()
        await bot.conn.close()


def test_run_from_ini_on_the_cpu(tmp_path, fresh_api):
    """``gw.run(["-gid", "1", "-configfile", ini], block=False,
    device="cpu")``: the World of the ini (its kernels' plain versions on
    the CPU), storage and kvdb opened, both dispatchers acked; a strict
    bot logs in through the gate and gets its Avatar."""
    harness = ClusterHarness(n_dispatchers=2, n_gates=1, desired_games=1,
                             position_sync_interval_ms=20)
    harness.start(timeout=WAIT)
    rt = None
    try:
        ini = _ini(str(tmp_path), harness)
        gw.register_entity("Account", Account)
        gw.register_entity("Avatar", Avatar)
        gw.register_space("Arena", Arena)
        gw.on_boot(lambda w: setattr(w, "arena", w.create_space("Arena")))
        rt = gw.run(["-gid", "1", "-configfile", ini], block=False,
                    device="cpu")
        w, gs = rt.world, rt.server
        assert gw.world() is w and gw.game_server() is gs
        assert w.device == torch.device("cpu")
        assert (w.cfg.capacity, w.cfg.grid.sweep_impl,
                w.cfg.grid.sort_impl) == (256, "fused", "pallas")
        assert gs.handshake_acks == {1, 2}
        assert w.storage is rt.storage
        bot = BotClient(*harness.gate_addrs[0], strict=True)
        fut = harness.submit(_login(bot))
        t_end = time.monotonic() + WAIT
        while not fut.done() and time.monotonic() < t_end:
            gs.pump()
            gs.tick()
            time.sleep(0.01)
        fut.result(timeout=1)
        assert not bot.errors, bot.errors
        assert bot.player.type_name == "Avatar"
        assert [e.attrs["name"] for e in w.entities.values()
                if e.type_name == "Avatar"] == ["ann"]
    finally:
        if rt is not None:
            rt.server.stop()
            rt.storage.shutdown()
            rt.workers.wait_clear()
        harness.stop()


@pytest.mark.parametrize("game,env,argv", [
    (dict(megaspace="true", mesh_devices=4), {}, []),
    (dict(mesh_devices=2), {}, []),
    (dict(http_port=18080), {}, []),
    (dict(small_tier_rows=512), {}, []),
    (dict(standby_of=2), {}, []),
    ({}, {"GOWORLD_MH_PROCS": "2"}, []),
    ({}, {}, ["-d"]),
], ids=["megaspace", "mesh", "http_port", "small_tier", "standby",
        "multihost_env", "daemon"])
def test_run_refuses_unported_settings(tmp_path, fresh_api, monkeypatch,
                                       game, env, argv):
    """Each setting the port does not run raises ``NotImplementedError``
    naming ROADMAP.md before anything is built."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ini = _ini(str(tmp_path), None, **game)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gw.run(["-gid", "1", "-configfile", ini, *argv], block=False,
               device="cpu")


def test_run_refuses_rebalance_deployment(tmp_path, fresh_api):
    ini = _ini(str(tmp_path), None)
    with open(ini, "a") as f:
        f.write("[deployment]\nrebalance = true\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gw.run(["-gid", "1", "-configfile", ini], block=False,
               device="cpu")


def test_run_without_a_card_raises(tmp_path, fresh_api):
    """No card and no ``device="cpu"``: the World raises, nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ini = _ini(str(tmp_path), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gw.run(["-gid", "1", "-configfile", ini], block=False)


def test_unported_edges_raise():
    """The client edges and server planes not ported yet refuse."""
    from goworld_tpu_torch.net import gate, proto
    from goworld_tpu_torch.net.game import GameServer
    from goworld_tpu_torch.net.packet import Packet, new_packet

    for kw in (dict(kcp_port=-1), dict(ws_port=1),
               dict(compress=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gate.GateService(1, "127.0.0.1", 0, [], **kw)
    for kw in (dict(with_ws=True), dict(with_kcp=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ClusterHarness(**kw)
    for kw in (dict(kcp=True), dict(ws=True), dict(compress=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            BotClient("127.0.0.1", 1, **kw)
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity import World
    from goworld_tpu_torch.ops.aoi import GridSpec

    w = World(WorldConfig(capacity=64, grid=GridSpec(
        radius=20.0, extent_x=100.0, extent_z=100.0)), device="cpu",
        telemetry_live=False, residency=False, audit=False)
    for kw in (dict(standby_of=2), dict(rebalance_enabled=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GameServer(1, w, [], **kw)
    w.snapshot_keyframe_every = 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GameServer(1, w, [], checkpoint_interval=5.0)
    w.snapshot_keyframe_every = 0
    gs = GameServer(1, w, [])
    p = new_packet(proto.MT_REPLICATION_SUBSCRIBE)
    p.append_u16(1)
    p.append_u16(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gs._handle_packet(0, proto.MT_REPLICATION_SUBSCRIBE,
                          Packet(bytes(p.buf[2:])))
    assert (w.sync_stride, w._multihost) == (1, False)


def test_governor_and_flight_recorder_drive_through_the_server():
    """``[gameN] governor = true``: the port's ``GameServer`` hands each
    rotated signature window of its World to the port's
    ``KernelGovernor`` between ticks, and records a flight-recorder
    frame a tick."""
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity import Entity, Space, World
    from goworld_tpu_torch.net.game import GameServer
    from goworld_tpu_torch.ops.aoi import GridSpec

    w = World(WorldConfig(capacity=256, grid=GridSpec(
        radius=50.0, extent_x=200.0, extent_z=200.0, k=32, cell_cap=12)),
        device="cpu")
    w.register_space("Arena", Space)
    w.register_entity("Mob", Entity)
    w.create_nil_space()
    arena = w.create_space("Arena")
    for i in range(40):
        arena.create_entity("Mob", pos=(float(i * 4), 0.0, float(i * 3)),
                            moving=True)
    gs = GameServer(1, w, [], governor_enabled=True,
                    governor_window_ticks=8, flightrec_ring=64)
    assert type(gs.governor).__name__ == "KernelGovernor"
    for _ in range(40):
        gs.pump()
        gs.tick()
    assert gs._gov_last_win == w._telem_win_tick > 0
    assert gs.governor.snapshot()["signature"] is not None
    assert gs.flightrec.snapshot()["frames_recorded"] == 40
