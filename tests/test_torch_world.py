"""The port's serving World against the JAX package's, on the CPU.

One scripted game runs on the JAX ``World(..., telemetry_live=False,
residency=False, audit=False)`` and on the port's ``World(...,
device="cpu")`` at capacity 256, one Space, under both sweep/sort pairs
(``ranges``/``argsort`` and ``fused``/``pallas``: the port takes the
kernels' plain versions on the CPU, the JAX side runs its Pallas kernels
in interpret mode). Entities carry explicit ids; the service shard and
the nil space are named alike on both sides.

After every tick the two sides must agree on: the client messages, the
sync-sink batches (gate, client ids, entity ids, values), the order of
the OnEnterAOI / OnLeaveAOI / OnEntityEnterSpace hooks and of timer and
RPC calls (under a fake clock), every entity's slot, position, yaw,
attrs and interest sets, the fetched outputs and the whole state
(``interop.state_to_numpy``). All of it bit for bit, the random-walk
movers of the last case included: the port computes XLA's cos and sin
and rounds ``pos + vel*dt`` once, as XLA's fused multiply-add does.
Two more games run the same script on a World with a Verlet skin of 4
(the bench's), one of them at precision="q16" (snapped positions, a
bfloat16 velocity plane, a packed candidate cache), held to the same.
Those games turn the planes off on both sides; two more (skin 0 and
skin 4) run both Worlds at their defaults — live telemetry, residency
and audit on, sampled every 2 ticks, the signature window rotating
every 8 — and hold them, after every tick, also to the same drained
telemetry lanes, workload and window signatures, audit oracle and probe
stats, entity ledger and sync-age anchor tick.

The game runs once per sweep/sort pair (a module fixture; each JAX
World compiles its tick once) and records, per case, what differed and
what the case did; each case is one test.

A second script runs one World of several AOI Spaces (``n_spaces`` 2
and 4; the batched step on the port, the vmapped step on JAX), with
migrations between Spaces through ``enter_space``: a plain crossing, one
cancelled and one destroyed inside the migration window, one on the same
tick as client syncs, one whose hot attr is written inside the window;
at skin 0 under both pairs, with a skin of 4 (cleared by both Worlds'
batched steps) and at the defaults. It is held to the same agreement.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from goworld_tpu import entity as jent
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.entity.service import ServiceManager as JServices
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import interop
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.entity.service import ServiceManager as TServices
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

CAP = 256
EXTENT = 600.0
GRID = dict(radius=50.0, extent_x=EXTENT, extent_z=EXTENT, k=32,
            cell_cap=12, row_block=CAP, topk_impl="sort", skin=0.0,
            precision="off")
WORLD = dict(capacity=CAP, npc_speed=5.0, enter_cap=256, leave_cap=256,
             sync_cap=1024, attr_sync_cap=64, input_cap=64,
             delta_rows_cap=CAP)
IMPLS = [("ranges", "argsort"), ("fused", "pallas")]
# the games: each sweep/sort pair at skin 0, and the kernels' pair with
# the bench's Verlet skin, in float32 and at q16, the planes off; then
# the kernels' pair at skin 0 and 4 with both Worlds at their defaults
GAMES = [(*impl, 0.0, "off", False) for impl in IMPLS] + [
    ("fused", "pallas", 4.0, "off", False),
    ("fused", "pallas", 4.0, "q16", False),
    ("fused", "pallas", 0.0, "off", True),
    ("fused", "pallas", 4.0, "off", True)]
# the sampling of the games at the Worlds' defaults
PLANES = dict(audit_sample_every=2, residency_sample_every=2)
SIG_WINDOW = 8
CASES = ["spawn", "client_bind_unbind", "pos_sync_batch", "teleport",
         "hot_attr_twice", "destroy_slot_reuse", "service_call",
         "migration_round_trip", "enter_overflow", "set_moving"]


def eid(name: str) -> str:
    return ids.gen_fixed_id(f"test_torch_world.{name}")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def game_types(pkg, log: list) -> dict:
    """The script's entity types on ``pkg``'s base classes; every hook
    appends to ``log``."""

    class Mob(pkg.Entity):
        ATTRS = {"hp": "allclients hot:0", "name": "allclients",
                 "bag": "client", "gold": "persistent"}

        def OnEnterAOI(self, other):
            log.append(("enter", self.id, other.id))

        def OnLeaveAOI(self, other):
            log.append(("leave", self.id, other.id))

        def OnMigrateOut(self):
            log.append(("migrate_out", self.id))

        def OnMigrateIn(self):
            log.append(("migrate_in", self.id))

        def OnEnterSpace(self):
            log.append(("entered_space", self.id))

        def OnLeaveSpace(self, space):
            log.append(("left_space", self.id, space.id))

        def Fire(self, x):
            log.append(("timer", self.id, x))

        def Ping_Client(self, x):
            log.append(("ping", self.id, x))

    class Player(Mob):
        pass

    class Arena(pkg.Space):
        def OnEntityEnterSpace(self, e):
            log.append(("space_enter", self.id, e.id))

        def OnEntityLeaveSpace(self, e):
            log.append(("space_leave", self.id, e.id))

    class Shop(pkg.Entity):
        def Buy(self, who, n):
            log.append(("buy", who, n))

    return dict(Mob=Mob, Player=Player, Arena=Arena, Shop=Shop)


class Side:
    """One package's game: two Worlds (A hosts the script, B receives
    the migrant), their hook log, sink batches and fake clock."""

    def __init__(self, pkg, impl):
        self.pkg = pkg
        self.log: list = []
        self.sync: list = []
        self.clock = Clock()
        sweep, sort, skin, precision, self.defaults = impl
        grid = dict(GRID, sweep_impl=sweep, sort_impl=sort, skin=skin,
                    precision=precision)
        make = dict(PLANES) if self.defaults else dict(
            telemetry_live=False, residency=False, audit=False)
        if pkg is jent:
            cfg = JConfig(grid=JGrid(**grid), **WORLD)
            services = JServices
        else:
            cfg = TConfig(grid=TGrid(**grid), **WORLD)
            make["device"] = "cpu"
            services = TServices
        types = game_types(pkg, self.log)
        self.worlds = []
        for game_id in (1, 2):
            w = pkg.World(cfg, game_id=game_id, clock=self.clock, seed=3,
                          **make)
            w.SIG_WINDOW_TICKS = SIG_WINDOW
            for name in ("Mob", "Player"):
                w.register_entity(name, types[name])
            w.register_space("Arena", types["Arena"])
            w.create_nil_space()
            w.arena = w.create_space("Arena", eid=eid(f"arena{game_id}"))
            w.sync_sink = (lambda gate, cids, eids, vals, w=w:
                           self.sync.append((w.game_id, gate, cids.copy(),
                                             eids.copy(), vals.copy())))
            self.worlds.append(w)
        self.a, self.b = self.worlds
        svc = services(self.a, game_id=1)
        svc.register("Shop", types["Shop"])
        svc.start()

    def tick(self):
        self.clock.t += 1.0 / 60.0
        for w in self.worlds:
            w.tick()

    def take(self) -> dict:
        """What the tick produced, drained from the sinks."""
        got = dict(log=list(self.log), sync=list(self.sync),
                   msgs=[list(w.client_messages) for w in self.worlds])
        self.log.clear()
        self.sync.clear()
        for w in self.worlds:
            w.client_messages.clear()
        return got


def _jax_state(w) -> dict:
    out = {}
    for f in dataclasses.fields(w.state):
        v = getattr(w.state, f.name)
        if dataclasses.is_dataclass(v):  # the Verlet cache
            out[f.name] = {c.name: np.asarray(getattr(v, c.name))
                           for c in dataclasses.fields(v)}
        elif v is not None:
            out[f.name] = np.asarray(v)
    return out


def _same(a, b) -> bool:
    """Equality of nested plain values, floats bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype.kind == "f":
            return a.tobytes() == b.tobytes()
        return bool(np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _ledger(w) -> dict:
    """The audit ledger's snapshot, less what names the service shard
    (its id is drawn at random on each side): the all-entity CRC, the
    Shop type's CRC and the Shop's id."""
    led = w.audit.ledger
    snap = led.snapshot(tick=w.tick_count, eids=True)
    del snap["crc"]
    snap["census"].get("Shop", {}).pop("crc", None)
    snap["eids"] = [e for e in snap["eids"] if led._eids[e] != "Shop"]
    return snap


def diff_planes(jw, tw) -> list[str]:
    """Where the planes of two Worlds at their defaults differ."""
    g = jw.game_id
    for w in (jw, tw):
        w.audit.drain()
    pairs = {
        "telemetry lanes": (jw._telem_lanes, tw._telem_lanes),
        "workload_signature": (jw.workload_signature(),
                               tw.workload_signature()),
        "window_signature": (jw.window_signature(), tw.window_signature()),
        "audit oracle": (jw.audit.oracle_stats, tw.audit.oracle_stats),
        "audit probes": (jw.audit.probe_stats, tw.audit.probe_stats),
        "audit ledger": (_ledger(jw), _ledger(tw)),
        "sync-age anchor tick": (jw.sync_age_anchor[0],
                                 tw.sync_age_anchor[0]),
    }
    return [f"world {g}: {k} {a} != {b}" for k, (a, b) in pairs.items()
            if not _same(a, b)]


def diff_worlds(j: Side, t: Side, jgot: dict, tgot: dict) -> list[str]:
    """Every place the tick's results of the two sides differ."""
    bad = []
    if jgot["log"] != tgot["log"]:
        bad.append(f"hook log {jgot['log']} != {tgot['log']}")
    if not _same(jgot["msgs"], tgot["msgs"]):
        bad.append("client messages")
    if not _same(jgot["sync"], tgot["sync"]):
        bad.append("sync batches")
    for jw, tw in zip(j.worlds, t.worlds):
        g = jw.game_id
        # the service shard's id is drawn at random on each side
        jids = {k for k, e in jw.entities.items() if e.type_name != "Shop"}
        tids = {k for k, e in tw.entities.items() if e.type_name != "Shop"}
        if jids != tids or len(jw.entities) != len(tw.entities):
            bad.append(f"world {g}: entity ids")
            continue
        for k in sorted(jids):
            je, te = jw.entities[k], tw.entities[k]
            row = (je.shard, je.slot, je.position, je.yaw,
                   je.attrs.to_dict(),
                   sorted(je.interested_in), sorted(je.interested_by),
                   je.client is None or (je.client.gate_id,
                                         je.client.client_id))
            trow = (te.shard, te.slot, te.position, te.yaw,
                    te.attrs.to_dict(),
                    sorted(te.interested_in), sorted(te.interested_by),
                    te.client is None or (te.client.gate_id,
                                          te.client.client_id))
            if not _same(row, trow):
                bad.append(f"world {g}: entity {k} {row} != {trow}")
        jst, tst = _jax_state(jw), interop.state_to_numpy(tw.state)
        for name, a in tst.items():
            if not _same(jst[name], a):
                bad.append(f"world {g}: state lane {name}")
        jo = jw.last_outputs
        for f in dataclasses.fields(tw.last_outputs):
            a = getattr(tw.last_outputs, f.name)
            if not _same(np.asarray(getattr(jo, f.name)), a):
                bad.append(f"world {g}: output lane {f.name}")
        if t.defaults:
            bad += diff_planes(jw, tw)
    return bad


def run_game(impl) -> dict:
    """The script on both packages; per case, the differences of each of
    its ticks and the facts the case's test checks."""
    sides = {"jax": Side(jent, impl), "port": Side(tent, impl)}
    j, t = sides["jax"], sides["port"]
    rng = np.random.default_rng(7)
    results = {}

    def both(fn):
        return {k: fn(s) for k, s in sides.items()}

    def ticks(case, n=1):
        rec = results.setdefault(case, {"diffs": [], "facts": {}})
        for i in range(n):
            for s in sides.values():
                s.tick()
            jgot, tgot = j.take(), t.take()
            rec["diffs"] += [f"{case} tick {i}: {d}" for d in diff_worlds(
                j, t, jgot, tgot)]
            rec.setdefault("got", []).append(tgot)
            out = t.a.last_outputs
            rec.setdefault("events", []).append(
                (int(out.enter_n[0]), int(out.leave_n[0])))
        return rec

    # spawn: 60 mobs, 3 players with clients, timers of both kinds
    mob_pos = rng.uniform(0, EXTENT, (60, 2))

    def spawn(s):
        a = s.a
        for i, (x, z) in enumerate(mob_pos):
            a.arena.create_entity("Mob", pos=(x, 0.0, z), eid=eid(f"m{i}"),
                                  attrs={"hp": 10 + i, "name": f"m{i}"})
        for i in range(3):
            p = a.arena.create_entity(
                "Player", pos=(100.0 + 40 * i, 0.0, 100.0),
                eid=eid(f"p{i}"),
                client=s.pkg.GameClient(1, f"c{i}".ljust(16, "x"), a))
            p.add_timer(0.05, "Fire", i)
            p.add_callback(0.1, "Fire", 10 + i)
        return sorted(e.slot for e in a.entities.values()
                      if e.slot is not None)

    slots = both(spawn)
    rec = ticks("spawn", 8)
    rec["facts"] = dict(slots=slots["port"], same_slots=slots["jax"]
                        == slots["port"],
                        enters=sum(e for e, _ in rec["events"]))

    # client bind and unbind
    def bind(s):
        s.a.entities[eid("m0")].set_client(s.pkg.GameClient(
            2, "bind".ljust(16, "x"), s.a))
        s.a.entities[eid("p2")].set_client(None)

    both(bind)
    rec = ticks("client_bind_unbind", 2)
    rec["facts"] = dict(msg_types=sorted({m[2]["type"] for got in rec["got"]
                                          for m in got["msgs"][0]}))

    # the batched upstream client syncs (a duplicate: the last wins; an
    # unknown id and a client-less mob are dropped)
    batch_eids = [eid("p0"), eid("m0"), eid("p1"), eid("p0"), eid("nope"),
                  eid("m5")]
    batch_vals = np.array([[10, 0, 10, 1], [20, 1, 20, 2], [30, 0, 30, 3],
                           [40, 0, 40, 4], [0, 0, 0, 0], [50, 0, 50, 5]],
                          np.float32)
    staged = both(lambda s: s.a.stage_pos_sync_batch(
        np.array(batch_eids, "S16"), batch_vals))
    rec = ticks("pos_sync_batch", 2)
    rec["facts"] = dict(staged=staged, p0=t.a.entities[eid("p0")].position)

    # teleport (leaves), a yaw alone (the device keeps the position) and
    # a position alone (the device keeps the yaw)
    def teleport(s):
        s.a.entities[eid("m3")].set_position((590.0, 0.0, 590.0))
        s.a.entities[eid("m4")].set_yaw(2.5)
        s.a.entities[eid("m6")].set_yaw(1.25)

    both(teleport)
    rec = ticks("teleport", 1)
    both(lambda s: s.a.entities[eid("m6")].set_position((300.0, 0.0, 300.0)))
    ticks("teleport", 1)
    rec["facts"] = dict(
        leaves=sum(1 for got in rec["got"] for x in got["log"]
                   if x[0] == "leave"),
        m4=(t.a.entities[eid("m4")].position, t.a.entities[eid("m4")].yaw),
        m6_yaw=t.a.entities[eid("m6")].yaw)

    # one hot attr set twice in one tick, nested paths and list ops
    def attrs(s):
        m = s.a.entities[eid("m1")]
        m.attrs["hp"] = 5
        m.attrs["hp"] = 7
        s.a.entities[eid("m2")].attrs["hp"] = 3.5
        p = s.a.entities[eid("p0")]
        p.attrs["bag"] = {"items": [1, 2]}
        p.attrs.get_map("bag").get_list("items").append(3)
        p.attrs["hp"] = 1
        p.attrs["hp"] = 2

    both(attrs)
    rec = ticks("hot_attr_twice", 2)
    rec["facts"] = dict(
        hot=interop.state_to_numpy(t.a.state)["hot_attrs"][
            0, t.a.entities[eid("m1")].slot, 0],
        jhot=float(np.asarray(j.a.state.hot_attrs)[
            0, j.a.entities[eid("m1")].slot, 0]))

    # destroy, then creations until the freed slot is taken again
    def destroy(s):
        e = s.a.entities[eid("m7")]
        slot = e.slot
        e.destroy()
        return slot

    freed = both(destroy)
    rec = ticks("destroy_slot_reuse", 1)

    def refill(s):
        n = 0
        while freed["port"] in s.a._free[0]:
            s.a.arena.create_entity("Mob", pos=(float(5 * n % 590), 0.0,
                                                 float(n % 7) * 80.0),
                                    eid=eid(f"fill{n}"))
            n += 1
        return n, s.a.entities[eid(f"fill{n - 1}")].slot

    refilled = both(refill)
    ticks("destroy_slot_reuse", 2)

    def unfill(s):
        for i in range(refilled["port"][0] - 1):
            s.a.entities[eid(f"fill{i}")].destroy()

    both(unfill)
    ticks("destroy_slot_reuse", 1)
    rec["facts"] = dict(freed=freed, refilled=refilled)

    # a local service call and an entity RPC from its own client
    def calls(s):
        s.a.call_service("Shop", "Buy", "p1", 3)
        s.a.call(eid("p1"), "Ping_Client", 9,
                 from_client="c1".ljust(16, "x"))

    both(calls)
    rec = ticks("service_call", 2)
    rec["facts"] = dict(log=[x for got in rec["got"] for x in got["log"]
                             if x[0] in ("buy", "ping")])

    # a migration round trip A -> B -> A
    def out_a(s):
        e = s.a.entities[eid("p1")]
        data = s.a.get_migrate_data(e)
        s.a.remove_for_migration(e)
        s.b.restore_from_migration(data, space=s.b.arena)
        return data

    data_ab = both(out_a)
    rec = ticks("migration_round_trip", 2)

    def back(s):
        e = s.b.entities[eid("p1")]
        data = s.b.get_migrate_data(e)
        s.b.remove_for_migration(e)
        s.a.restore_from_migration(data, space=s.a.arena)
        return data

    data_ba = both(back)
    ticks("migration_round_trip", 2)
    rec["facts"] = dict(data_ab=data_ab, data_ba=data_ba,
                        in_a=eid("p1") in t.a.entities,
                        in_b=eid("p1") in t.b.entities)

    # AOI overflow past enter_cap: a cluster of 30 in one spot
    def cluster(s):
        for i in range(30):
            s.a.arena.create_entity(
                "Mob", pos=(450.0 + i * 0.5, 0.0, 150.0 + (i % 3)),
                eid=eid(f"c{i}"))

    both(cluster)
    rec = ticks("enter_overflow", 2)
    rec["facts"] = dict(enter_n=rec["events"][0][0])

    # random-walk movers, still bit for bit
    def moving(s):
        for i in (8, 9, 10, 11, 12):
            s.a.entities[eid(f"m{i}")].set_moving(True)
        s.a.entities[eid("m12")].set_moving(False)

    both(moving)
    rec = ticks("set_moving", 4)
    if t.defaults:
        planes = {}
        for w in t.worlds:
            w.audit.drain()
            planes[w.game_id] = dict(
                ticks=w.tick_count, lanes=w._telem_lanes,
                window=w.window_signature(), oracle=w.audit.oracle_stats,
                ledger=_ledger(w),
                census=w.residency.census_snapshot())
        results["planes"] = planes
    rec["facts"] = dict(moved=t.a.entities[eid("m8")].position,
                        still=t.a.entities[eid("m12")].position,
                        m12_start=tuple(float(v) for v in (
                            mob_pos[12][0], 0.0, mob_pos[12][1])))
    return results


@pytest.fixture(scope="module", params=GAMES,
                ids=["ranges", "fused", "fused-skin4", "fused-skin4-q16",
                     "fused-defaults", "fused-skin4-defaults"])
def game(request):
    return run_game(request.param)


@pytest.mark.parametrize("case", CASES)
def test_scripted_game_matches_jax(game, case):
    rec = game[case]
    assert rec["diffs"] == [], rec["diffs"][:5]
    facts = rec["facts"]
    if case == "spawn":
        assert facts["same_slots"] and len(facts["slots"]) == 63
        assert facts["enters"] > 0
        timers = [x for got in rec["got"] for x in got["log"]
                  if x[0] == "timer"]
        fired = [x[2] for x in timers]
        assert sorted(fired.count(i) for i in (10, 11, 12)) == [1, 1, 1]
        assert fired.count(0) == fired.count(2) >= 2
    elif case == "client_bind_unbind":
        assert {"create_entity", "destroy_entity"} <= set(
            facts["msg_types"])
    elif case == "pos_sync_batch":
        assert facts["staged"] == {"jax": 3, "port": 3}
        assert facts["p0"] == (40.0, 0.0, 40.0)
    elif case == "teleport":
        assert facts["leaves"] > 0
        assert facts["m4"][1] == 2.5 and facts["m6_yaw"] == 1.25
    elif case == "hot_attr_twice":
        assert facts["hot"] == facts["jhot"] == 7.0
    elif case == "destroy_slot_reuse":
        assert facts["freed"]["jax"] == facts["freed"]["port"]
        assert facts["refilled"]["port"] == (
            facts["refilled"]["jax"][0], facts["freed"]["port"])
    elif case == "service_call":
        assert facts["log"] == [("buy", "p1", 3), ("ping", eid("p1"), 9)]
    elif case == "migration_round_trip":
        for k in ("data_ab", "data_ba"):
            assert facts[k]["jax"] == facts[k]["port"]
            assert facts[k]["port"]["client"] == [1, "c1".ljust(16, "x")]
        assert facts["in_a"] and not facts["in_b"]
    elif case == "enter_overflow":
        assert facts["enter_n"] > WORLD["enter_cap"]
    elif case == "set_moving":
        assert facts["moved"] != facts["still"]
        assert facts["still"] == pytest.approx(facts["m12_start"])
        for p in game.get("planes", {}).values():
            # every tick in the lanes, every sample judged or skipped
            # with its reason, the carry resident, the window rotated
            assert sum(p["lanes"]["rebuilt"]["counts"]) == p["ticks"]
            assert sum(p["lanes"]["occupancy"]["counts"]) == p["ticks"]
            o = p["oracle"]
            assert o["samples"] + sum(o["skipped"].values()) == \
                -(-p["ticks"] // PLANES["audit_sample_every"])
            assert o["samples"] > 0
            assert p["census"]["samples"] > 0
            assert p["census"]["realloc"] == []
            assert p["window"]["window_ticks"] == SIG_WINDOW


class MultiSide(Side):
    """One package's several-Space game: one World hosting an Arena a
    Space, its hook log, sink batches and fake clock."""

    def __init__(self, pkg, game):
        self.pkg = pkg
        self.log: list = []
        self.sync: list = []
        self.clock = Clock()
        n_spaces, sweep, sort, skin, self.defaults, *beh = game
        grid = dict(GRID, sweep_impl=sweep, sort_impl=sort, skin=skin)
        make = dict(PLANES) if self.defaults else dict(
            telemetry_live=False, residency=False, audit=False)
        world = dict(WORLD, behavior=beh[0]) if beh else WORLD
        if pkg is jent:
            cfg = JConfig(grid=JGrid(**grid), **world)
        else:
            cfg = TConfig(grid=TGrid(**grid), **world)
            make["device"] = "cpu"
        types = game_types(pkg, self.log)
        w = pkg.World(cfg, n_spaces, game_id=1, clock=self.clock, seed=3,
                      **make)
        w.SIG_WINDOW_TICKS = SIG_WINDOW
        for name in ("Mob", "Player"):
            w.register_entity(name, types[name])
        w.register_space("Arena", types["Arena"])
        w.create_nil_space()
        self.arenas = [w.create_space("Arena", eid=eid(f"multi.arena{d}"))
                       for d in range(n_spaces)]
        w.sync_sink = (lambda gate, cids, eids, vals:
                       self.sync.append((gate, cids.copy(), eids.copy(),
                                         vals.copy())))
        self.worlds = [w]
        self.a = w


def run_multi_game(game) -> dict:
    """The several-Space script on both packages; per case, the
    differences of each of its ticks and the facts its test checks."""
    sides = {"jax": MultiSide(jent, game), "port": MultiSide(tent, game)}
    j, t = sides["jax"], sides["port"]
    n_spaces = game[0]
    rng = np.random.default_rng(11)
    results = {}

    def both(fn):
        return {k: fn(s) for k, s in sides.items()}

    def ticks(case, n=1):
        rec = results.setdefault(case, {"diffs": [], "facts": {}})
        for i in range(n):
            for s in sides.values():
                s.tick()
            jgot, tgot = j.take(), t.take()
            rec["diffs"] += [f"{case} tick {i}: {d}" for d in diff_worlds(
                j, t, jgot, tgot)]
            rec.setdefault("got", []).append(tgot)
            out = t.a.last_outputs
            rec.setdefault("events", []).append(
                (out.enter_n.tolist(), out.leave_n.tolist()))
        return rec

    def hooks(rec, who):
        return [x for got in rec["got"] for x in got["log"]
                if x[1] == eid(who) or (len(x) > 2 and x[2] == eid(who))]

    mob_pos = rng.uniform(0, EXTENT, (n_spaces, 24, 2))

    def spawn(s):
        w = s.a
        for d, arena in enumerate(s.arenas):
            for i, (x, z) in enumerate(mob_pos[d]):
                arena.create_entity("Mob", pos=(x, 0.0, z),
                                    eid=eid(f"s{d}m{i}"), moving=i % 6 < 2,
                                    attrs={"hp": 10 + i, "name": f"m{i}"})
            for i in range(2):
                arena.create_entity(
                    "Player", pos=(100.0 + 30 * i, 0.0, 100.0 + 20 * d),
                    eid=eid(f"s{d}p{i}"),
                    client=s.pkg.GameClient(1, f"c{d}{i}".ljust(16, "x"),
                                            w))

    both(spawn)
    rec = ticks("spawn", 3)
    rec["facts"] = dict(shards=sorted({e.shard for e in t.a.entities.values()
                                       if e.slot is not None}),
                        enters=rec["events"][0][0])

    last = n_spaces - 1

    def enter(s):
        w = s.a
        # a mob lands beside the players of Space 1
        w.entities[eid("s0m1")].enter_space(s.arenas[1].id,
                                            (110.0, 0.0, 125.0))
        # a player walks next to the other player of the last Space
        w.entities[eid("s0p0")].enter_space(s.arenas[last].id,
                                            (125.0, 0.0, 100.0 + 20 * last))
        return w.entities[eid("s0m1")].slot

    mid_window = both(enter)
    rec = ticks("enter_space", 3)
    rec["facts"] = dict(
        mid_window=mid_window,
        m1=(t.a.entities[eid("s0m1")].shard, t.a.entities[eid("s0m1")].space
            is t.arenas[1]),
        p0=t.a.entities[eid("s0p0")].shard,
        hooks_m1=hooks(rec, "s0m1"),
        hooks_p0=hooks(rec, "s0p0"),
        msgs=[m[2]["type"] for got in rec["got"] for m in got["msgs"][0]])

    def cancel(s):
        w = s.a
        e = w.entities[eid("s0m2")]
        e.enter_space(s.arenas[1].id, (50.0, 0.0, 50.0))
        e.enter_space(w.nil_space.id, (1.0, 0.0, 1.0))

    both(cancel)
    rec = ticks("cancel_in_window", 2)
    rec["facts"] = dict(
        slot=t.a.entities[eid("s0m2")].slot,
        space=t.a.entities[eid("s0m2")].space is t.a.nil_space,
        hooks=hooks(rec, "s0m2"))

    def destroy(s):
        w = s.a
        e = w.entities[eid("s1m3")]
        e.enter_space(s.arenas[0].id, (60.0, 0.0, 60.0))
        e.destroy()

    both(destroy)
    rec = ticks("destroy_in_window", 2)
    rec["facts"] = dict(gone=eid("s1m3") not in t.a.entities,
                        staged=len(t.a._staged_migrate))

    def with_sync(s):
        w = s.a
        w.entities[eid("s1p0")].enter_space(s.arenas[0].id,
                                            (140.0, 0.0, 110.0))
        return w.stage_pos_sync_batch(
            np.array([eid("s1p1"), eid("s0p1"), eid("s0p0")], "S16"),
            np.array([[150, 0, 150, 1], [160, 0, 160, 2],
                      [170, 0, 170, 3]], np.float32))

    staged = both(with_sync)
    rec = ticks("migrate_with_sync", 2)
    rec["facts"] = dict(staged=staged,
                        p1=t.a.entities[eid("s1p1")].position,
                        p0=t.a.entities[eid("s1p0")].shard,
                        syncs=sum(len(x[1]) for got in rec["got"]
                                  for x in got["sync"]))

    def attr(s):
        w = s.a
        e = w.entities[eid(f"s{last}m4")]
        e.enter_space(s.arenas[0].id, (80.0, 0.0, 80.0))
        e.attrs["hp"] = 77

    both(attr)
    rec = ticks("attr_in_window", 2)
    m4 = t.a.entities[eid(f"s{last}m4")]
    rec["facts"] = dict(
        hot=float(interop.state_to_numpy(t.a.state)["hot_attrs"][
            m4.shard, m4.slot, 0]),
        shard=m4.shard)
    return results


MULTI_GAMES = [(2, "ranges", "argsort", 0.0, False),
               (2, "fused", "pallas", 0.0, False),
               (4, "fused", "pallas", 0.0, False),
               (2, "fused", "pallas", 4.0, False),
               (2, "fused", "pallas", 0.0, True),
               (3, "fused", "pallas", 0.0, False, "btree"),
               (3, "fused", "pallas", 0.0, False, "mlp")]
MULTI_CASES = ["spawn", "enter_space", "cancel_in_window",
               "destroy_in_window", "migrate_with_sync", "attr_in_window"]


@pytest.fixture(scope="module", params=MULTI_GAMES,
                ids=["s2-ranges", "s2-fused", "s4-fused", "s2-fused-skin4",
                     "s2-fused-defaults", "s3-fused-btree", "s3-fused-mlp"])
def multi_game(request):
    return run_multi_game(request.param)


@pytest.mark.parametrize("case", MULTI_CASES)
def test_several_spaces_game_matches_jax(multi_game, case):
    rec = multi_game[case]
    assert rec["diffs"] == [], rec["diffs"][:5]
    facts = rec["facts"]
    if case == "spawn":
        assert len(facts["shards"]) >= 2
        assert all(e > 0 for e in facts["enters"])
    elif case == "enter_space":
        assert facts["mid_window"] == {"jax": None, "port": None}
        assert facts["m1"] == (1, True) and facts["p0"] >= 1
        # the source Space's hooks in the window, then at the flush:
        # OnMigrateIn, OnEnterSpace, OnEntityEnterSpace
        kinds = [x[0] for x in facts["hooks_m1"]]
        assert kinds[:6] == ["migrate_out", "left_space", "space_leave",
                             "migrate_in", "entered_space", "space_enter"]
        assert "enter" in kinds
        # the player leaves its old neighbour's interest (the source
        # row's despawn) and enters its new one's
        kinds = [x[0] for x in facts["hooks_p0"]]
        assert "leave" in kinds and "enter" in kinds
        assert {"create_entity", "destroy_entity"} <= set(facts["msgs"])
    elif case == "cancel_in_window":
        assert facts["slot"] is None and facts["space"]
        assert "migrate_in" not in [x[0] for x in facts["hooks"]]
    elif case == "destroy_in_window":
        assert facts["gone"] and facts["staged"] == 0
    elif case == "migrate_with_sync":
        assert facts["staged"] == {"jax": 3, "port": 3}
        assert facts["p1"] == (150.0, 0.0, 150.0) and facts["p0"] == 0
        assert facts["syncs"] > 0
    elif case == "attr_in_window":
        assert facts["hot"] == 77.0 and facts["shard"] == 0


KNOBS = {
    "mesh": dict(mesh=2, n_spaces=2),
    "megaspace": dict(mesh=2, n_spaces=2, megaspace=True),
    "n_spaces": dict(n_spaces=2),
    "pipeline_decode": dict(pipeline_decode=True),
    "snapshot_keyframe_every": dict(snapshot_keyframe_every=4),
}
SMALL = TConfig(capacity=64, grid=TGrid(radius=10.0, k=8, cell_cap=4))


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_refused_knobs_raise_not_implemented(knob):
    """Each knob of a shape the port does not run raises. Several
    Spaces (``n_spaces``), the pipelined decode, the snapshot chain's
    keyframe cadence, a mesh and the megaspace were refused until they
    were ported; those cases now hold that the World takes them and
    ticks (the pipelined World decoding one tick late, the mesh and
    megaspace Worlds on a mesh of 2 on the CPU)."""
    if knob in ("mesh", "megaspace"):
        from goworld_tpu_torch.parallel.mesh import make_mesh

        kw = dict(KNOBS[knob], mesh=make_mesh(2, device="cpu"))
        w = tent.World(SMALL, device="cpu", **kw)
        w.tick()
        assert tuple(w.state.pos.shape) == (2, SMALL.capacity, 3)
        assert w.last_outputs.global_alive.tolist() == [0, 0]
        assert (w.mega is not None) == (knob == "megaspace")
        return
    if knob in ("n_spaces", "pipeline_decode", "snapshot_keyframe_every"):
        w = tent.World(SMALL, device="cpu", **KNOBS[knob])
        w.tick()
        if knob == "n_spaces":
            assert tuple(w.state.pos.shape) == (2, SMALL.capacity, 3)
            assert w.last_outputs.enter_n.shape == (2,)
        elif knob == "pipeline_decode":
            assert w.pipeline_decode and w.last_outputs is None
            w.tick()
            assert w.last_outputs.enter_n.shape == (1,)
        else:
            assert w.snapshot_keyframe_every == 4
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tent.World(SMALL, device="cpu", **KNOBS[knob])


@pytest.mark.parametrize("method", ["apply_tick_config", "cost_report"])
def test_refused_planes_raise_not_implemented(method):
    """The governor's config swap and the step's cost report were
    refused until they were ported: a swap to the World's own config
    keeps it ticking, and the report has the JAX report's fields and
    config key, with no error."""
    from goworld_tpu.entity.manager import World as JWorld
    from goworld_tpu.utils.devprof import CostReport as JReport
    from goworld_tpu_torch.utils.devprof import CostReport

    w = tent.World(SMALL, device="cpu")
    if method == "apply_tick_config":
        w.tick()
        w.apply_tick_config(w.cfg, w._step)
        w.tick()
        assert w.tick_count == 2 and w.workload_signature() is not None
        return
    rep = w.cost_report()
    assert rep.error is None
    assert [f.name for f in dataclasses.fields(CostReport)] == \
        [f.name for f in dataclasses.fields(JReport)]
    jcfg = JConfig(capacity=64, grid=JGrid(radius=10.0, k=8, cell_cap=4))
    jrep = JWorld(jcfg, telemetry_live=False, residency=False,
                  audit=False).cost_report()
    assert rep.config == jrep.config and rep.key == jrep.key
    assert rep.name == jrep.name and rep.n == jrep.n
    assert rep.flops > 0 and rep.bytes_accessed > 0
    assert rep.argument_size > 0 and rep.peak_hbm_bytes > 0


def test_cost_report_counts_the_step_from_shapes():
    """The output bytes of the cost model are a real tick's output
    lanes' bytes, at one Space and at two; the roofline model equals the
    reference's; a broken state folds into the report's error."""
    import goworld_tpu.utils.devprof as jdev
    from goworld_tpu_torch.utils import devprof

    for spaces in (1, 2):
        w = tent.World(SMALL, n_spaces=spaces, device="cpu")
        _, outs = w._step(w.state, w._flush_staging(), w.policy)
        nbytes = sum(getattr(outs, f.name).numel()
                     * getattr(outs, f.name).element_size()
                     for f in dataclasses.fields(outs))
        assert devprof.output_bytes(SMALL, spaces) == nbytes
        rep = w.cost_report()
        assert rep.output_size - rep.alias_size == nbytes
    for kw in ({"sort_impl": "argsort", "sweep_impl": "ranges", "skin": 0.0},
               {"sort_impl": "counting", "sweep_impl": "table",
                "skin": 0.0},
               {"sort_impl": "argsort", "sweep_impl": "fused", "skin": 0.0},
               {"sort_impl": "counting", "sweep_impl": "ranges",
                "skin": 4.0, "verlet_cap": 48},
               {"sort_impl": "pallas", "sweep_impl": "fused", "skin": 4.0,
                "precision": "q16"}):
        kw = dict(kw, k=32, cell_cap=12, radius=50.0, extent_x=10000.0,
                  extent_z=10000.0)
        assert devprof.roofline_model_bytes(131072, kw) == \
            jdev.roofline_model_bytes(131072, kw)
    rep = devprof.cost_report(SMALL, 1, None, name="broken")
    assert rep.error and rep.flops is None
    devprof.reset()
    w = tent.World(SMALL, device="cpu")
    snap = devprof.snapshot(analyze=True)
    assert "error" not in snap["reports"]["world.tick"]
    assert snap["reports"]["world.tick"]["key"] == w.cost_report().key
    devprof.reset()


@pytest.mark.parametrize("change", [dict(behavior="mlp"),
                                    dict(grid=TGrid(radius=10.0, skin=2.0))],
                         ids=["mlp", "skin"])
def test_unported_configs_raise_not_implemented(change):
    """A config the port does not run raises. The Verlet skin and the
    mlp behavior were refused until they were ported; their cases now
    hold that the World takes them and ticks (the mlp World with its
    policy drawn from the seed), at n_spaces = 2 too, where behaviors
    were refused until they were ported on the batched step."""
    cfg = dataclasses.replace(SMALL, **change)
    w = tent.World(cfg, device="cpu")
    w.tick()
    if cfg.grid.skin > 0:
        assert w.state.aoi_cache is not None
        assert int(w.last_outputs.aoi_rebuilt[0]) == 1
        return
    assert w.policy is not None and w.policy.hidden == 128
    w2 = tent.World(cfg, n_spaces=2, device="cpu")
    w2.tick()
    assert w2.policy is not None and w2.state.pos.shape[0] == 2


def test_world_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tent.World(SMALL)
    assert tent.World(SMALL, device="cpu").state.pos.device.type == "cpu"


def test_tick_records_its_four_spans_and_traced_rpcs():
    from goworld_tpu_torch.utils import metrics, opmon, tracing

    class Hero(tent.Entity):
        def Hello(self, x):
            self.got = x

    w = tent.World(SMALL, device="cpu")
    w.register_entity("Hero", Hero)
    w.register_space("Arena", tent.Space)
    w.create_nil_space()
    h = w.create_space("Arena").create_entity("Hero", pos=(1.0, 0.0, 1.0))
    w.call(h.id, "Hello", 5)
    ctx = tracing.new_trace()
    with tracing.use(ctx):
        w.tick()
    assert h.got == 5
    spans = [name for name, *_ in metrics.timeline.records()[-1][2]]
    assert spans == ["flush_staging", "device_step", "fetch_outputs",
                     "decode_fanout"]
    assert opmon.monitor.snapshot()["world.tick"]["count"] >= 1
    rec = [r for r in tracing.recorder.records() if r[2] == ctx.trace_hex]
    assert [(r[0], r[1], r[4], r[7]["method"]) for r in rec] == [
        ("invoke", "game1", ctx.span_hex, "Hello")]


def test_served_game_twins_agree_on_the_cpu():
    """The chip phase's served game at a small size, its walking syncs
    and its teleporting stress stream in turns: the sweep/sort pairs
    give equal sinks, hooks and states, a walking sync lands one step
    from where its player stood, and the hot attr set twice a tick lands
    on the device with its last value."""
    from goworld_tpu_torch.workload import serve_world

    try:
        twins = [serve_world(8192, 5, "cpu", record_hooks=True, keep=True,
                             sweep_impl=sweep, sort_impl=sort)
                 for sweep, sort in IMPLS]
    finally:
        gc.unfreeze()  # serve_world froze the populations, as a server
    sv0 = twins[0]
    w0, step = sv0.world, sv0.world.cfg.npc_speed * sv0.world.cfg.dt
    slots = [w0.entities[e.decode()].slot for e in sv0.players]
    for t in range(4):  # tick 1 flushes the population
        before = interop.state_to_numpy(w0.state)["pos"][0, slots][:, [0, 2]]
        for sv in twins:
            assert sv.stage(teleport=t == 2)["destroys"] == 64
            sv.world.tick()
        after = interop.state_to_numpy(w0.state)["pos"][0, slots][:, [0, 2]]
        moved = np.abs(after - before).max(axis=1)
        assert t == 0 or moved.max() > (step if t == 2 else 0)
        if t in (1, 3):  # one step, give or take float32 rounding of x, z
            ulp = np.spacing(np.float32(w0.cfg.grid.extent_x))
            assert moved.max() <= step + 2 * ulp
        a, b = (sv.sink.take() for sv in twins)
        assert _same(a["kept"], b["kept"])
        assert a["sync_records"] > 0 and a["messages"]
        assert twins[0].hooks == twins[1].hooks and twins[0].hooks
        for sv in twins:
            sv.hooks.clear()
        sa, sb = (interop.state_to_numpy(sv.world.state) for sv in twins)
        assert all(_same(sa[k], sb[k]) for k in sa)
    w = twins[0].world
    mobs = [w.entities[e] for e in twins[0].mobs]
    hot = interop.state_to_numpy(w.state)["hot_attrs"][0, :, 0]
    assert [hot[m.slot] for m in mobs] == [m.attrs["hp"] for m in mobs]


def test_served_several_spaces_twins_agree_on_the_cpu():
    """The chip phase's served game of several Spaces at a small size:
    the sweep/sort pairs give equal sinks, hooks and states while the
    game moves SERVE_MIGRATIONS entities between Spaces a tick, every
    staged migration arrives, and each Space's alive rows are its
    entities."""
    from goworld_tpu_torch.workload import SERVE_MIGRATIONS, serve_world

    try:
        twins = [serve_world(4096 + 1024, 6, "cpu", record_hooks=True,
                             keep=True, spaces=3, sweep_impl=sweep,
                             sort_impl=sort)
                 for sweep, sort in IMPLS]
    finally:
        gc.unfreeze()  # serve_world froze the populations, as a server
    for t in range(3):
        for sv in twins:
            staged = sv.stage()
            assert staged["migrations"] == SERVE_MIGRATIONS
            sv.world.tick()
            assert sv.migrated() == SERVE_MIGRATIONS
            w = sv.world
            assert w.last_outputs.alive_count.tolist() == [
                len(o) for o in w._slot_owner]
        a, b = (sv.sink.take() for sv in twins)
        assert _same(a["kept"], b["kept"]) and a["sync_records"] > 0
        assert twins[0].hooks == twins[1].hooks and twins[0].hooks
        for sv in twins:
            sv.hooks.clear()
        sa, sb = (interop.state_to_numpy(sv.world.state) for sv in twins)
        assert all(_same(sa[k], sb[k]) for k in sa)
        assert sa["pos"].shape == (3, 4096 + 1024, 3)
