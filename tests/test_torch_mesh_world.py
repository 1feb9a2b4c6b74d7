"""The port's World on a mesh of 8 shards against the JAX World on its
8 CPU devices (``tests/conftest.py``), on the CPU.

One scripted game runs on the JAX ``World(cfg, 8, mesh=make_mesh(8))``
(its ``make_multi_tick`` under ``shard_map``) and on the port's
``World(cfg, 8, mesh=make_mesh(8, device="cpu"))`` (every shard on one
device), both at their default planes: creates in every shard,
``enter_space`` moves between shards riding the step's own exchange (a
plain crossing, one whose hot attr is written inside the migration
window, one destroyed inside it, one cancelled before its flush), moves
into a full shard (dropped at the destination and reconciled: parked in
the nil space) and client syncs. After every tick the two sides must
agree bit for bit on the hook log, the client messages, the sync-sink
batches, every entity's shard, slot, position, attrs and interest sets,
the slot owners, the whole stacked state, every output lane (the
arrival records included), the telemetry lanes, the signatures, the
audit's stats and its ledger; the port's slot and client mirrors must
match its slot owners.

Beside it, the port of ``tests/test_entity_model.py``'s
``test_mesh_migration_repoints_entity`` and the refusals that stand:
a mesh over two cards, a mesh of the wrong size, the pipelined decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import interop
from goworld_tpu_torch.core.state import WorldConfig
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel.mesh import make_mesh
from goworld_tpu_torch.parallel.step import MultiTickInputs
from test_torch_megaspace_world import _diff_planes, _jax_outputs
from test_torch_world import Clock, _jax_state, _same, eid, game_types

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

S = 8
CAP = 32
EXTENT = 200.0
FULL = 7  # the shard filled to capacity


def _config(is_jax: bool):
    grid = dict(radius=30.0, extent_x=EXTENT, extent_z=EXTENT, k=16,
                cell_cap=16, row_block=CAP, topk_impl="sort", skin=0.0,
                precision="off")
    world = dict(capacity=CAP, npc_speed=5.0, enter_cap=256, leave_cap=256,
                 sync_cap=512, attr_sync_cap=64, input_cap=16,
                 delta_rows_cap=CAP)
    if is_jax:
        from goworld_tpu.core.state import WorldConfig as JConfig
        from goworld_tpu.ops.aoi import GridSpec as JGrid
        # the reference's Pallas sweep does not trace under shard_map on
        # the CPU; its plain pair is bit-identical by contract
        return JConfig(grid=JGrid(sweep_impl="ranges", sort_impl="argsort",
                                  **grid), **world)
    return WorldConfig(grid=GridSpec(sweep_impl="fused", sort_impl="pallas",
                                     **grid), **world)


class MeshSide:
    """One package's World on a mesh of S shards: an Arena a shard, its
    hook log, sink batches and fake clock."""

    def __init__(self, pkg):
        from goworld_tpu import entity as jent

        self.pkg = pkg
        self.log: list = []
        self.sync: list = []
        self.clock = Clock()
        is_jax = pkg is jent
        if is_jax:
            from goworld_tpu.parallel.mesh import make_mesh as jmesh
            mesh, kw = jmesh(S), {}
        else:
            mesh, kw = make_mesh(S, device="cpu"), dict(device="cpu")
        types = game_types(pkg, self.log)
        w = pkg.World(_config(is_jax), S, mesh=mesh, migrate_cap=4,
                      clock=self.clock, seed=3, audit_sample_every=2,
                      residency_sample_every=2, **kw)
        w.SIG_WINDOW_TICKS = 4
        for name in ("Mob", "Player"):
            w.register_entity(name, types[name])
        w.register_space("Arena", types["Arena"])
        w.create_nil_space()
        self.arenas = [w.create_space("Arena", eid=eid(f"mesh.arena{d}"))
                       for d in range(S)]
        w.sync_sink = (lambda gate, cids, eids, vals:
                       self.sync.append((gate, cids.copy(), eids.copy(),
                                         vals.copy())))
        self.w = w

    def tick(self):
        self.clock.t += 1.0 / 60.0
        self.w.tick()

    def take(self) -> dict:
        got = dict(log=list(self.log), sync=list(self.sync),
                   msgs=list(self.w.client_messages))
        self.log.clear()
        self.sync.clear()
        self.w.client_messages.clear()
        return got


def _mirrors_match(w) -> bool:
    for sh in range(w.n_spaces):
        expect_eid = np.zeros(w.cfg.capacity, "S16")
        expect_cid = np.zeros(w.cfg.capacity, "S16")
        expect_gate = np.full(w.cfg.capacity, -1, np.int32)
        for slot, e_id in w._slot_owner[sh].items():
            expect_eid[slot] = e_id.encode()
            e = w.entities.get(e_id)
            if e is not None and e.client is not None:
                expect_cid[slot] = e.client.client_id.encode()
                expect_gate[slot] = e.client.gate_id
        if not ((w._mir_eid[sh] == expect_eid).all()
                and (w._mir_cid[sh] == expect_cid).all()
                and (w._mir_gate[sh] == expect_gate).all()):
            return False
    return True


def _diff(j: MeshSide, t: MeshSide) -> list[str]:
    jgot, tgot = j.take(), t.take()
    bad = []
    if jgot["log"] != tgot["log"]:
        bad.append(f"hook log {jgot['log']} != {tgot['log']}")
    if not _same(jgot["msgs"], tgot["msgs"]):
        bad.append("client messages")
    if not _same(jgot["sync"], tgot["sync"]):
        bad.append("sync batches")
    jw, tw = j.w, t.w
    if set(jw.entities) != set(tw.entities):
        return bad + [f"entity ids {set(jw.entities) ^ set(tw.entities)}"]
    for k in sorted(jw.entities):
        je, te = jw.entities[k], tw.entities[k]
        row = [(x.shard, x.slot, x.position, x.yaw, x.attrs.to_dict(),
                None if x.space is None else x.space.id,
                sorted(x.interested_in), sorted(x.interested_by))
               for x in (je, te)]
        if not _same(*row):
            bad.append(f"entity {k} {row[0]} != {row[1]}")
    if [dict(o) for o in jw._slot_owner] != \
            [dict(o) for o in tw._slot_owner]:
        bad.append("slot owners")
    if [sorted(f) for f in jw._free] != [sorted(f) for f in tw._free]:
        bad.append("free slots")
    jst, tst = _jax_state(jw), interop.state_to_numpy(tw.state)
    for name, a in tst.items():
        if not _same(jst[name], a):
            bad.append(f"state lane {name}")
    if not _same(_jax_outputs(jw.last_outputs),
                 _jax_outputs(tw.last_outputs)):
        bad.append("output lanes")
    if not _mirrors_match(tw):
        bad.append("port mirrors")
    return bad + _diff_planes(jw, tw)


@pytest.fixture(scope="module")
def mesh_game() -> dict:
    """The script on both packages; per case, the differences of each of
    its ticks and the facts its test checks."""
    from goworld_tpu import entity as jent

    sides = {"jax": MeshSide(jent), "port": MeshSide(tent)}
    j, t = sides["jax"], sides["port"]
    rng = np.random.default_rng(23)
    results: dict = {}

    def both(fn):
        return {k: fn(s) for k, s in sides.items()}

    def ticks(case, n=1):
        rec = results.setdefault(case, {"diffs": [], "facts": {}})
        for i in range(n):
            for s in sides.values():
                s.tick()
            rec["diffs"] += [f"{case} tick {i}: {d}" for d in _diff(j, t)]
            rec.setdefault("got", []).append(t.log[:])
            rec.setdefault("outs", []).append(t.w.last_outputs)
        return rec

    mob_pos = rng.uniform(0, EXTENT, (S, CAP, 2))

    def spawn(s):
        w = s.w
        for d, arena in enumerate(s.arenas):
            n = CAP if d == FULL else 10
            for i in range(n):
                x, z = mob_pos[d, i]
                arena.create_entity("Mob", pos=(x, 0.0, z),
                                    eid=eid(f"ms{d}m{i}"), moving=i % 4 == 0,
                                    attrs={"hp": 10 + i, "name": f"m{i}"})
            if d != FULL:
                arena.create_entity(
                    "Player", pos=(100.0, 0.0, 100.0 + 5 * d),
                    eid=eid(f"ms{d}p"),
                    client=s.pkg.GameClient(1, f"mc{d}".ljust(16, "x"), w))

    both(spawn)
    rec = ticks("spawn", 2)
    rec["facts"] = dict(alive=int(t.w.last_outputs.global_alive[0]))

    def enter(s):
        w = s.w
        w.entities[eid("ms0m1")].enter_space(s.arenas[3].id,
                                             (102.0, 0.0, 116.0))
        w.entities[eid("ms0p")].enter_space(s.arenas[5].id,
                                            (101.0, 0.0, 126.0))
        return w.entities[eid("ms0m1")].slot

    mid = both(enter)
    rec = ticks("enter_space", 3)
    m1 = t.w.entities[eid("ms0m1")]
    rec["facts"] = dict(mid_window=mid, m1=(m1.shard, m1.space.id),
                        p0=t.w.entities[eid("ms0p")].shard,
                        arrived=sum(int(o.arr_n.sum()) for o in rec["outs"]))

    def attr_in_window(s):
        w = s.w
        e = w.entities[eid("ms2m3")]
        e.enter_space(s.arenas[1].id, (90.0, 0.0, 90.0))
        e.attrs["hp"] = 77

    both(attr_in_window)
    rec = ticks("attr_in_window", 2)
    m3 = t.w.entities[eid("ms2m3")]
    rec["facts"] = dict(shard=m3.shard, hot=float(
        t.w.state.hot_attrs[m3.shard, m3.slot, 0]))

    def destroy_in_window(s):
        w = s.w
        e = w.entities[eid("ms1m2")]
        e.enter_space(s.arenas[0].id, (60.0, 0.0, 60.0))
        e.destroy()

    both(destroy_in_window)
    rec = ticks("destroy_in_window", 2)
    rec["facts"] = dict(gone=eid("ms1m2") not in t.w.entities)

    def cancel(s):
        w = s.w
        e = w.entities[eid("ms4m5")]
        e.enter_space(s.arenas[2].id, (50.0, 0.0, 50.0))
        e.enter_space(w.nil_space.id, (1.0, 0.0, 1.0))

    both(cancel)
    rec = ticks("cancel_in_window", 2)
    m5 = t.w.entities[eid("ms4m5")]
    rec["facts"] = dict(slot=m5.slot, nil=m5.space is t.w.nil_space)

    def to_full(s):
        w = s.w
        w.entities[eid("ms3m6")].enter_space(s.arenas[FULL].id,
                                             (40.0, 0.0, 40.0))
        w.stage_pos_sync_batch(
            np.array([eid("ms1p"), eid("ms2p")], "S16"),
            np.array([[120, 0, 120, 1], [130, 0, 130, 2]], np.float32))

    both(to_full)
    rec = ticks("full_destination", 3)
    m6 = t.w.entities[eid("ms3m6")]
    rec["facts"] = dict(
        dropped=sum(int(o.migrate_dropped.sum()) for o in rec["outs"]),
        nil=m6.space is t.w.nil_space, slot=m6.slot)
    ticks("settle", 2)
    return results


CASES = ["spawn", "enter_space", "attr_in_window", "destroy_in_window",
         "cancel_in_window", "full_destination", "settle"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_world_game_matches_jax(mesh_game, case):
    rec = mesh_game[case]
    assert rec["diffs"] == [], rec["diffs"][:5]
    facts = rec["facts"]
    if case == "spawn":
        assert facts["alive"] == CAP + (S - 1) * 11
    elif case == "enter_space":
        # no device row inside the window; the arrival re-points it
        assert facts["mid_window"] == {"jax": None, "port": None}
        assert facts["m1"] == (3, eid("mesh.arena3"))
        assert facts["p0"] == 5 and facts["arrived"] >= 2
    elif case == "attr_in_window":
        assert facts["shard"] == 1 and facts["hot"] == 77.0
    elif case == "destroy_in_window":
        assert facts["gone"]
    elif case == "cancel_in_window":
        assert facts["slot"] is None and facts["nil"]
    elif case == "full_destination":
        # dropped at the full shard, then parked in the nil space
        assert facts["dropped"] == 1
        assert facts["nil"] and facts["slot"] is None


class Monster(Entity):
    ATTRS = {"hp": "allclients hot:0"}


class MySpace(Space):
    pass


def test_mesh_migration_repoints_entity():
    """``tests/test_entity_model.py``'s case on the port: an entity that
    enters a Space on another shard arrives with its hot attr, its old
    neighbour loses it a tick later, and its old slot is released."""
    cfg = WorldConfig(
        capacity=32,
        grid=GridSpec(radius=10.0, extent_x=100.0, extent_z=100.0,
                      k=8, cell_cap=32, row_block=32),
    )
    w = World(cfg, n_spaces=8, mesh=make_mesh(8, device="cpu"),
              clock=Clock(), migrate_cap=4, device="cpu")
    w.register_entity("Monster", Monster)
    w.register_space("MySpace", MySpace)
    w.create_nil_space()
    spaces = [w.create_space("MySpace") for _ in range(8)]
    a = spaces[0].create_entity("Monster", pos=(50, 0, 50),
                                attrs={"hp": 7})
    b = spaces[0].create_entity("Monster", pos=(52, 0, 50))
    w.tick()
    assert b.id in a.interested_in
    old_slot = a.slot
    a.enter_space(spaces[5].id, (20, 0, 20))
    w.tick()
    assert a.space is spaces[5]
    assert a.slot is not None
    assert bool(w.state.alive[5, a.slot])
    assert float(w.state.hot_attrs[5, a.slot, 0]) == 7.0
    w.tick()  # leave events on the old shard fire now
    assert a.id not in b.interested_in
    assert np.allclose(a.position, (20, 0, 20))
    assert w._slot_owner[0].get(old_slot) != a.id
    assert isinstance(w._flush_staging(), MultiTickInputs)


def test_mesh_world_refusals():
    """A mesh over two cards raises ``NotImplementedError`` naming
    ROADMAP.md; a mesh whose size is not ``n_spaces`` and the pipelined
    decode on a mesh raise ``ValueError``, as in the JAX World."""
    cfg = WorldConfig(capacity=32, grid=GridSpec(
        radius=10.0, extent_x=100.0, extent_z=100.0, k=8, cell_cap=32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(8, devices=["cuda:0", "cuda:1"])
    two = dataclasses.replace(make_mesh(2, device="cpu"),
                              devices=np.array([torch.device("cpu"),
                                                torch.device("meta")],
                                               dtype=object))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        World(cfg, 2, mesh=two, device="cpu")
    with pytest.raises(ValueError, match="n_spaces"):
        World(cfg, 4, mesh=make_mesh(8, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="pipeline_decode"):
        World(cfg, 8, mesh=make_mesh(8, device="cpu"), device="cpu",
              pipeline_decode=True)
    w = World(cfg, 8, mesh=make_mesh(8, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="single-shard"):
        w.apply_tick_config(cfg, w._step)
    rep = w.cost_report()
    assert rep.error is None and rep.argument_size > 0


def test_migrant_back_in_its_own_row_keeps_it():
    """An entity that leaves shard 0 for shard 1 and comes straight back
    lands in its own source row (dead a tick, out of quarantine, the
    lowest free): the release of that row, due a tick after it left,
    must not free it under the entity. The JAX World frees it (its
    ``_slot_owner`` loses the entity and the slot returns to the free
    set while the row lives: ROADMAP.md Queue C5); the port keeps it,
    and the two agree on everything else."""
    from goworld_tpu import entity as jent
    from goworld_tpu.core.state import WorldConfig as JConfig
    from goworld_tpu.ops.aoi import GridSpec as JGrid
    from goworld_tpu.parallel.mesh import make_mesh as jmesh

    grid = dict(radius=10.0, extent_x=100.0, extent_z=100.0, k=8,
                cell_cap=32, row_block=32)
    got = {}
    for name, pkg in (("jax", jent), ("port", tent)):
        if name == "jax":
            cfg = JConfig(capacity=32, grid=JGrid(**grid))
            w = pkg.World(cfg, 2, mesh=jmesh(2), clock=Clock(),
                          migrate_cap=4)
        else:
            cfg = WorldConfig(capacity=32, grid=GridSpec(**grid))
            w = pkg.World(cfg, 2, mesh=make_mesh(2, device="cpu"),
                          clock=Clock(), migrate_cap=4, device="cpu")
        w.register_entity("Monster", game_types(pkg, [])["Mob"])
        w.register_space("MySpace", game_types(pkg, [])["Arena"])
        w.create_nil_space()
        a0, a1 = (w.create_space("MySpace", eid=eid(f"back{d}"))
                  for d in range(2))
        x = a0.create_entity("Monster", pos=(50, 0, 50), eid=eid("x"))
        a0.create_entity("Monster", pos=(52, 0, 50), eid=eid("y"))
        w.tick()
        home = x.slot
        x.enter_space(a1.id, (20, 0, 20))
        w.tick()
        x.enter_space(a0.id, (60, 0, 60))
        w.tick()
        assert (x.shard, x.slot) == (0, home)
        alive = np.asarray(w.state.alive)
        got[name] = (w._slot_owner[0].get(home), home in w._free[0],
                     bool(alive[0, home]))
    assert got["port"] == (eid("x"), False, True)
    assert got["jax"] == (None, True, True)
