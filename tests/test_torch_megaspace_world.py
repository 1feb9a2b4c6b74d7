"""The port's megaspace World on the CPU: one registered Space type
spanning 8 tiles on one device, entities created and moved through the
normal entity API.

The seven cases of ``tests/test_megaspace_world.py`` and the four of
``tests/test_mega_2d.py`` run on the port's World as they run on the
JAX World (interest sets against a brute-force oracle while entities
churn across tile borders, identity kept across a hop, AOI-less
entities excluded, a destroy mid-churn, a border-crosser dropped at a
full tile reconciled, the space-type checks, the 2D corner), and so
does the megaspace case of ``tests/test_mirrors.py``.

Beside them, one scripted game runs on the JAX ``World(megaspace=True)``
(8 CPU devices under ``shard_map``) and on the port's, in 1D (8 strips)
and 2D (4 x 2 tiles), under the ``ppermute`` and the ``async`` halo,
both at their default planes; after every tick the two sides must agree
bit for bit on the hook log, the client messages, the sync-sink batches,
every entity's tile, slot, position, attrs and interest sets, the whole
stacked state, every output lane (the arrival records and the halo and
migration demands included), the drained telemetry lanes, the
signatures, the audit's stats and its ledger. The game ends with a
freeze whose file is byte for byte the JAX package's, and a restore into
a fresh megaspace World.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import freeze as tfreeze
from goworld_tpu_torch import interop
from goworld_tpu_torch.core.state import WorldConfig
from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel.mesh import make_mesh
from test_torch_world import (
    Clock,
    _jax_state,
    _ledger,
    _same,
    eid,
    game_types,
)

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N_DEV = 8
TILE_W = 100.0
RADIUS = 10.0


class Walker(Entity):
    pass


class Silent(Entity):  # AOI-less (service-like)
    pass


class MegaArena(Space):
    pass


def _pos(w) -> np.ndarray:
    return w.state.pos.numpy()


def _alive(w) -> np.ndarray:
    return w.state.alive.numpy()


def _mega_world(capacity=96):
    cfg = WorldConfig(
        capacity=capacity,
        grid=GridSpec(
            radius=RADIUS, extent_x=TILE_W + 2 * RADIUS, extent_z=100.0,
            k=32, cell_cap=64, row_block=capacity,
        ),
        npc_speed=40.0,  # fast movers: border crossings within a few ticks
        turn_prob=0.2,
        enter_cap=8192, leave_cap=8192, sync_cap=8192,
    )
    w = World(cfg, n_spaces=N_DEV, mesh=make_mesh(N_DEV, device="cpu"),
              megaspace=True, halo_cap=64, migrate_cap=32, device="cpu")
    w.register_space("MegaArena", MegaArena, megaspace=True)
    w.register_entity("Walker", Walker)
    w.register_entity("Silent", Silent, use_aoi=False)
    w.create_nil_space()
    return w


def _oracle_check(w: World, arena, exclude=(), radius=RADIUS):
    """Host interest sets must equal the Chebyshev-radius oracle over the
    device positions (post-tick positions ARE the sweep positions)."""
    ents = [
        w.entities[eid] for eid in arena.members
        if w.entities[eid].slot is not None
    ]
    pos = _pos(w)
    coords = {}
    for e in ents:
        p = pos[e.shard, e.slot]
        coords[e.id] = (float(p[0]), float(p[2]))
    part = [e for e in ents if e.id not in exclude]
    for e in part:
        ex, ez = coords[e.id]
        want = {
            o.id for o in part
            if o.id != e.id
            and max(abs(coords[o.id][0] - ex), abs(coords[o.id][1] - ez))
            <= radius
        }
        assert e.interested_in == want, (
            f"{e.id} on tile {e.shard}: got {sorted(e.interested_in)} "
            f"want {sorted(want)}"
        )


# ------------------------------------------------- tests/test_megaspace_world

def test_mega_world_border_churn_matches_oracle():
    w = _mega_world()
    arena = w.create_space("MegaArena")
    assert arena.is_mega and arena.use_aoi
    rng = np.random.default_rng(42)
    ents = []
    spawn_tile = {}
    for _ in range(N_DEV * 40):
        x = float(rng.uniform(0, TILE_W * N_DEV))
        z = float(rng.uniform(0, 100.0))
        e = w.create_entity("Walker", space=arena, pos=(x, 0, z),
                            moving=True)
        ents.append(e)
        spawn_tile[e.id] = e.shard
    for tick in range(10):
        w.tick()
        outs = w.last_outputs
        assert int(outs.migrate_dropped.sum()) == 0
        assert (outs.halo_demand <= 64).all(), \
            "halo overflow: test halo_cap undersized"
        assert (outs.migrate_demand <= 32).all()
        _oracle_check(w, arena)
    # host tile bookkeeping tracks device positions exactly
    pos = _pos(w)
    for e in ents:
        x = float(pos[e.shard, e.slot][0])
        assert e.shard == max(0, min(N_DEV - 1, int(x // TILE_W))), \
            f"{e.id}: host tile {e.shard} disagrees with x={x}"
    assert sum(len(o) for o in w._slot_owner) == len(ents)
    crossings = sum(1 for e in ents if e.shard != spawn_tile[e.id])
    assert crossings > 0, "no entity ever crossed a tile border"


def test_mega_world_crossing_entity_keeps_identity():
    w = _mega_world()
    arena = w.create_space("MegaArena")
    a = w.create_entity("Walker", space=arena, pos=(95.0, 0, 50.0))
    b = w.create_entity("Walker", space=arena, pos=(97.0, 0, 50.0))
    a.attrs["hp"] = 77
    w.tick()
    assert a.shard == 0 and b.shard == 0
    assert a.interested_in == {b.id}
    a.set_position((103.0, 0, 50.0))
    w.tick()
    assert a.shard == 1, f"a did not hop tiles (shard={a.shard})"
    assert a.slot is not None
    assert a.attrs["hp"] == 77
    assert a.interested_in == {b.id}, "interest lost across the border"
    assert b.interested_in == {a.id}
    p = a.position
    assert abs(p[0] - 103.0) < 1.0
    a.set_position((140.0, 0, 50.0))
    w.tick()
    assert a.interested_in == set()
    assert b.interested_in == set()
    assert a.shard == 1


def test_mega_world_aoi_less_entity_excluded():
    w = _mega_world()
    arena = w.create_space("MegaArena")
    svc = w.create_entity("Silent", space=arena, pos=(99.0, 0, 50.0))
    others = [
        w.create_entity("Walker", space=arena, pos=(95.0 + i, 0, 50.0))
        for i in range(4)
    ]
    for _ in range(3):
        w.tick()
    assert not svc.interested_in and not svc.interested_by
    for o in others:
        assert svc.id not in o.interested_in
    _oracle_check(w, arena, exclude={svc.id})


def test_mega_world_destroy_mid_churn():
    w = _mega_world()
    arena = w.create_space("MegaArena")
    ents = [
        w.create_entity("Walker", space=arena,
                        pos=(90.0 + i * 2.0, 0, 50.0), moving=True)
        for i in range(10)
    ]
    w.tick()
    victim = ents[3]
    watchers = set(victim.interested_by)
    assert watchers
    w.destroy_entity(victim)
    for _ in range(2):
        w.tick()
    for wid in watchers:
        we = w.entities.get(wid)
        if we is not None:
            assert victim.id not in we.interested_in
    _oracle_check(w, arena)


def test_mega_dropped_migrant_reconciled():
    """A border-crosser dropped at a full destination tile must not
    become a zombie addressing a dead row: the host detects the orphan
    and respawns it (or parks it in the nil space when the tile stays
    full)."""
    cfg = WorldConfig(
        capacity=6,
        grid=GridSpec(radius=RADIUS, extent_x=TILE_W + 2 * RADIUS,
                      extent_z=100.0, k=8, cell_cap=16, row_block=6),
        enter_cap=256, leave_cap=256, sync_cap=256,
    )
    w = World(cfg, n_spaces=N_DEV, mesh=make_mesh(N_DEV, device="cpu"),
              megaspace=True, halo_cap=8, migrate_cap=4, device="cpu")
    w.register_space("MegaArena", MegaArena, megaspace=True)
    w.register_entity("Walker", Walker)
    w.create_nil_space()
    arena = w.create_space("MegaArena")
    parked = [
        w.create_entity("Walker", space=arena,
                        pos=(150.0 + i, 0, 10.0 + i * 10))
        for i in range(6)
    ]
    mover = w.create_entity("Walker", space=arena, pos=(95.0, 0, 50.0))
    w.tick()
    assert mover.shard == 0
    mover.set_position((150.0, 0, 80.0))
    w.tick()
    assert int(w.last_outputs.migrate_dropped.sum()) == 1
    assert not mover.destroyed
    if mover.space is arena:
        assert mover.slot is not None
        assert bool(_alive(w)[mover.shard, mover.slot])
        assert w._slot_owner[mover.shard][mover.slot] == mover.id
    else:
        assert mover.space is w.nil_space
    for p in parked:
        assert w._slot_owner[p.shard][p.slot] == p.id
        assert bool(_alive(w)[p.shard, p.slot])


def test_mega_world_rejects_normal_aoi_space():
    w = _mega_world()
    w.register_space("Plain", Space)
    with pytest.raises(RuntimeError):
        w.create_space("Plain")


def test_mega_space_type_requires_mega_world():
    cfg = WorldConfig(
        capacity=32,
        grid=GridSpec(radius=10.0, extent_x=120.0, extent_z=100.0,
                      k=8, cell_cap=16, row_block=32),
    )
    w = World(cfg, n_spaces=1, device="cpu")
    w.register_space("MegaArena", MegaArena, megaspace=True)
    with pytest.raises(RuntimeError):
        w.create_space("MegaArena")


# ------------------------------------------------------ tests/test_mega_2d

TX, TZ = 4, 2
TILE_D = 60.0
TILE_W2 = 60.0


def _world_2d(capacity=96, halo_impl="ppermute"):
    cfg = WorldConfig(
        capacity=capacity,
        grid=GridSpec(
            radius=RADIUS,
            extent_x=TILE_W2 + 2 * RADIUS,
            extent_z=TILE_D + 2 * RADIUS,
            k=32, cell_cap=64, row_block=capacity,
        ),
        npc_speed=30.0, turn_prob=0.2,
        enter_cap=8192, leave_cap=8192, sync_cap=8192,
    )
    w = World(cfg, n_spaces=TX * TZ, mesh=make_mesh(TX * TZ, device="cpu"),
              megaspace=True, halo_cap=64, migrate_cap=32,
              mega_shape=(TX, TZ), halo_impl=halo_impl, device="cpu")
    w.register_space("MegaArena", MegaArena, megaspace=True)
    w.register_entity("Walker", Walker)
    w.create_nil_space()
    return w


@pytest.mark.parametrize("halo_impl", ["ppermute", "async"])
def test_2d_corner_visibility(halo_impl):
    """Four entities around a 4-tile corner point: every pair crosses a
    tile boundary, the diagonal pair only through the corner exchange
    (under the phase kernel's plain version with ``async``)."""
    w = _world_2d(halo_impl=halo_impl)
    arena = w.create_space("MegaArena")
    cx, cz = TILE_W2, TILE_D
    quad = [
        w.create_entity("Walker", space=arena, pos=(cx - 3, 0, cz - 3)),
        w.create_entity("Walker", space=arena, pos=(cx + 3, 0, cz - 3)),
        w.create_entity("Walker", space=arena, pos=(cx - 3, 0, cz + 3)),
        w.create_entity("Walker", space=arena, pos=(cx + 3, 0, cz + 3)),
    ]
    for _ in range(2):
        w.tick()
    assert len({e.shard for e in quad}) == 4
    ids = {e.id for e in quad}
    for e in quad:
        assert e.interested_in == ids - {e.id}
    _oracle_check(w, arena)


def test_2d_border_churn_matches_oracle():
    w = _world_2d()
    arena = w.create_space("MegaArena")
    rng = np.random.default_rng(7)
    ents = []
    spawn_tile = {}
    for _ in range(TX * TZ * 30):
        x = float(rng.uniform(0, TILE_W2 * TX))
        z = float(rng.uniform(0, TILE_D * TZ))
        e = w.create_entity("Walker", space=arena, pos=(x, 0, z),
                            moving=True)
        ents.append(e)
        spawn_tile[e.id] = e.shard
    for _ in range(10):
        w.tick()
        outs = w.last_outputs
        assert int(outs.migrate_dropped.sum()) == 0
        assert (outs.halo_demand <= 64).all()
        _oracle_check(w, arena)
    pos = _pos(w)
    for e in ents:
        x, z = float(pos[e.shard, e.slot][0]), float(pos[e.shard, e.slot][2])
        ix = max(0, min(TX - 1, int(x // TILE_W2)))
        iz = max(0, min(TZ - 1, int(z // TILE_D)))
        assert e.shard == ix * TZ + iz
    assert sum(1 for e in ents if e.shard != spawn_tile[e.id]) > 0
    assert sum(len(o) for o in w._slot_owner) == len(ents)


def test_2d_z_crossing_keeps_identity():
    w = _world_2d()
    arena = w.create_space("MegaArena")
    a = w.create_entity("Walker", space=arena, pos=(30.0, 0, 57.0))
    b = w.create_entity("Walker", space=arena, pos=(30.0, 0, 55.0))
    a.attrs["hp"] = 5
    w.tick()
    assert a.shard == 0 and b.shard == 0
    assert a.interested_in == {b.id}
    a.set_position((30.0, 0, 63.0))  # z crosses into tile (0,1)
    w.tick()
    assert a.shard == 1, f"z-crossing did not hop tiles (shard={a.shard})"
    assert a.attrs["hp"] == 5
    assert a.interested_in == {b.id}, "interest lost across the z border"
    assert b.interested_in == {a.id}


def test_mega_config_validates_2d():
    from goworld_tpu_torch.parallel.megaspace import MegaConfig

    cfg = WorldConfig(
        capacity=16,
        grid=GridSpec(radius=10.0, extent_x=80.0, extent_z=80.0,
                      k=8, cell_cap=16, row_block=16),
    )
    with pytest.raises(ValueError, match="mesh_shape"):
        MegaConfig(cfg=cfg, n_dev=8, tile_w=60.0, mesh_shape=(3, 2),
                   tile_d=60.0)
    with pytest.raises(ValueError, match="tile_d"):
        MegaConfig(cfg=cfg, n_dev=8, tile_w=60.0, mesh_shape=(4, 2))
    with pytest.raises(ValueError, match="extent_z"):
        MegaConfig(cfg=cfg, n_dev=8, tile_w=60.0, mesh_shape=(4, 2),
                   tile_d=99.0)
    MegaConfig(cfg=cfg, n_dev=8, tile_w=60.0, mesh_shape=(4, 2),
               tile_d=60.0)  # valid


def test_mirrors_track_megaspace_hops():
    """``tests/test_mirrors.py``'s megaspace case: the slot and client
    mirrors follow ``_slot_owner`` and client bindings through tile
    hops."""
    cfg = WorldConfig(
        capacity=48,
        grid=GridSpec(radius=10.0, extent_x=120.0, extent_z=100.0,
                      k=8, cell_cap=16, row_block=48),
        npc_speed=30.0, turn_prob=0.3,
        enter_cap=2048, leave_cap=2048, sync_cap=2048,
    )
    w = World(cfg, n_spaces=8, megaspace=True, halo_cap=32, migrate_cap=16,
              mesh=make_mesh(8, device="cpu"), device="cpu")
    w.register_entity("Walker", Walker)
    w.register_space("Arena", MegaArena, megaspace=True)
    w.create_nil_space()
    arena = w.create_space("Arena")
    rng = np.random.default_rng(5)
    for i in range(120):
        w.create_entity(
            "Walker", space=arena,
            pos=(float(rng.uniform(0, 800)), 0.0,
                 float(rng.uniform(0, 100))),
            moving=True,
            client=(GameClient(1, f"MEG{i:013d}", w)
                    if i % 11 == 0 else None),
        )
    for _ in range(12):
        w.tick()
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
            assert (w._mir_eid[sh] == expect_eid).all()
            assert (w._mir_cid[sh] == expect_cid).all()
            assert (w._mir_gate[sh] == expect_gate).all()


def test_megaspace_refusals():
    """q16 in the megaspace and tiles on several cards raise
    ``NotImplementedError`` naming ROADMAP.md; the pipelined decode is
    refused as in the JAX World (ValueError)."""
    cfg = WorldConfig(capacity=32, grid=GridSpec(
        radius=10.0, extent_x=120.0, extent_z=100.0, k=8, cell_cap=16,
        precision="q16"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        World(cfg, n_spaces=2, mesh=make_mesh(2, device="cpu"),
              megaspace=True, device="cpu")
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, precision="off"))
    with pytest.raises(ValueError, match="pipeline_decode"):
        World(cfg, n_spaces=2, mesh=make_mesh(2, device="cpu"),
              megaspace=True, pipeline_decode=True, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        World(cfg, n_spaces=2, megaspace=True, device="cpu")


# --------------------------------------------- lane for lane against JAX

GAME_RADIUS = 10.0
GAME_CAP = 64


def _game_config(pkg_is_jax: bool, shape):
    tx, tz = shape
    tile_w, tile_d = (TILE_W, 0.0) if tz == 1 else (TILE_W2, TILE_D)
    grid = dict(radius=GAME_RADIUS, extent_x=tile_w + 2 * GAME_RADIUS,
                extent_z=100.0 if tz == 1 else tile_d + 2 * GAME_RADIUS,
                k=16, cell_cap=32, row_block=GAME_CAP, topk_impl="sort",
                precision="off")
    world = dict(capacity=GAME_CAP, npc_speed=20.0, turn_prob=0.2,
                 enter_cap=1024, leave_cap=1024, sync_cap=2048,
                 attr_sync_cap=64, input_cap=32, delta_rows_cap=GAME_CAP)
    if pkg_is_jax:
        from goworld_tpu.core.state import WorldConfig as JConfig
        from goworld_tpu.ops.aoi import GridSpec as JGrid
        # the reference's Pallas sweep does not trace under shard_map on
        # the CPU; its plain pair is bit-identical by contract
        return JConfig(grid=JGrid(sweep_impl="ranges", sort_impl="argsort",
                                  **grid), **world)
    return WorldConfig(grid=GridSpec(sweep_impl="fused", sort_impl="pallas",
                                     **grid), **world)


class MegaSide:
    """One package's megaspace game: the World, its hook log, sink
    batches and fake clock."""

    def __init__(self, pkg, shape, halo_impl, arena=True):
        from goworld_tpu import entity as jent

        self.pkg = pkg
        self.log: list = []
        self.sync: list = []
        self.clock = Clock()
        self.shape = shape
        is_jax = pkg is jent
        cfg = _game_config(is_jax, shape)
        n = shape[0] * shape[1]
        if is_jax:
            from goworld_tpu.parallel.mesh import make_mesh as jmesh
            mesh, kw = jmesh(n), {}
        else:
            mesh, kw = make_mesh(n, device="cpu"), dict(device="cpu")
        types = game_types(pkg, self.log)
        w = pkg.World(cfg, n_spaces=n, mesh=mesh, megaspace=True,
                      mega_shape=shape if shape[1] > 1 else None,
                      halo_cap=32, migrate_cap=16, halo_impl=halo_impl,
                      clock=self.clock, seed=3, audit_sample_every=2,
                      residency_sample_every=2, **kw)
        w.SIG_WINDOW_TICKS = 4
        for name in ("Mob", "Player"):
            w.register_entity(name, types[name])
        w.register_space("Arena", types["Arena"], megaspace=True)
        w.create_nil_space()
        if arena:
            w.arena = w.create_space("Arena", eid=eid("mega.arena"))
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


def _jax_outputs(o) -> dict:
    out = {}
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if v is None:
            continue
        out[f.name] = _jax_outputs(v) if dataclasses.is_dataclass(v) \
            else np.asarray(v)
    return out


def _diff(j: MegaSide, t: MegaSide) -> list[str]:
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
        return bad + ["entity ids"]
    for k in sorted(jw.entities):
        je, te = jw.entities[k], tw.entities[k]
        row = [(x.shard, x.slot, x.position, x.yaw, x.attrs.to_dict(),
                sorted(x.interested_in), sorted(x.interested_by))
               for x in (je, te)]
        if not _same(*row):
            bad.append(f"entity {k} {row[0]} != {row[1]}")
    if [dict(o) for o in jw._slot_owner] != \
            [dict(o) for o in tw._slot_owner]:
        bad.append("slot owners")
    jst, tst = _jax_state(jw), interop.state_to_numpy(tw.state)
    for name, a in tst.items():
        if not _same(jst[name], a):
            bad.append(f"state lane {name}")
    jo = _jax_outputs(jw.last_outputs)
    to = _jax_outputs(tw.last_outputs)
    if not _same(jo, to):
        bad.append("output lanes")
    return bad + _diff_planes(jw, tw)


def _sig(sig):
    # the config key names each side's sweep pair, which differ here
    return None if sig is None else {k: v for k, v in sig.items()
                                     if k != "config"}


def _diff_planes(jw, tw) -> list[str]:
    """Where the planes of the two Worlds differ: telemetry lanes,
    signatures (less their config keys), audit stats and ledger."""
    for w in (jw, tw):
        w.audit.drain()
    pairs = {
        "telemetry lanes": (jw._telem_lanes, tw._telem_lanes),
        "workload_signature": (_sig(jw.workload_signature()),
                               _sig(tw.workload_signature())),
        "window_signature": (_sig(jw.window_signature()),
                             _sig(tw.window_signature())),
        "audit oracle": (jw.audit.oracle_stats, tw.audit.oracle_stats),
        "audit probes": (jw.audit.probe_stats, tw.audit.probe_stats),
        "audit ledger": (_ledger(jw), _ledger(tw)),
        "sync-age anchor tick": (jw.sync_age_anchor[0],
                                 tw.sync_age_anchor[0]),
    }
    return [f"{k} {a} != {b}" for k, (a, b) in pairs.items()
            if not _same(a, b)]


MEGA_GAMES = [((8, 1), "ppermute"), ((8, 1), "async"),
              ((4, 2), "ppermute"), ((4, 2), "async")]


@pytest.mark.parametrize("shape,halo_impl", MEGA_GAMES,
                         ids=["1d-ppermute", "1d-async", "4x2-ppermute",
                              "4x2-async"])
def test_mega_world_game_matches_jax(tmp_path, shape, halo_impl):
    from goworld_tpu import entity as jent
    from goworld_tpu import freeze as jfreeze

    sides = {"jax": MegaSide(jent, shape, halo_impl),
             "port": MegaSide(tent, shape, halo_impl)}
    j, t = sides["jax"], sides["port"]
    tx, tz = shape
    wx = (TILE_W if tz == 1 else TILE_W2) * tx
    wz = 100.0 if tz == 1 else TILE_D * tz
    rng = np.random.default_rng(17)
    mob_pos = np.stack([rng.uniform(0, wx, 120), rng.uniform(0, wz, 120)],
                       axis=1)
    diffs: list[str] = []

    def ticks(what, n=1):
        for i in range(n):
            for s in sides.values():
                s.tick()
            diffs.extend(f"{what} tick {i}: {d}" for d in _diff(j, t))

    def spawn(s):
        w = s.w
        for i, (x, z) in enumerate(mob_pos):
            w.arena.create_entity("Mob", pos=(x, 0.0, z), eid=eid(f"mm{i}"),
                                  moving=i % 3 != 0,
                                  attrs={"hp": 10 + i, "name": f"m{i}"})
        for i in range(2):
            # players next to the first tile border, each with a client
            w.arena.create_entity(
                "Player", pos=(wx / tx - 4.0 + 2 * i, 0.0, 20.0 + i),
                eid=eid(f"mp{i}"),
                client=s.pkg.GameClient(1, f"mc{i}".ljust(16, "x"), w))

    for s in sides.values():
        spawn(s)
    ticks("spawn", 3)

    def hop(s):
        w = s.w
        p = w.entities[eid("mp0")]
        p.set_position((wx / tx + 3.0, 0.0, 21.0))   # across the border
        p.attrs["hp"] = 99
        w.entities[eid("mm5")].destroy()
        w.stage_pos_sync_batch(
            np.array([eid("mp1")], "S16"),
            np.array([[wx / tx + 5.0, 0.0, 22.0, 1.0]], np.float32))

    for s in sides.values():
        hop(s)
    ticks("hop", 3)
    p0 = t.w.entities[eid("mp0")]
    assert p0.shard != 0 and p0.attrs["hp"] == 99
    ticks("walk", 4)
    assert diffs == [], diffs[:5]
    t.w.audit.drain()
    assert t.w.audit.oracle_stats["skipped"].get("megaspace", 0) > 0

    # a freeze of each side: the files are byte for byte the same
    paths = {}
    for name, mod, s in (("jax", jfreeze, j), ("port", tfreeze, t)):
        paths[name] = str(tmp_path / f"{name}.dat")
        mod.write_freeze_file(paths[name], mod.freeze_world(s.w))
    with open(paths["jax"], "rb") as f:
        jbytes = f.read()
    with open(paths["port"], "rb") as f:
        assert f.read() == jbytes

    # and a restore into a fresh megaspace World: every entity on the
    # tile of its frozen position, and the restored World ticks
    fresh = MegaSide(tent, shape, halo_impl, arena=False).w
    tfreeze.restore_world(fresh, tfreeze.read_freeze_file(paths["port"]))
    live = [e for e in t.w.entities.values()
            if not e.is_space and not e.destroyed]
    for e in live:
        r = fresh.entities[e.id]
        assert r.space is not None and r.space.is_mega
        assert r.shard == fresh._tile_of(e.position)
        assert r.position == e.position
    fresh.tick()
    assert int(fresh.last_outputs.base.alive_count.sum()) == len(live)
