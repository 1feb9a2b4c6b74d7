"""The port's megaspace against the JAX package's on the CPU: the
migrate functions bit for bit on seeded tiles (quarantine, ``cap``
overflow, too few free slots), ``MegaConfig`` validation, and 6 ticks
of a small world through JAX ``make_mega_tick`` (4 CPU devices under
``shard_map``) against the port's ``make_mega_tick`` on the same state,
carried across by ``interop``, in 1D (4 strips) and 2D (2x2 tiles),
under both halo impls.

Every lane of the state and outputs, every count and float included,
must be bit-exact: the port's random walk computes XLA's cos and sin
(glibc's routine) and its integration rounds ``pos + vel*dt`` once, as
XLA's fused multiply-add does. With a Verlet skin the tiles keep the
stateless sweep over wider cells and carry the cache lane untouched,
as the JAX megaspace does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.parallel import migrate as jmig
from goworld_tpu.parallel.megaspace import MegaConfig as JMega
from goworld_tpu.parallel.megaspace import create_mega_state as jcreate
from goworld_tpu.parallel.megaspace import make_mega_tick as jmake
from goworld_tpu.parallel.mesh import make_mesh
from goworld_tpu.parallel.step import MultiTickInputs as JMulti
from goworld_tpu.scenarios.spec import ScenarioSpec
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel import migrate as tmig
from goworld_tpu_torch.parallel.megaspace import (
    MegaConfig,
    create_mega_state,
    make_mega_tick,
)
from goworld_tpu_torch.parallel.step import MultiTickInputs

def _jax_lanes(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out[f.name] = _jax_lanes(v) if dataclasses.is_dataclass(v) \
            else np.array(v)
    return out


def _compare(got: dict, ref: dict, what):
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for name, g in got.items():
        r = ref[name]
        if isinstance(r, dict):
            _compare(g, r, f"{what} {name}")
            continue
        assert g.shape == r.shape and g.dtype == r.dtype, (
            what, name, g.shape, r.shape, g.dtype, r.dtype)
        # bit for bit, floats included
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(r).view(np.uint8)), (
            what, name, int((g != r).sum()))


# ---------------------------------------------------------------- migrate

N, A, K, N_DEV = 128, 8, 8, 4


def _tile(seed, alive_frac=0.8):
    """One tile's lanes with every field populated."""
    rng = np.random.default_rng(seed)
    cfg = jstate.WorldConfig(capacity=N, attr_width=A,
                             grid=JGrid(radius=10.0, k=K))
    lanes = _jax_lanes(jstate.create_state(cfg, seed=seed))
    lanes["pos"] = rng.uniform(0, 100, (N, 3)).astype(np.float32)
    lanes["yaw"] = rng.uniform(-3, 3, N).astype(np.float32)
    lanes["vel"] = rng.normal(0, 5, (N, 3)).astype(np.float32)
    lanes["alive"] = rng.random(N) < alive_frac
    lanes["npc_moving"] = rng.random(N) < 0.7
    lanes["has_client"] = rng.random(N) < 0.3
    lanes["client_gate"] = rng.integers(-1, 4, N).astype(np.int32)
    lanes["type_id"] = rng.integers(0, 9, N).astype(np.int32)
    lanes["gen"] = rng.integers(0, 50, N).astype(np.int32)
    lanes["hot_attrs"] = rng.random((N, A)).astype(np.float32)
    lanes["attr_dirty"] = rng.integers(0, 2**32, N, dtype=np.uint64) \
        .astype(np.uint32)
    lanes["nbr"] = rng.integers(0, N_DEV * N, (N, K)).astype(np.int32)
    lanes["nbr_cnt"] = rng.integers(0, K, N).astype(np.int32)
    wr = np.full(N, np.inf, np.float32)
    wr[rng.random(N) < 0.2] = 7.5
    lanes["aoi_radius"] = wr
    lanes["dirty"] = rng.random(N) < 0.4
    target = rng.integers(-1, N_DEV + 1, N).astype(np.int32)  # N_DEV: off
    tag = (1000 + np.arange(N)).astype(np.int32)
    return lanes, target, tag


def _both(lanes):
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()})
    return js, interop.state_from_numpy(lanes, device="cpu")


@pytest.mark.parametrize("cap", [64, 3], ids=["roomy", "overflow"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_and_despawn_match_jax(cap, seed):
    lanes, target, tag = _tile(seed)
    js, ts = _both(lanes)
    ref = jmig.pack_emigrants(js, jnp.asarray(target), jnp.asarray(tag),
                              N_DEV, cap)
    got = tmig.pack_emigrants(ts, torch.tensor(target), torch.tensor(tag),
                              N_DEV, cap)
    for name, g, r in zip(("fbuf", "ibuf", "departed", "demand"), got,
                          ref):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert np.array_equal(g, r), name
    demand = got[3].numpy()
    assert demand.sum() > 0
    if cap == 3:
        assert (demand > cap).any()
    jd = jmig.despawn_departed(js, ref[2])
    td = tmig.despawn_departed(ts, got[2])
    _compare(interop.state_to_numpy(td), _jax_lanes(jd), "despawned")


def _arrivals(seed, cap, n_valid):
    """Post-all_to_all buffers: ``n_valid`` valid rows scattered over the
    [N_DEV, cap] grid, zeros elsewhere (as pack_emigrants fills)."""
    rng = np.random.default_rng(seed + 100)
    fbuf = np.zeros((N_DEV, cap, 8 + A), np.float32)
    ibuf = np.zeros((N_DEV, cap, tmig.I_FIELDS), np.int32)
    rows = rng.choice(N_DEV * cap, n_valid, replace=False)
    d, c = rows // cap, rows % cap
    fbuf[d, c] = rng.normal(0, 50, (n_valid, 8 + A))
    ibuf[d, c, tmig.I_TYPE] = rng.integers(0, 9, n_valid)
    ibuf[d, c, tmig.I_HAS_CLIENT] = rng.integers(0, 2, n_valid)
    ibuf[d, c, tmig.I_CLIENT_GATE] = rng.integers(-1, 4, n_valid)
    ibuf[d, c, tmig.I_TAG] = rng.integers(0, 5000, n_valid)
    ibuf[d, c, tmig.I_NPC_MOVING] = rng.integers(0, 2, n_valid)
    ibuf[d, c, tmig.I_VALID] = 1
    return fbuf, ibuf


@pytest.mark.parametrize("alive_frac,n_valid,quarantine", [
    (0.5, 20, False),     # room for everyone
    (0.5, 20, True),      # this tick's departures held back
    (0.97, 20, True),     # too few free slots: some arrivals dropped
    (0.0, 32, False),     # every arrival slot taken, empty tile
], ids=["roomy", "quarantine", "too-few-free", "empty-tile"])
def test_insert_arrivals_matches_jax(alive_frac, n_valid, quarantine):
    cap = 8
    lanes, _, _ = _tile(5, alive_frac)
    js, ts = _both(lanes)
    fbuf, ibuf = _arrivals(5, cap, n_valid)
    q = np.random.default_rng(9).random(N) < 0.3 if quarantine else None
    ref = jmig.insert_arrivals(
        js, jnp.asarray(fbuf), jnp.asarray(ibuf), nbr_sentinel=N_DEV * N,
        quarantine=None if q is None else jnp.asarray(q))
    got = tmig.insert_arrivals(
        ts, torch.tensor(fbuf), torch.tensor(ibuf), nbr_sentinel=N_DEV * N,
        quarantine=None if q is None else torch.tensor(q))
    _compare(interop.state_to_numpy(got[0]), _jax_lanes(ref[0]), "state")
    for name, g, r in zip(("arr_tag", "arr_slot", "arr_n", "dropped"),
                          got[1:], ref[1:]):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and np.array_equal(g.numpy(), r), \
            name
    arr_n, dropped = int(got[3]), int(got[4])
    assert arr_n + dropped == n_valid
    if alive_frac > 0.9:
        assert dropped > 0


# ------------------------------------------------------------ MegaConfig

def _grid(g, **kw):
    base = dict(radius=10.0, extent_x=80.0, extent_z=80.0, k=8,
                cell_cap=16, row_block=16)
    base.update(kw)
    return g(**base)


BAD_CONFIGS = {
    "mesh_shape": dict(n_dev=8, tile_w=60.0, mesh_shape=(3, 2),
                       tile_d=60.0),
    "tile_d": dict(n_dev=8, tile_w=60.0, mesh_shape=(4, 2)),
    "extent_z": dict(n_dev=8, tile_w=60.0, mesh_shape=(4, 2), tile_d=99.0),
    "extent_x": dict(n_dev=4, tile_w=50.0),
    "origin": dict(n_dev=4, tile_w=60.0, grid=dict(origin_x=1.0)),
    "radius_w": dict(n_dev=4, tile_w=60.0,
                     grid=dict(radius=70.0, extent_x=200.0)),
    "radius_d": dict(n_dev=4, tile_w=60.0, mesh_shape=(2, 2), tile_d=5.0,
                     grid=dict(extent_z=25.0)),
    "halo_impl": dict(n_dev=4, tile_w=60.0, halo_impl="bogus"),
    "btree_mix": dict(n_dev=4, tile_w=60.0,
                      world=dict(scenario=ScenarioSpec(
                          name="mix", mix=(("random_walk", 0.5),
                                           ("btree", 0.5))))),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_mega_config_validation_matches_jax(case):
    kw = dict(BAD_CONFIGS[case])
    grid_kw, world_kw = kw.pop("grid", {}), kw.pop("world", {})
    errors = []
    for mega, world, gs in ((JMega, jstate.WorldConfig, JGrid),
                            (MegaConfig, tstate.WorldConfig, GridSpec)):
        cfg = world(capacity=16, grid=_grid(gs, **grid_kw), **world_kw)
        with pytest.raises(ValueError) as exc:
            mega(cfg=cfg, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_mega_config_properties_match_jax():
    for shape, tile_d, ez in ((None, 0.0, 80.0), ((2, 2), 60.0, 80.0)):
        j = JMega(cfg=jstate.WorldConfig(capacity=16,
                                         grid=_grid(JGrid, extent_z=ez)),
                  n_dev=4, tile_w=60.0, mesh_shape=shape, tile_d=tile_d)
        t = MegaConfig(cfg=tstate.WorldConfig(
            capacity=16, grid=_grid(GridSpec, extent_z=ez)), n_dev=4,
            tile_w=60.0, mesh_shape=shape, tile_d=tile_d)
        for prop in ("shape", "is_2d", "world_x", "world_z", "ghost_rows",
                     "gid_sentinel"):
            assert getattr(t, prop) == getattr(j, prop), prop
        for x, z in ((0.0, 0.0), (59.9, 60.0), (130.0, -4.0), (61, 119)):
            assert t.tile_of(x, z) == j.tile_of(x, z)


# ------------------------------------------------------------- the tick

CAP, TILE, RADIUS, TICKS = 256, 60.0, 10.0, 6
ALIVE = 200
N_SYNC, N_HOP = 12, 4


def _configs(two_d, impl, skin=0.0):
    tx, tz = (2, 2) if two_d else (4, 1)
    n_dev = tx * tz
    world_z = TILE * tz if two_d else 2 * TILE
    grid = dict(radius=RADIUS, extent_x=TILE + 2 * RADIUS,
                extent_z=(TILE + 2 * RADIUS) if two_d else world_z, k=32,
                cell_cap=12, row_block=128, sweep_impl="fused",
                sort_impl="pallas", topk_impl="sort", skin=skin,
                precision="off")
    world = dict(capacity=CAP, npc_speed=30.0, turn_prob=0.2,
                 enter_cap=8192, leave_cap=8192, sync_cap=8192,
                 attr_sync_cap=512, input_cap=64)
    mega = dict(n_dev=n_dev, tile_w=TILE, halo_cap=64, migrate_cap=32,
                mesh_shape=(tx, tz) if two_d else None,
                tile_d=TILE if two_d else 0.0, halo_impl=impl)
    jmc = JMega(cfg=jstate.WorldConfig(grid=JGrid(**grid), **world),
                **mega)
    tmc = MegaConfig(cfg=tstate.WorldConfig(grid=GridSpec(**grid),
                                            **world), **mega)
    return jmc, tmc


def _mega_world(mc, seed=0):
    """Tiles of ALIVE movers uniform inside their tile, 10% with a
    client, dirty hot attrs on a few; per tile N_SYNC tile-local syncs
    and N_HOP syncs that teleport an entity to a uniform world position
    (so migrations happen every tick)."""
    rng = np.random.default_rng(seed)
    n_dev, (tx, tz) = mc.n_dev, mc.shape
    lanes = _jax_lanes(jcreate(mc, seed=seed + 2))
    ix = (np.arange(n_dev) // tz)[:, None]
    iz = (np.arange(n_dev) % tz)[:, None]
    pos = lanes["pos"]
    pos[..., 0] = ix * TILE + rng.uniform(0, TILE, (n_dev, CAP))
    pos[..., 2] = (iz * TILE if mc.is_2d else 0) \
        + rng.uniform(0, TILE if mc.is_2d else mc.world_z, (n_dev, CAP))
    alive = np.broadcast_to(np.arange(CAP) < ALIVE, (n_dev, CAP)).copy()
    lanes["alive"] = alive
    lanes["npc_moving"] = alive.copy()
    lanes["has_client"] = (rng.random((n_dev, CAP)) < 0.1) & alive
    lanes["client_gate"][:] = 0
    lanes["hot_attrs"] = rng.random((n_dev, CAP, 8)).astype(np.float32)
    lanes["attr_dirty"][rng.random((n_dev, CAP)) < 0.05] = 0x80000003
    wr = np.full((n_dev, CAP), np.inf, np.float32)
    wr[rng.random((n_dev, CAP)) < 0.1] = 6.0
    lanes["aoi_radius"] = wr

    ic = mc.cfg.input_cap
    idx = np.zeros((n_dev, ic), np.int32)
    vals = np.zeros((n_dev, ic, 4), np.float32)
    n_in = N_SYNC + N_HOP
    for d in range(n_dev):
        idx[d, :n_in] = rng.choice(ALIVE, n_in, replace=False)
        vals[d, :N_SYNC, 0] = ix[d, 0] * TILE + rng.uniform(0, TILE, N_SYNC)
        vals[d, :N_SYNC, 2] = (iz[d, 0] * TILE if mc.is_2d else 0) \
            + rng.uniform(0, TILE if mc.is_2d else mc.world_z, N_SYNC)
        vals[d, N_SYNC:n_in, 0] = rng.uniform(0, mc.world_x, N_HOP)
        vals[d, N_SYNC:n_in, 2] = rng.uniform(0, mc.world_z, N_HOP)
        vals[d, :n_in, 3] = rng.uniform(-3, 3, n_in)
    inputs = dict(
        base=dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.full(n_dev, n_in, np.int32)),
        migrate_target=np.full((n_dev, CAP), -1, np.int32),
        migrate_tag=np.full((n_dev, CAP), -1, np.int32),
    )
    return lanes, inputs


def _jax_state(mc, lanes):
    """A JAX stacked state from numpy lanes (the cache lane, as the JAX
    megaspace creates it, passed as it is)."""
    cache = jcreate(mc, seed=0).aoi_cache
    return jstate.SpaceState(
        **{k: jnp.asarray(v) for k, v in lanes.items()
           if k != "aoi_cache"}, aoi_cache=cache)


@pytest.mark.parametrize("impl", ["ppermute", "async"])
@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_mega_ticks_match_jax(two_d, impl):
    _mega_ticks_match(*_configs(two_d, impl))


def test_mega_skin_ticks_match_jax():
    """A skin of 2 in the 2x2 megaspace: wider cells, the same lists,
    and the cache lane carried as the JAX megaspace carries it."""
    jmc, tmc = _configs(True, "async", skin=2.0)
    assert jcreate(jmc, seed=0).aoi_cache is not None
    _mega_ticks_match(jmc, tmc)


def _mega_ticks_match(jmc, tmc):
    lanes, inputs = _mega_world(jmc)
    lanes["aoi_cache"] = _jax_lanes(jcreate(jmc, seed=0).aoi_cache) \
        if jmc.cfg.grid.skin > 0 else None
    js = _jax_state(jmc, lanes)
    ji = JMulti(base=JInputs(**{k: jnp.asarray(v)
                                for k, v in inputs["base"].items()}),
                migrate_target=jnp.asarray(inputs["migrate_target"]),
                migrate_tag=jnp.asarray(inputs["migrate_tag"]))
    ts = interop.state_from_numpy(lanes, device="cpu")
    ti = interop.multi_inputs_from_numpy(inputs, device="cpu")
    jtick = jmake(jmc, make_mesh(jmc.n_dev))
    ttick = make_mega_tick(tmc, device="cpu")
    arrived, cross = 0, 0
    for t in range(TICKS):
        js, jo = jtick(js, ji, None)
        ts, to = ttick(ts, ti)
        _compare(interop.state_to_numpy(ts), _jax_lanes(js), f"state {t}")
        ref = _jax_lanes(jo)
        ref["base"] = _jax_lanes(jo.base)
        _compare(interop.mega_outputs_to_numpy(to), ref, f"outputs {t}")
        arrived += int(to.arr_n.sum())
        # enter events whose subject lives on another tile: ghosts seen
        ej, en = to.base.enter_j, to.base.enter_n
        for d in range(tmc.n_dev):
            j = ej[d, :min(int(en[d]), ej.shape[1])]
            cross += int(((j // CAP) != d).sum())
    assert arrived > 0, "no migration arrived"
    assert cross > 0, "no tile saw a ghost enter its AOI"
    assert (to.halo_demand <= tmc.halo_cap).all()
    assert int(to.migrate_dropped.sum()) == 0
    assert int(to.global_alive[0]) == tmc.n_dev * ALIVE
    assert int(to.base.sync_n.sum()) > 0


def test_mega_state_and_inputs_match_jax():
    jmc, tmc = _configs(True, "async")
    j = _jax_lanes(jcreate(jmc, seed=4))
    t = interop.state_to_numpy(create_mega_state(tmc, seed=4,
                                                 device="cpu"))
    _compare(t, j, "created")
    ji = JMulti.empty(jmc.cfg, jmc.n_dev)
    ti = MultiTickInputs.empty(tmc.cfg, tmc.n_dev, device="cpu")
    for name in ("migrate_target", "migrate_tag"):
        assert np.array_equal(getattr(ti, name).numpy(),
                              np.asarray(getattr(ji, name)))
    for f in dataclasses.fields(ti.base):
        a = getattr(ti.base, f.name).numpy()
        b = np.asarray(getattr(ji.base, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def test_mega_config_is_the_multichip_bench_world():
    """``workload.mega_config`` at ``build_mega(2**20)`` tiled for 4
    devices derives its numbers."""
    from goworld_tpu_torch.workload import mega_config

    mc = mega_config(1 << 20, 4)
    g = mc.cfg.grid
    assert mc.shape == (2, 2) and mc.is_2d
    assert mc.cfg.capacity == 294_912
    assert mc.tile_w == mc.tile_d == 14_780.0
    assert g.extent_x == g.extent_z == 14_880.0
    assert (mc.halo_cap, mc.ghost_rows, mc.migrate_cap) == (4096, 16_384,
                                                           256)
    assert (g.radius, g.k, g.cell_cap, g.row_block, g.skin) == (
        50.0, 32, 12, 65_536, 0.0)
    assert (g.sweep_impl, g.sort_impl, mc.halo_impl) == ("fused", "pallas",
                                                        "async")


@pytest.mark.parametrize("n_dev", [4, 3], ids=["2x2", "1d"])
def test_mega_world_places_movers_in_their_tiles(n_dev):
    from goworld_tpu_torch.workload import mega_config, mega_world

    n_total = 4096
    mc = mega_config(n_total, n_dev)
    st, inputs = mega_world(mc, n_total, seed=1, device="cpu")
    alive = st.alive.numpy()
    per = n_total // n_dev
    assert (alive.sum(1) == per).all() and alive[:, :per].all()
    assert np.array_equal(st.npc_moving.numpy(), alive)
    assert not (st.has_client.numpy() & ~alive).any()
    pos = st.pos.numpy()
    tz = mc.shape[1]
    for d in range(n_dev):
        x, z = pos[d, :per, 0], pos[d, :per, 2]
        assert ((x >= d // tz * mc.tile_w)
                & (x < (d // tz + 1) * mc.tile_w)).all()
        z0 = d % tz * mc.tile_d if mc.is_2d else 0.0
        assert ((z >= z0) & (z < z0 + (mc.tile_d if mc.is_2d
                                       else mc.world_z))).all()
        n_sync = int(inputs.base.pos_sync_n[d])
        idx = inputs.base.pos_sync_idx[d, :n_sync].numpy()
        assert len(set(idx.tolist())) == n_sync and (idx < per).all()
    assert len({tuple(k) for k in st.rng.tolist()}) == n_dev
    with pytest.raises(ValueError, match="capacity"):
        mega_world(mc, 4 * n_total, seed=1, device="cpu")
