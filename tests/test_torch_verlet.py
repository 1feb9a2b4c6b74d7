"""The port's Verlet skin reuse against the JAX package's, on the CPU.

Each case of ``tests/test_aoi_verlet.py`` runs here on both packages
from the same numpy inputs, each side carrying its own cache: every
output of ``grid_neighbors_verlet`` (lists, counts, flags, the four
gauges, the rebuild flag, the skin slack) and every lane of the new
cache must be bit-equal between the two, and the reference's own
contract is held on the port (bit parity with the stateless sweep on
every tick, each rebuild trigger on its exact tick). The whole tick
(``make_tick`` with a skin) is held lane for lane over 48 ticks that
include rebuild and reuse ticks; the World exports the gauges; the
gated plain sweep writes its buffers exactly when its gate is open, and
a closed gate's sweep returns empty lists.

Small worlds: 500 entities (64 in the overflow case), 256-slot ticks.
No tolerance anywhere: every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.core.step import make_tick as jmake_tick
from goworld_tpu.ops import aoi as jaoi
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.core.step import make_tick
from goworld_tpu_torch.ops import aoi as taoi

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 500
EXTENT = 300.0


def _grid(skin, impl="ranges", **kw):
    base = dict(radius=25.0, extent_x=EXTENT, extent_z=EXTENT, k=48,
                cell_cap=48, row_block=128, verlet_cap=96,
                sweep_impl=impl)
    base.update(kw)
    return dict(base, skin=skin)


def _specs(skin, impl="ranges", **kw):
    g = _grid(skin, impl, **kw)
    return jaoi.GridSpec(**g), taoi.GridSpec(**g)


def _np(x):
    """Nested numpy of an output: tensors, JAX arrays, caches, tuples.
    uint32 words (the q16 cache) are read as their int32 bits."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, (
            what, a.shape, b.shape, a.dtype, b.dtype)
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8)), what


def _world(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((N, 3), np.float32)
    pos[:, 0] = rng.random(N) * EXTENT
    pos[:, 2] = rng.random(N) * EXTENT
    alive = rng.random(N) < 0.9
    fb = rng.integers(0, 4, N).astype(np.int32)
    return rng, pos, alive, fb


class Pair:
    """One Verlet world on both packages: each side's own cache, every
    call's outputs and new caches compared."""

    def __init__(self, skin, impl="ranges", n=N, **kw):
        self.jspec, self.tspec = _specs(skin, impl, **kw)
        self.jcache = jaoi.init_verlet_cache(self.jspec, n)
        self.tcache = taoi.init_verlet_cache(self.tspec, n, "cpu")
        _same(_np(self.tcache), _np(self.jcache), "init")

    def __call__(self, pos, alive, fb=None, wr=None, with_stats=True):
        jo = jaoi.grid_neighbors_verlet(
            self.jspec, jnp.asarray(pos), jnp.asarray(alive), self.jcache,
            watch_radius=None if wr is None else jnp.asarray(wr),
            flag_bits=None if fb is None else jnp.asarray(fb),
            with_stats=with_stats)
        to = taoi.grid_neighbors_verlet(
            self.tspec, torch.tensor(pos), torch.tensor(alive),
            self.tcache,
            watch_radius=None if wr is None else torch.tensor(wr),
            flag_bits=None if fb is None else torch.tensor(fb),
            with_stats=with_stats)
        _same(_np(to), _np(jo), "verlet")
        self.jcache, self.tcache = jo[4], to[4]
        return to


def _skinless(spec, pos, alive, fb=None, wr=None):
    """The port's stateless sweep (the reference's parity contract)."""
    flat = dataclasses.replace(spec, skin=0.0)
    return taoi.grid_neighbors_flags(
        flat, torch.tensor(pos), torch.tensor(alive),
        watch_radius=None if wr is None else torch.tensor(wr),
        flag_bits=torch.tensor(fb if fb is not None
                               else np.zeros(len(alive), np.int32)),
        with_stats=True)


def _holds_parity(out, ref):
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["ranges", "fused", "shift", "cellrow"])
def test_random_walk_zero_divergence_with_reuse(impl):
    """30 small-step ticks: the port equals JAX every tick, its lists,
    counts and flags equal the per-tick sweep's, and most ticks reuse
    the cache."""
    rng, pos, alive, fb = _world(1)
    kw = dict(cell_cap=24) if impl == "fused" else {}
    pair = Pair(6.0, impl, **kw)
    rebuilds = 0
    for _ in range(30):
        out = pair(pos, alive, fb)
        rebuilds += int(out[5])
        _holds_parity(out, _skinless(pair.tspec, pos, alive, fb))
        step = rng.normal(0, 0.35, (N, 2)).astype(np.float32)
        pos[:, 0] = np.clip(pos[:, 0] + step[:, 0], 0, EXTENT - 1e-3)
        pos[:, 2] = np.clip(pos[:, 2] + step[:, 1], 0, EXTENT - 1e-3)
        fb = rng.integers(0, 4, N).astype(np.int32)
    assert 1 <= rebuilds < 15, rebuilds


def test_teleport_forces_rebuild_and_stays_exact():
    rng, pos, alive, fb = _world(2)
    pair = Pair(6.0)
    assert int(pair(pos, alive, fb)[5]) == 1
    pos[7, 0] = (pos[7, 0] + EXTENT / 2) % EXTENT
    out = pair(pos, alive, fb)
    assert int(out[5]) == 1 and float(out[6]) < 0
    _holds_parity(out, _skinless(pair.tspec, pos, alive, fb))


def test_alive_change_forces_rebuild_and_stays_exact():
    rng, pos, alive, fb = _world(3)
    pair = Pair(6.0)
    pair(pos, alive, fb)
    dead = np.nonzero(alive)[0][3]
    born = np.nonzero(~alive)[0][0]
    alive = alive.copy()
    alive[dead] = False
    alive[born] = True
    out = pair(pos, alive, fb)
    assert int(out[5]) == 1
    _holds_parity(out, _skinless(pair.tspec, pos, alive, fb))
    assert not bool((out[0] == int(dead)).any())


def test_watch_radius_change_forces_rebuild():
    rng, pos, alive, fb = _world(4)
    pair = Pair(6.0)
    wr = np.full(N, np.inf, np.float32)
    pair(pos, alive, fb, wr, with_stats=False)
    wr2 = wr.copy()
    wr2[np.nonzero(alive)[0][0]] = 5.0
    out = pair(pos, alive, fb, wr2, with_stats=False)
    assert int(out[5]) == 1
    _holds_parity(out, _skinless(pair.tspec, pos, alive, fb, wr2))
    # unchanged radii reuse the cache
    assert int(pair(pos, alive, fb, wr2, with_stats=False)[5]) == 0


def test_rebuild_every_max_backstop():
    rng, pos, alive, fb = _world(5)
    pair = Pair(50.0, rebuild_every_max=4)   # displacement never trips
    pattern = [int(pair(pos, alive, fb, with_stats=False)[5])
               for _ in range(9)]
    assert pattern == [1, 0, 0, 0, 1, 0, 0, 0, 1]


def test_candidate_overflow_fires_over_k_gauge():
    """A verlet_cap too small for one dense blob: the over-k gauge
    reports it, on both packages alike."""
    rng = np.random.default_rng(6)
    m = 64
    pos = np.zeros((m, 3), np.float32)
    pos[:, 0] = 50.0 + rng.random(m) * 4.0
    pos[:, 2] = 50.0 + rng.random(m) * 4.0
    pair = Pair(5.0, n=m, radius=25.0, extent_x=100.0, extent_z=100.0,
                k=8, cell_cap=64, row_block=64, verlet_cap=16)
    out = pair(pos, np.ones(m, bool), np.zeros(m, np.int32))
    assert int(out[3][1]) > 0 and int(out[4].over_v_rows) > 0


def _tick_world(skin, precision, seed=8):
    """A 256-slot world on both packages: 120 movers (10% with a
    client), 16 client syncs a tick with repeated slots."""
    g = _grid(skin, "fused", row_block=256, cell_cap=24,
              precision=precision)
    world = dict(capacity=256, npc_speed=5.0, enter_cap=4096,
                 leave_cap=4096, sync_cap=4096, attr_sync_cap=256,
                 input_cap=32, delta_rows_cap=256)
    jcfg = jstate.WorldConfig(grid=jaoi.GridSpec(**g), **world)
    tcfg = tstate.WorldConfig(grid=taoi.GridSpec(**g), **world)
    rng = np.random.default_rng(seed)
    js = jstate.create_state(jcfg, seed=9)
    ts = tstate.create_state(tcfg, seed=9, device="cpu")
    for s in range(120):
        kw = dict(pos=(rng.random() * EXTENT, 0.0, rng.random() * EXTENT),
                  npc_moving=True, has_client=s % 10 == 0)
        js = jstate.spawn(js, s, **kw)
        ts = tstate.spawn(ts, s, **kw)
    idx = np.zeros(32, np.int32)
    idx[:16] = rng.integers(0, 130, 16)          # repeats, and dead slots
    vals = np.zeros((32, 4), np.float32)
    vals[:16, 0] = rng.random(16) * EXTENT
    vals[:16, 2] = rng.random(16) * EXTENT
    ins = dict(pos_sync_idx=idx, pos_sync_vals=vals,
               pos_sync_n=np.asarray(16, np.int32))
    return (jcfg, tcfg, js, ts, JInputs(**{k: jnp.asarray(v)
                                           for k, v in ins.items()}),
            interop.inputs_from_numpy(ins, device="cpu"))


@pytest.mark.parametrize("precision", ["off", "q16"])
def test_tick_body_bit_parity_over_rebuild_and_reuse(precision):
    """make_tick with the skin on both packages for 48 ticks: every
    lane of the state (the cache's included), every output lane. The
    syncs land on the same points each tick (a jump once, then the
    cache holds), a despawn at tick 20 forces a rebuild, and the walk
    forces displacement rebuilds. The port's skinless tick, run beside
    it, gives the same lists on every tick."""
    jcfg, tcfg, js, ts, ji, ti = _tick_world(2.0, precision)
    flat = dataclasses.replace(tcfg, grid=dataclasses.replace(
        tcfg.grid, skin=0.0))
    ts0 = ts.replace(aoi_cache=None)
    jtick, ttick = jmake_tick(jcfg), make_tick(tcfg, device="cpu")
    ttick0 = make_tick(flat, device="cpu")
    rebuilt = []
    for t in range(48):
        if t == 20:
            js, ts = jstate.despawn(js, 3), tstate.despawn(ts, 3)
            ts0 = tstate.despawn(ts0, 3)
        js, jo = jtick(js, ji, None)
        ts, to = ttick(ts, ti)
        ts0, to0 = ttick0(ts0, ti)
        _same(_np(interop.state_to_numpy(ts)),
              _np({f.name: getattr(js, f.name)
                   for f in dataclasses.fields(js)
                   if getattr(js, f.name) is not None}), f"state {t}")
        _same(_np(interop.outputs_to_numpy(to)),
              _np({f.name: getattr(jo, f.name)
                   for f in dataclasses.fields(jo)}), f"outputs {t}")
        assert torch.equal(ts.nbr, ts0.nbr) and torch.equal(ts.nbr_cnt,
                                                            ts0.nbr_cnt)
        for f in ("enter_n", "leave_n", "sync_n", "delta_rows_n"):
            assert torch.equal(getattr(to, f), getattr(to0, f)), (t, f)
        rebuilt.append(int(to.aoi_rebuilt))
    assert rebuilt[0] == 1 and rebuilt[20] == 1
    assert 3 <= sum(rebuilt) < 24, rebuilt
    if precision == "q16":
        assert ts.vel.dtype == torch.bfloat16
        assert ts.aoi_cache.cand.shape == (256, taoi.packed_cand_words(
            tcfg.grid.verlet_cap_eff))


def test_world_exports_rebuild_gauges():
    """A one-Space World with a skin exports the cadence gauges, and
    they carry the tick's real values."""
    from goworld_tpu_torch.entity import Entity, Space, World

    cfg = tstate.WorldConfig(
        capacity=64,
        grid=taoi.GridSpec(radius=10.0, extent_x=100.0, extent_z=100.0,
                           k=8, cell_cap=32, row_block=64, skin=3.0))
    w = World(cfg, device="cpu")
    w.register_entity("Mob", type("Mob", (Entity,), {}))
    w.register_space("Sp", type("Sp", (Space,), {}))
    w.create_nil_space()
    sp = w.create_space("Sp")
    for i in range(5):
        sp.create_entity("Mob", pos=(50 + i, 0, 50))
    seen = []
    for _ in range(3):
        w.tick()
        seen.append(w.op_stats["aoi_rebuild_last"])
    assert seen[0] == 1 and seen[2] == 0     # built once, then reused
    assert w.op_stats["aoi_skin_slack"] == pytest.approx(1.5)


@pytest.mark.parametrize("with_stats", [True, False])
def test_gated_plain_sweep_writes_only_when_open(with_stats):
    """The fused sweep's plain version under a gate (the dataflow the
    kernel has on the card): gate 1 writes what the ungated call
    returns, gate 0 leaves the buffers byte for byte."""
    rng, pos, alive, fb = _world(7)
    spec = taoi.GridSpec(**_grid(4.0, "fused", cell_cap=24, k=48))
    p = torch.tensor(pos)
    fh = taoi.front_half(spec, p, torch.tensor(alive), None, None, None,
                         with_stats, reach_pad=spec.skin)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, p, fh.reach, spec.k,
            spec.cell_cap, fh.code, with_stats)
    top, dem = taoi.sweep_fused_cuda(*args)
    out = (torch.full_like(top, 7), torch.full((N,), 5, dtype=torch.int32))
    before = [t.clone() for t in out]
    shut = torch.zeros((), dtype=torch.int32)
    got = taoi.sweep_fused_cuda(*args, gate=shut, out=out)
    assert torch.equal(out[0], before[0]) and torch.equal(out[1], before[1])
    assert got[0] is out[0]
    got = taoi.sweep_fused_cuda(*args, gate=shut + 1, out=out)
    assert torch.equal(out[0], top) and got[0] is out[0]
    if with_stats:
        assert torch.equal(out[1], dem) and got[1] is out[1]
    else:
        assert got[1] is None and torch.equal(out[1], before[1])


@pytest.mark.parametrize("open_", [0, 1])
def test_gated_sweep_returns_empty_lists_when_closed(open_):
    """``_sweep`` under a gate: open, it returns what the ungated sweep
    returns; closed, empty lists (every id the sentinel, counts and
    demand 0) that a caller selecting with the gate discards."""
    rng, pos, alive, _fb = _world(9)
    spec = taoi.GridSpec(**_grid(4.0, "fused", cell_cap=24, k=48))
    p, a = torch.tensor(pos), torch.tensor(alive)
    gate = torch.full((), open_, dtype=torch.int32)
    nbr, cnt, _fl, stats = taoi._sweep(spec, p, a, None, None, None,
                                       with_stats=True, reach_pad=4.0,
                                       gate=gate)
    if open_:
        want = taoi._sweep(spec, p, a, None, None, None, with_stats=True,
                           reach_pad=4.0)
        assert torch.equal(nbr, want[0]) and torch.equal(cnt, want[1])
        assert [int(x) for x in stats] == [int(x) for x in want[3]]
        assert int(cnt.sum()) > 0
    else:
        assert bool((nbr == N).all()) and not bool(cnt.any())
        assert int(stats[0]) == 0 and int(stats[1]) == 0


def test_verlet_refuses_what_the_reference_refuses():
    spec = taoi.GridSpec(**_grid(0.0))
    with pytest.raises(ValueError, match="skin > 0"):
        taoi.grid_neighbors_verlet(
            spec, torch.zeros(4, 3), torch.ones(4, dtype=torch.bool),
            taoi.init_verlet_cache(spec, 4, "cpu"))
