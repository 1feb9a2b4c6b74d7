"""The port's AOI sweep against the JAX package's on the same numpy
inputs: grid_neighbors_flags under fused+pallas (the CUDA kernels' plain
versions on the CPU) against JAX's fused+pallas (Pallas in interpret
mode) and ranges+argsort, bit for bit in nbr, cnt, flags and the four
gauges; one check against the brute-force oracle; GridSpec knobs and
properties mean the same on both sides. The fused kernel's cell-order
walk (every query row visited once, the megaspace's Q < n included) and
a lane-level model of its selection (ballot compaction, the 15-step
bitonic network, the overflow rounds) against a sort."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.ops import aoi as jaoi
from goworld_tpu_torch.ops import aoi as taoi

N = 600
EXTENT = 300.0
RADIUS = 25.0


def _world(seed=0, clump=True):
    rng = np.random.default_rng(seed)
    pos = np.zeros((N, 3), np.float32)
    # a dense clump beside a uniform spread: some cells overflow small
    # caps, most do not
    pos[:, 0] = rng.uniform(0, EXTENT, N)
    pos[:, 2] = rng.uniform(0, EXTENT, N)
    if clump:
        pos[:80, 0] = rng.uniform(100, 120, 80)
        pos[:80, 2] = rng.uniform(100, 120, 80)
    pos[:, 1] = rng.uniform(-5, 5, N)
    alive = rng.random(N) < 0.9
    wr = np.full(N, np.inf, np.float32)
    wr[rng.random(N) < 0.1] = 0.0          # out of AOI entirely
    wr[rng.random(N) < 0.2] = 12.5         # finite watch radius
    fb = rng.integers(0, 4, N).astype(np.int32)
    return pos, alive, wr, fb


POS, ALIVE, WR, FB = _world()

# (k, cell_cap): roomy caps, then caps the clump overflows
REGIMES = {"roomy": (32, 12), "overflow": (8, 2)}


def _specs(regime, topk):
    k, cc = REGIMES[regime]
    kw = dict(radius=RADIUS, extent_x=EXTENT, extent_z=EXTENT, k=k,
              cell_cap=cc, row_block=256, topk_impl=topk,
              sweep_impl="fused", sort_impl="pallas")
    return jaoi.GridSpec(**kw), taoi.GridSpec(**kw)


def _port(spec, watch=True):
    out = taoi.grid_neighbors_flags(
        spec, torch.tensor(POS), torch.tensor(ALIVE),
        watch_radius=torch.tensor(WR) if watch else None,
        flag_bits=torch.tensor(FB), with_stats=True)
    return [o.numpy() for o in out[:3]] + [[int(s) for s in out[3]]]


def _jax(spec, watch=True):
    out = jaoi.grid_neighbors_flags(
        spec, jnp.asarray(POS), jnp.asarray(ALIVE),
        watch_radius=jnp.asarray(WR) if watch else None,
        flag_bits=jnp.asarray(FB), with_stats=True)
    return [np.asarray(o) for o in out[:3]] + [[int(s) for s in out[3]]]


def _assert_same(got, ref):
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert np.array_equal(g, r)
    assert got[3] == ref[3]


@pytest.mark.parametrize("topk", ["sort", "exact", "f32"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_fused_pallas_matches_jax_fused_and_ranges(regime, topk):
    jspec, tspec = _specs(regime, topk)
    got = _port(tspec)
    _assert_same(got, _jax(jspec))
    _assert_same(got, _jax(dataclasses.replace(
        jspec, sweep_impl="ranges", sort_impl="argsort")))
    if regime == "overflow":
        assert got[3][1] > 0 and got[3][3] > 0  # both caps overflowed


@pytest.mark.parametrize("sort_impl", ["argsort", "counting"])
def test_port_ranges_matches_jax_ranges(sort_impl):
    jspec, tspec = _specs("overflow", "sort")
    jspec = dataclasses.replace(jspec, sweep_impl="ranges",
                                sort_impl=sort_impl)
    tspec = dataclasses.replace(tspec, sweep_impl="ranges",
                                sort_impl=sort_impl)
    _assert_same(_port(tspec, watch=False), _jax(jspec, watch=False))


@pytest.mark.parametrize("watch", [True, False])
@pytest.mark.parametrize("sort_impl", ["argsort", "counting", "pallas"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_port_table_matches_jax_table(regime, sort_impl, watch):
    """``sweep_impl="table"`` (the per-cell table, then the window read
    from it) against the JAX package's table sweep, under every sort."""
    jspec, tspec = _specs(regime, "sort")
    jspec = dataclasses.replace(jspec, sweep_impl="table",
                                sort_impl="argsort")
    tspec = dataclasses.replace(tspec, sweep_impl="table",
                                sort_impl=sort_impl)
    _assert_same(_port(tspec, watch), _jax(jspec, watch))


@pytest.mark.parametrize("topk", ["sort", "exact", "f32"])
def test_port_table_equals_ranges_and_fused_below_caps(topk):
    """Below the caps every impl gives the same lists, flags and
    gauges: the table equals ``ranges`` and ``fused`` bit for bit."""
    pos, alive, wr, fb = _world(1, clump=False)
    _, tspec = _specs("roomy", topk)

    def run(impl):
        out = taoi.grid_neighbors_flags(
            dataclasses.replace(tspec, sweep_impl=impl),
            torch.tensor(pos), torch.tensor(alive),
            watch_radius=torch.tensor(wr), flag_bits=torch.tensor(fb),
            with_stats=True)
        return [o.numpy() for o in out[:3]] + [[int(s) for s in out[3]]]

    got = run("table")
    assert got[3][1] == 0 and got[3][3] == 0
    for impl in ("ranges", "fused"):
        _assert_same(got, run(impl))


def test_port_table_batched_matches_each_space():
    """The table under a leading Space axis: each Space's lists as its
    own sweep's."""
    _, tspec = _specs("overflow", "sort")
    tspec = dataclasses.replace(tspec, sweep_impl="table",
                                sort_impl="counting")
    worlds = [_world(s) for s in (0, 1)]
    stack = [torch.tensor(np.stack([w[i] for w in worlds]))
             for i in range(4)]
    got = taoi.grid_neighbors_flags(tspec, stack[0], stack[1],
                                    watch_radius=stack[2],
                                    flag_bits=stack[3], with_stats=True)
    for s, w in enumerate(worlds):
        one = taoi.grid_neighbors_flags(
            tspec, *(torch.tensor(x) for x in w[:2]),
            watch_radius=torch.tensor(w[2]), flag_bits=torch.tensor(w[3]),
            with_stats=True)
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a[s], b)
        assert [int(x[s]) for x in got[3]] == [int(x) for x in one[3]]


def test_fused_below_caps_matches_oracle():
    pos, alive, wr, fb = _world(1, clump=False)
    _, tspec = _specs("roomy", "sort")
    nbr, cnt, _, stats = taoi.grid_neighbors_flags(
        tspec, torch.tensor(pos), torch.tensor(alive),
        watch_radius=torch.tensor(wr), flag_bits=torch.tensor(fb),
        with_stats=True)
    assert int(stats[1]) == 0 and int(stats[3]) == 0
    oracle = taoi.neighbors_oracle(pos, alive, RADIUS, wr)
    assert oracle == jaoi.neighbors_oracle(pos, alive, RADIUS, wr)
    nbr, cnt = nbr.numpy(), cnt.numpy()
    assert sum(len(s) for s in oracle) > N
    assert [set(r[r < N].tolist()) for r in nbr] == oracle
    assert cnt.tolist() == [len(s) for s in oracle]


def test_grid_neighbors_without_flags_matches_jax():
    kw = dict(radius=RADIUS, extent_x=EXTENT, extent_z=EXTENT, k=16,
              cell_cap=8, row_block=128, sweep_impl="fused",
              sort_impl="pallas")
    ref = jaoi.grid_neighbors(jaoi.GridSpec(**kw), jnp.asarray(POS),
                              jnp.asarray(ALIVE), 500, jnp.asarray(WR))
    got = taoi.grid_neighbors(taoi.GridSpec(**kw), torch.tensor(POS),
                              torch.tensor(ALIVE), 500, torch.tensor(WR))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


SPECS = [
    dict(radius=50.0, extent_x=29560.0, extent_z=29560.0, k=32,
         cell_cap=12),
    dict(radius=7.0, origin_x=-3.0, extent_x=100.0, extent_z=33.0),
    dict(radius=25.0, skin=4.0, extent_x=300.0, extent_z=300.0),
    dict(radius=50.0, precision="q16", extent_x=4096.0, extent_z=2000.0),
]
PROPS = ["cell_size", "cells_x", "cells_z", "quant_step",
         "quant_cell_shift", "quant_bits", "verlet_cap_eff"]


@pytest.mark.parametrize("kw", SPECS)
def test_gridspec_properties_match(kw):
    j, t = jaoi.GridSpec(**kw), taoi.GridSpec(**kw)
    assert [getattr(t, p) for p in PROPS] == [getattr(j, p) for p in PROPS]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("kw", [
    dict(topk_impl="nope"), dict(sweep_impl="nope"),
    dict(sort_impl="nope"), dict(skin=-1.0), dict(verlet_cap=3),
    dict(rebuild_every_max=-1), dict(precision="q8"),
    dict(precision="q16", origin_x=1.0),
    dict(precision="q16", extent_x=1e7),
    dict(skin=1.0, cell_cap=1),
])
def test_gridspec_validation_matches(kw):
    full = dict(radius=25.0, k=16, cell_cap=4, extent_x=300.0,
                extent_z=300.0)
    full.update(kw)
    with pytest.raises(ValueError) as jerr:
        jaoi.GridSpec(**full)
    with pytest.raises(ValueError) as terr:
        taoi.GridSpec(**full)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", ["s_w_float", "lo_int64", "pos_strided",
                                 "lo_shape"])
def test_sweep_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, spec = _specs("roomy", "sort")
    pos, alive = torch.tensor(POS), torch.tensor(ALIVE)
    fh = taoi.front_half(spec, pos, alive, None, None, torch.tensor(FB))
    args = dict(s_xz=fh.s_xz, s_w=fh.s_w, lo=fh.lo, hi=fh.hi, pos=pos,
                reach=fh.reach)
    if bad == "s_w_float":
        args["s_w"] = fh.s_w.view(torch.float32)
    elif bad == "lo_int64":
        args["lo"] = fh.lo.long()
    elif bad == "pos_strided":
        args["pos"] = torch.cat([pos, pos], 1)[:, ::2]
    else:
        args["lo"] = fh.lo[:, :2].contiguous()
    with pytest.raises((TypeError, ValueError)):
        taoi.sweep_fused_cuda(k=spec.k, cc=spec.cell_cap, code=fh.code,
                              with_stats=False, **args)


def _walk_rows(fh, n):
    """The rows the kernel's work items 0..n-1 visit, in order."""
    return (fh.s_w[:n] >> fh.code[0]).tolist()


@pytest.mark.parametrize("flags", [True, False], ids=["id_shift2",
                                                       "id_shift0"])
def test_cell_order_walk_visits_every_row_once_bench(flags):
    from goworld_tpu_torch.workload import bench_world, slice_config

    cfg = slice_config(1024)
    st, _ = bench_world(cfg, seed=3, device="cpu")
    alive = st.alive.clone()
    alive[::7] = False                   # dead slots sort into the dump bin
    fb = st.has_client.to(torch.int32) << 1 if flags else None
    fh = taoi.front_half(cfg.grid, st.pos, alive, None, st.aoi_radius, fb)
    assert fh.code[0] == (2 if flags else 0)
    rows = _walk_rows(fh, 1024)
    assert sorted(rows) == list(range(1024))
    # the walk is in cell order: rows of one cell are consecutive items
    srow = fh.srow[torch.tensor(rows)]
    assert bool((srow[1:] >= srow[:-1]).all())


@pytest.mark.parametrize("flags", [True, False], ids=["id_shift2",
                                                       "id_shift0"])
def test_cell_order_walk_visits_every_row_once_megaspace_tile(flags):
    from goworld_tpu_torch.parallel import halo
    from goworld_tpu_torch.parallel.megaspace import tile_shifts
    from goworld_tpu_torch.workload import mega_config, mega_world

    mc = mega_config(4096, 4)
    g, n = mc.cfg.grid, mc.cfg.capacity
    st, _ = mega_world(mc, 4096, seed=2, device="cpu")
    dirty = st.alive.clone()
    visible = st.alive & (st.aoi_radius > 0.0)
    gpos, _, gdirty, gvalid, _, _ = halo.exchange_halo_2d(
        mc.shape, n, st.pos, st.yaw, dirty, visible, mc.tile_w, mc.tile_d,
        g.radius, mc.halo_cap, impl="async")
    assert int(gvalid[0].sum()) > 0     # tile 0 has ghosts
    pos_ext = torch.cat([st.pos[0], gpos[0]]) - tile_shifts(mc, "cpu")[0]
    n_ext = pos_ext.shape[0]
    alive_ext = torch.cat([st.alive[0], gvalid[0]])
    fb = torch.cat([dirty[0], gdirty[0]]).to(torch.int32) if flags else None
    wr = torch.cat([st.aoi_radius[0],
                    torch.full((n_ext - n,), float("inf"))])
    fh = taoi.front_half(g, pos_ext, alive_ext, n, wr, fb)
    assert fh.lo.shape[0] == n < n_ext
    rows = _walk_rows(fh, n_ext)
    assert sorted(rows) == list(range(n_ext))
    queries = [r for r in rows if r < n]   # what the kernel does not skip
    assert sorted(queries) == list(range(n))


def _lane_select(keys, valid, k, invalid):
    """The kernel's selection for one row, lane by lane. ``keys`` and
    ``valid`` are [PER, 32]: candidate lane c = lane + 32 j sits at
    [j, lane]. Returns (top keys [k], demand, bitonic steps run)."""
    per = keys.shape[0]
    lane = torch.arange(32)
    demand = 0
    packed = torch.full((32,), invalid, dtype=keys.dtype)
    for j in range(per):                      # ballot compaction
        m = valid[j]
        at = demand + torch.cumsum(m.long(), 0) - m.long()  # popc(m & lt)
        put = m & (at < 32)
        packed[at[put]] = keys[j][put]
        demand += int(m.sum())
    out = torch.full((k,), invalid, dtype=keys.dtype)
    steps = 0
    if demand <= 32:
        x = torch.where(lane < demand, packed, invalid)
        size = 2
        while size <= 32 and size // 2 < demand:   # the kernel's early stop
            stride = size >> 1
            while stride > 0:
                y = x[lane ^ stride]              # __shfl_xor_sync
                up = (lane & size) == 0
                lower = (lane & stride) == 0
                x = torch.where(lower == up, torch.minimum(x, y),
                                torch.maximum(x, y))
                steps += 1
                stride >>= 1
            size <<= 1
        out[:min(k, 32)] = x[:min(k, 32)]
        return out, demand, steps
    regs = torch.where(valid, keys, invalid)
    for r in range(k):                        # the overflow rounds
        m = int(regs.min())
        if m == invalid:
            break
        out[r] = m
        regs = torch.where(regs == m, invalid, regs)
    return out, demand, steps


@pytest.mark.parametrize("k", [1, 8, 32, 64])
@pytest.mark.parametrize("demand", [0, 1, 2, 5, 16, 17, 31, 32, 33, 108])
@pytest.mark.parametrize("invalid", [2**31 - 1, 0x7F800000],
                         ids=["i32", "f32"])
def test_lane_selection_model_equals_sort(demand, k, invalid):
    rng = np.random.default_rng(demand * 100 + k)
    per, lanes = 4, 108                       # cell_cap 12: 9 * 12 lanes
    keys = np.full(per * 32, invalid, np.int64)
    valid = np.zeros(per * 32, bool)
    at = rng.choice(lanes, demand, replace=False)
    # unique valid keys below the invalid one, as (qd << 23) | word
    vals = rng.choice(254 << 23, demand, replace=False)
    keys[at], valid[at] = vals, True
    # lanes past a run's end hold the invalid key too
    keys_t = torch.tensor(keys.reshape(per, 32))
    valid_t = torch.tensor(valid.reshape(per, 32))
    got, dem, steps = _lane_select(keys_t, valid_t, k, invalid)
    want = torch.sort(torch.tensor(keys)).values[:k]
    want = torch.cat([want, torch.full((k - want.shape[0],), invalid,
                                       dtype=want.dtype)])
    assert dem == demand
    # stages of 2, 4, 8, 16, 32 lanes: 1 + 2 + 3 + 4 + 5 steps, cut after
    # the first whose blocks hold all the valid keys
    want_steps = {0: 0, 1: 0, 2: 1, 5: 6, 16: 10, 17: 15, 31: 15, 32: 15}
    assert steps == want_steps.get(demand, 0)
    assert torch.equal(got, want)
