"""Several Spaces in one tick: the port's batched step against the JAX
package's vmapped local step (``entity/manager.py`` ``_make_local_tick(cfg,
S)``), on the CPU.

The same numpy-seeded Spaces, stacked on a leading ``[S]`` axis, go
through both; every state lane and output lane (the per-Space overflow
counters and the rng keys included) must be bit-exact, tick after tick.
Under ``fused``/``pallas`` the port runs the kernels' plain versions and
the JAX side its Pallas kernels in interpret mode. Beside that: one Space
past ``enter_cap`` while the others are not, an empty Space and one
whose every entity sorts into the dump bin, the batched step against S
single-Space ticks of the port, the batched plain kernel versions against
per-Space calls, and q16 under batching.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.entity.manager import _make_local_tick as jlocal_tick
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.core.step import TickInputs, make_tick
from goworld_tpu_torch.ops import aoi
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
)
from goworld_tpu_torch.parallel.mesh import tile_view

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 256
TICKS = 5
IMPLS = [("ranges", "argsort"), ("fused", "pallas")]


def _configs(sweep, sort, n=N, **over):
    """The JAX and the port's configs, field for field equal."""
    extent = float(int((n * 10000 / 12) ** 0.5))
    grid = dict(radius=50.0, extent_x=extent, extent_z=extent, k=32,
                cell_cap=12, row_block=64, sweep_impl=sweep,
                sort_impl=sort, topk_impl="sort", skin=0.0,
                precision="off")
    grid.update(over.pop("grid", {}))
    world = dict(capacity=n, npc_speed=5.0, enter_cap=512, leave_cap=512,
                 sync_cap=2048, attr_sync_cap=256, input_cap=64,
                 delta_rows_cap=n)
    world.update(over)
    jcfg = jstate.WorldConfig(grid=jstate.GridSpec(**grid), **world)
    tcfg = tstate.WorldConfig(grid=aoi.GridSpec(**grid), **world)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _space(cfg, seed, kind="bench"):
    """One Space's numpy lanes and inputs. ``bench``: every slot an
    alive mover (1% and the first 4 with clients, some dirty hot attrs)
    and 16 syncs with a repeated slot; ``cluster``: the same, with a
    third of the Space crowded into one spot; ``empty``: nothing alive;
    ``dump``: all alive but with watch radius 0, so every entity sorts
    into the dump bin."""
    rng = np.random.default_rng(seed)
    n, g = cfg.capacity, cfg.grid
    lanes = _jax_lanes(jstate.create_state(cfg, seed=1))
    lanes["rng"] = np.array([0, seed + 11], np.uint32)
    lanes["pos"][:, 0] = rng.uniform(0, g.extent_x, n)
    lanes["pos"][:, 2] = rng.uniform(0, g.extent_z, n)
    if kind == "cluster":
        c = n // 3
        lanes["pos"][:c, 0] = 200.0 + rng.uniform(0, 4, c)
        lanes["pos"][:c, 2] = 200.0 + rng.uniform(0, 4, c)
    lanes["alive"][:] = kind != "empty"
    lanes["npc_moving"][:] = kind != "empty"
    lanes["has_client"][:] = (rng.random(n) < 0.01) & (kind != "empty")
    lanes["has_client"][:4] = kind != "empty"
    lanes["hot_attrs"][:] = rng.random((n, cfg.attr_width))
    lanes["attr_dirty"][rng.random(n) < 0.05] = 0x80000005
    if kind == "dump":
        lanes["aoi_radius"][:] = 0.0
    ic = cfg.input_cap
    idx = np.zeros(ic, np.int32)
    idx[:16] = rng.integers(0, n, 16)
    idx[15] = idx[3]  # a repeated slot: the last record wins
    vals = np.zeros((ic, 4), np.float32)
    vals[:16, 0] = rng.uniform(0, g.extent_x, 16)
    vals[:16, 2] = rng.uniform(0, g.extent_z, 16)
    vals[:16, 3] = rng.uniform(0, 6, 16)
    inputs = dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.asarray(16 if kind != "empty" else 0,
                                        np.int32))
    return lanes, inputs


def _stack(spaces):
    lanes = {k: np.stack([s[0][k] for s in spaces]) for k in spaces[0][0]}
    inputs = {k: np.stack([s[1][k] for s in spaces]) for k in spaces[0][1]}
    return lanes, inputs


def _jax_lanes(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _bits_equal(got: dict, ref: dict, what):
    assert got.keys() <= ref.keys(), (what, set(got) - set(ref))
    for name, g in got.items():
        r = ref[name]
        assert g.shape == r.shape and g.dtype == r.dtype, (what, name)
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(r).view(np.uint8)), (what, name)


def _run_both(jcfg, tcfg, lanes, inputs, ticks=TICKS, jpolicy=None,
              tpolicy=None):
    """Tick both packages' batched steps from the same stacked lanes
    (with the packages' policies under mlp); compare every lane after
    every tick; return the port's final state and outputs."""
    s = lanes["pos"].shape[0]
    jstep = jlocal_tick(jcfg, s)
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()})
    ji = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    tstep = make_tick(tcfg, device="cpu")
    ts = interop.state_from_numpy(lanes, device="cpu")
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    outs = []
    for t in range(ticks):
        js, jo = jstep(js, ji, jpolicy)
        ts, to = tstep(ts, ti, tpolicy)
        _bits_equal(interop.state_to_numpy(ts), _jax_lanes(js),
                    f"state {t}")
        _bits_equal(interop.outputs_to_numpy(to), _jax_lanes(jo),
                    f"outputs {t}")
        outs.append(interop.outputs_to_numpy(to))
    return ts, outs


@pytest.mark.parametrize("spaces", [2, 3])
@pytest.mark.parametrize("impl", IMPLS, ids=["ranges", "fused"])
def test_batched_step_matches_jax_vmapped_step(impl, spaces):
    jcfg, tcfg = _configs(*impl)
    lanes, inputs = _stack([_space(jcfg, 3 + d) for d in range(spaces)])
    _, outs = _run_both(jcfg, tcfg, lanes, inputs)
    first = outs[0]
    assert first["enter_n"].shape == (spaces,)
    assert (first["enter_n"] > 0).all() and (outs[-1]["sync_n"] > 0).all()
    assert (first["attr_n"] > 0).all()


@pytest.mark.parametrize("impl", IMPLS, ids=["ranges", "fused"])
def test_one_space_over_enter_cap_alone(impl):
    """Caps are per Space: the crowded Space overflows enter_cap (its
    true count reported past the cap) while the other two stay inside
    theirs, and both packages keep the same records."""
    jcfg, tcfg = _configs(*impl, enter_cap=3200)
    lanes, inputs = _stack([_space(jcfg, 5), _space(jcfg, 6, "cluster"),
                            _space(jcfg, 7)])
    _, outs = _run_both(jcfg, tcfg, lanes, inputs, ticks=3)
    en = outs[0]["enter_n"]
    assert en[1] > 3200 and en[0] <= 3200 and en[2] <= 3200
    assert (outs[0]["enter_w"][1] >= 0).all()
    assert (outs[0]["enter_w"][0][en[0]:] == -1).all()


@pytest.mark.parametrize("impl", IMPLS, ids=["ranges", "fused"])
def test_empty_and_dump_bin_spaces(impl):
    """An empty Space and one whose every entity sorts into the dump bin
    tick beside a live one: no events, no records, no gauges of theirs,
    the live Space unaffected."""
    jcfg, tcfg = _configs(*impl)
    lanes, inputs = _stack([_space(jcfg, 8, "empty"), _space(jcfg, 9),
                            _space(jcfg, 10, "dump")])
    _, outs = _run_both(jcfg, tcfg, lanes, inputs, ticks=3)
    for o in outs:
        assert o["enter_n"][0] == o["enter_n"][2] == 0
        assert o["sync_n"][0] == o["sync_n"][2] == 0
        assert o["alive_count"].tolist() == [0, N, N]
        assert o["aoi_cell_max"][0] == o["aoi_cell_max"][2] == 0
    assert outs[0]["enter_n"][1] > 0


def test_batched_step_equals_single_space_ticks():
    """The port's batched step equals S calls of its single-Space tick,
    one on each Space's view, in every lane, for 4 ticks; the single
    ticks run the kernels' plain versions through the same wrappers."""
    _, tcfg = _configs("fused", "pallas")
    lanes, inputs = _stack([_space(tcfg, 20 + d, kind) for d, kind in
                            enumerate(("bench", "cluster", "empty"))])
    tick = make_tick(tcfg, device="cpu")
    st = interop.state_from_numpy(lanes, device="cpu")
    inp = interop.inputs_from_numpy(inputs, device="cpu")
    singles = [tile_view(st, d) for d in range(3)]
    one_in = [TickInputs(**{f.name: getattr(inp, f.name)[d]
                            for f in dataclasses.fields(TickInputs)})
              for d in range(3)]
    for t in range(4):
        st, out = tick(st, inp)
        for d in range(3):
            singles[d], o1 = tick(singles[d], one_in[d])
            _bits_equal(interop.state_to_numpy(tile_view(st, d)),
                        interop.state_to_numpy(singles[d]),
                        f"state {t} space {d}")
            _bits_equal(
                interop.outputs_to_numpy(type(out)(**{
                    f.name: getattr(out, f.name)[d]
                    for f in dataclasses.fields(out)})),
                interop.outputs_to_numpy(o1), f"outputs {t} space {d}")


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_plain_kernels_equal_per_space_calls(seed):
    """The sort's and the sweep's plain versions (and the wrappers on
    CPU tensors) on ``[S, ...]`` lanes equal per-Space calls."""
    _, tcfg = _configs("fused", "pallas", n=512)
    g = tcfg.grid
    lanes, _ = _stack([_space(tcfg, 30 + 3 * seed + d, kind) for d, kind in
                       enumerate(("bench", "cluster", "dump", "empty"))])
    pos = torch.tensor(lanes["pos"])
    alive = torch.tensor(lanes["alive"])
    radius = torch.tensor(lanes["aoi_radius"])
    flags = torch.tensor(lanes["has_client"]).to(torch.int32) << 1
    fh = aoi.front_half(g, pos, alive, None, radius, flags,
                        with_stats=True)
    per = [aoi.front_half(g, pos[d], alive[d], None, radius[d], flags[d],
                          with_stats=True) for d in range(4)]
    for name in ("srow", "s_xz", "s_w", "lo", "hi", "reach"):
        for d in range(4):
            assert torch.equal(getattr(fh, name)[d],
                               getattr(per[d], name)), name
    for d in range(4):
        assert [int(x[d]) for x in fh.cell_stats] == \
            [int(x) for x in per[d].cell_stats]
    for sort in (counting_sort_cells, counting_sort_cells_cuda):
        o, r = sort(fh.srow, fh.n_rows)
        for d in range(4):
            o1, r1 = sort(fh.srow[d], fh.n_rows)
            assert torch.equal(o[d], o1) and torch.equal(r[d], r1)
            assert torch.equal(o[d], torch.argsort(fh.srow[d],
                                                   stable=True).int())
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, pos, fh.reach, g.k, g.cell_cap,
            fh.code, True)
    for sweep in (aoi.sweep_fused_plain, aoi.sweep_fused_cuda):
        top, dem = sweep(*args)
        for d in range(4):
            t1, d1 = sweep(fh.s_xz[d], fh.s_w[d], fh.lo[d], fh.hi[d],
                           pos[d], fh.reach[d], g.k, g.cell_cap, fh.code,
                           True)
            assert torch.equal(top[d], t1) and torch.equal(dem[d], d1)


@pytest.mark.parametrize("impl", IMPLS, ids=["ranges", "fused"])
def test_q16_batched_step_matches_jax(impl):
    """precision=q16 rides the batching with no module of its own: the
    snapped sweep, the lattice ``moved`` test and the bfloat16 velocity
    lane, bit for bit against the JAX vmapped step."""
    jcfg, tcfg = _configs(*impl, grid=dict(precision="q16"))
    lanes, inputs = _stack([_space(jcfg, 40 + d) for d in range(2)])
    ts, outs = _run_both(jcfg, tcfg, lanes, inputs, ticks=4)
    assert ts.vel.dtype == torch.bfloat16
    assert (outs[0]["enter_n"] > 0).all()


def test_interop_carries_stacked_lanes_both_ways():
    """The stacked state, inputs and outputs of several Spaces go from
    the JAX package's numpy lanes to the port and back unchanged."""
    jcfg, _ = _configs("fused", "pallas", n=128)
    lanes, inputs = _stack([_space(jcfg, 50 + d) for d in range(3)])
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()})
    ji = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    _, jo = jlocal_tick(jcfg, 3)(js, ji, None)
    jout = _jax_lanes(jo)
    st = interop.state_from_numpy(lanes, device="cpu")
    _bits_equal(interop.state_to_numpy(st), lanes, "state")
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    _bits_equal(interop.inputs_to_numpy(ti), inputs, "inputs")
    to = interop.outputs_from_numpy(jout, device="cpu")
    assert to.enter_n.shape == (3,)
    _bits_equal(interop.outputs_to_numpy(to), jout, "outputs")


# ------------------------------------------------- behaviors on [S, ...]

def stacked_bench(jcfg, spaces: int, scenario: bool = False):
    """S bench Spaces (``test_torch_behaviors.bench_lanes``, one seed a
    Space, each with its own key), stacked: (lanes, inputs); under a
    scenario each Space's behavior lane and watch radii as
    ``create_state`` draws them from its seed."""
    from test_torch_behaviors import bench_lanes

    worlds = []
    for d in range(spaces):
        lanes, inputs = bench_lanes(jcfg, seed=d)
        lanes["rng"] = np.array([0, d + 11], np.uint32)
        if scenario:
            st = jstate.create_state(jcfg, seed=d + 1)
            lanes["behavior_id"] = np.asarray(st.behavior_id)
            lanes["aoi_radius"] = np.asarray(st.aoi_radius)
        worlds.append((lanes, inputs))
    return _stack(worlds)


@pytest.mark.parametrize("spaces", [2, 3, 8])
@pytest.mark.parametrize("case", ["btree", "mlp_h16", "mlp_h128"])
def test_batched_behavior_ticks_match_jax_vmapped_step(case, spaces):
    """The btree and the mlp policy (hidden 16 and 128) on the batched
    tick, 512 rows a Space, 8 ticks, bit for bit against the JAX World's
    vmapped step (``_make_local_tick(cfg, n_spaces=S)``): each Space's
    own key, the btree's features over Space-local neighbor ids, and
    one policy pass over all ``S * 512`` rows, whose dots XLA lowers as
    one dot over those rows (``ops/xla_order.py`` ``dot_lanes``)."""
    import jax

    from goworld_tpu.models import npc_policy as jpol
    from goworld_tpu_torch.models import npc_policy as tpol
    from test_torch_behaviors import configs

    behavior, _, hidden = case.partition("_h")
    jcfg, tcfg = configs(512, behavior=behavior)
    lanes, inputs = stacked_bench(jcfg, spaces)
    jp = tp = None
    if hidden:
        jp = jpol.init_policy(jax.random.PRNGKey(5), int(hidden))
        tp = tpol.init_policy(5, int(hidden), device="cpu")
    ts, outs = _run_both(jcfg, tcfg, lanes, inputs, 8, jp, tp)
    assert (outs[0]["enter_n"] > 0).all() and (outs[-1]["sync_n"] > 0).all()
    assert bool((ts.vel != 0).any())


@pytest.mark.parametrize("impl", [("shift", "pallas", "sort"),
                                  ("cellrow", "counting", "sort"),
                                  ("ranges", "argsort", "approx"),
                                  ("fused", "pallas", "approx")],
                         ids=["shift", "cellrow", "approx_ranges",
                              "approx_fused"])
def test_batched_sweep_impls_match_jax_vmapped_step(impl):
    """``shift``, ``cellrow`` and ``approx`` on ``[S, ...]`` lanes: 3
    Spaces (one crowded past ``cell_cap``), 4 ticks, every lane of the
    state and the outputs bit for bit against the JAX World's vmapped
    step under the same impl."""
    sweep, sort, topk = impl
    jcfg, tcfg = _configs(sweep, sort, grid=dict(topk_impl=topk))
    lanes, inputs = _stack([_space(jcfg, 60), _space(jcfg, 61, "cluster"),
                            _space(jcfg, 62)])
    _, outs = _run_both(jcfg, tcfg, lanes, inputs, ticks=4)
    assert outs[0]["aoi_over_cap_cells"][1] > 0
    assert (outs[0]["enter_n"] > 0).all()
