"""The port's telemetry lanes against the JAX package's, on the CPU.

The same per-tick lanes, drawn from a numpy seed with values at, between
and beyond the bucket edges, go through the jitted JAX folds
(``telemetry_update_live``, ``telemetry_update``,
``telemetry_update_mega``) and through the port's in-place folds; the
two accumulators must be equal bit for bit after every one of 32 folds:
with the skin lane off and on (skin 4, and skin 1.7, where the slack's
reciprocal and a true division bucket some values apart), occupancy
over 1 and 4 tiles. The drain, the window delta and the workload
signature of equal lanes must be equal too.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from goworld_tpu.core.step import TickOutputs as JOut
from goworld_tpu.ops import telemetry as jtel
from goworld_tpu.parallel.megaspace import MegaTickOutputs as JMega
from goworld_tpu.utils import devprof as jdevprof
from goworld_tpu_torch.core.step import TickOutputs as TOut
from goworld_tpu_torch.ops import telemetry as ttel
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel.megaspace import MegaTickOutputs as TMega
from goworld_tpu_torch.utils import devprof as tdevprof

FOLDS = 32
# counts at the edges, between them and past the last one
COUNTS = np.array([0, 1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262144,
                   1048576, 2, 3, 10, 100, 5000, 70000, 2_000_000,
                   124_409], np.int32)


def _near_edges(h: np.float32) -> np.ndarray:
    """Slack values on and a few float32 steps around each slack edge
    times ``h``: where dividing by ``h`` and multiplying by its float32
    reciprocal round to different sides of an edge (at skin 1.7, for
    one), only the reference's own rounding lands in its bucket. No
    value or its scaled value is subnormal: XLA's CPU backend flushes
    those to zero and torch does not, and a slack (skin/2 less a
    displacement of positions) never is one; around 0 the values are
    +-1e-30."""
    tiny = np.float32(1e-30)
    out = [np.float32(0.0), tiny, -tiny]
    for e in np.asarray(ttel.SLACK_EDGES, np.float32)[1:]:
        lo = hi = np.float32(e * h)
        out.append(lo)
        for _ in range(4):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            out += [lo, hi]
    return np.array(out, np.float32)


def _outs_np(rng, n_tiles: int, half_skin: float, lead=True) -> dict:
    """One tick's output lanes (a leading tile axis when ``lead``)."""
    shape = (n_tiles,) if lead else ()

    def counts():
        return rng.choice(COUNTS, shape).astype(np.int32)

    h = half_skin if half_skin > 0 else 1.0
    slack = np.concatenate([_near_edges(np.float32(h)),
                            rng.uniform(-h, 2 * h, 8).astype(np.float32),
                            np.float32([-0.0, 3 * h, -1.0])])
    cap = 8
    out = {name: np.zeros(shape + (cap,), np.int32) for name in (
        "enter_w", "enter_j", "leave_w", "leave_j", "sync_w", "sync_j",
        "attr_e", "attr_i")}
    out["sync_vals"] = np.zeros(shape + (cap, 4), np.float32)
    out["attr_v"] = np.zeros(shape + (cap,), np.float32)
    for name in ("enter_n", "leave_n", "delta_rows_n", "sync_n", "attr_n",
                 "aoi_demand_max", "aoi_over_k_rows", "aoi_cell_max",
                 "aoi_over_cap_cells"):
        out[name] = counts()
    out["alive_count"] = counts()
    out["aoi_rebuilt"] = rng.integers(0, 2, shape).astype(np.int32)
    out["aoi_skin_slack"] = rng.choice(slack, shape).astype(np.float32)
    return out


def _jax_out(d):
    return JOut(**{k: jax.numpy.asarray(v) for k, v in d.items()})


def _port_out(d):
    return TOut(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _mega_np(rng, n_tiles: int) -> dict:
    pick = lambda shape: rng.choice(COUNTS, shape).astype(np.int32)
    return dict(arr_tag=np.zeros((n_tiles, 4), np.int32),
                arr_slot=np.zeros((n_tiles, 4), np.int32),
                arr_n=pick((n_tiles,)),
                migrate_dropped=pick((n_tiles,)),
                migrate_demand=pick((n_tiles, n_tiles)),
                halo_demand=pick((n_tiles,)),
                global_alive=pick((n_tiles,)))


def _same_acc(jacc, tacc) -> list[str]:
    bad = []
    assert set(jacc) == set(tacc), (sorted(jacc), sorted(tacc))
    for k in jacc:
        a, b = np.asarray(jacc[k]), tacc[k].numpy()
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            bad.append(f"{k}: {a} != {b}")
    return bad


LIVE = [(skin, tiles) for skin in (0.0, 4.0, 1.7) for tiles in (1, 4)]


@pytest.mark.parametrize("skin,n_tiles", LIVE,
                         ids=[f"skin{s:g}-{t}tile" for s, t in LIVE])
def test_live_fold_matches_jax_bit_for_bit(skin, n_tiles):
    rng = np.random.default_rng(11 + n_tiles)
    skin_on, hs = skin > 0, skin / 2.0
    jfold = jax.jit(lambda acc, outs: jtel.telemetry_update_live(
        acc, outs, half_skin=hs))
    jacc = jtel.telemetry_init(skin_on, occupancy=True, n_tiles=n_tiles)
    tacc = ttel.telemetry_init(skin_on, occupancy=True, n_tiles=n_tiles,
                               device="cpu")
    tfold = ttel.make_fold(half_skin=hs)
    for i in range(FOLDS):
        d = _outs_np(rng, n_tiles, hs)
        jacc = jfold(jacc, _jax_out(d))
        assert tfold(tacc, _port_out(d)) is tacc  # in place
        assert _same_acc(jacc, tacc) == [], f"fold {i}"
    lanes = ttel.telemetry_drain(tacc, skin_on, hs)
    assert sum(lanes["rebuilt"]["counts"]) == FOLDS
    assert sum(lanes["occupancy"]["counts"]) == FOLDS * n_tiles
    assert lanes["tick_ms"]["counts"][0] == FOLDS
    assert float(tacc["tick_ms_sum"]) == 0.0


@pytest.mark.parametrize("skin", [0.0, 1.7])
def test_scan_fold_with_a_tick_cost_model_matches_jax(skin):
    """``telemetry_update`` on one Space's outputs, with host-measured
    model constants: the tick_ms lane and its float32 running sum."""
    rng = np.random.default_rng(5)
    skin_on, hs = skin > 0, skin / 2.0
    base, delta = 3.7, 5.3
    jfold = jax.jit(lambda acc, out: jtel.telemetry_update(
        acc, out, base, delta, hs))
    jacc = jtel.telemetry_init(skin_on)
    tacc = ttel.telemetry_init(skin_on, device="cpu")
    for i in range(FOLDS):
        d = _outs_np(rng, 1, hs, lead=False)
        jacc = jfold(jacc, _jax_out(d))
        assert ttel.telemetry_update(tacc, _port_out(d), base, delta,
                                     hs) is tacc
        assert _same_acc(jacc, tacc) == [], f"fold {i}"
    assert float(tacc["tick_ms_sum"]) > 0


@pytest.mark.parametrize("live", [False, True], ids=["update_mega", "live"])
def test_mega_fold_matches_jax(live):
    rng = np.random.default_rng(9)
    n_tiles = 4
    if live:
        jfold = jax.jit(lambda acc, m: jtel.telemetry_update_live(
            acc, m, mega=True, base_ms=1.5))
    else:
        jfold = jax.jit(lambda acc, m: jtel.telemetry_update_mega(
            acc, m, 1.5))
    jacc = jtel.telemetry_init(False, mega=True, occupancy=live,
                               n_tiles=n_tiles)
    tacc = ttel.telemetry_init(False, mega=True, occupancy=live,
                               n_tiles=n_tiles, device="cpu")
    if live:
        tfold = ttel.make_fold(mega=True, base_ms=1.5)
    else:
        tfold = lambda acc, m: ttel.telemetry_update_mega(acc, m, 1.5)
    for i in range(FOLDS):
        d, m = _outs_np(rng, n_tiles, 0.0), _mega_np(rng, n_tiles)
        jm = JMega(base=_jax_out(d),
                   **{k: jax.numpy.asarray(v) for k, v in m.items()})
        tm = TMega(base=_port_out(d),
                   **{k: torch.from_numpy(v) for k, v in m.items()})
        jacc = jfold(jacc, jm)
        tfold(tacc, tm)
        assert _same_acc(jacc, tacc) == [], f"fold {i}"


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("skin,n_tiles", [(0.0, 1), (4.0, 1), (1.7, 4)],
                         ids=["skin0", "skin4", "skin1.7-4tile"])
def test_drain_delta_and_signature_match_jax(skin, n_tiles):
    rng = np.random.default_rng(3)
    skin_on, hs = skin > 0, skin / 2.0
    jfold = jax.jit(lambda acc, outs: jtel.telemetry_update_live(
        acc, outs, half_skin=hs))
    jacc = jtel.telemetry_init(skin_on, occupancy=True, n_tiles=n_tiles)
    tacc = ttel.telemetry_init(skin_on, occupancy=True, n_tiles=n_tiles,
                               device="cpu")
    tfold = ttel.make_fold(half_skin=hs)
    marks = {}
    for i in range(FOLDS):
        d = _outs_np(rng, n_tiles, hs)
        if i % 4 == 0:  # quieter ticks too, so the classes vary
            for k in ("enter_n", "leave_n", "sync_n", "aoi_over_k_rows",
                      "aoi_over_cap_cells"):
                d[k] = np.zeros_like(d[k])
        jacc = jfold(jacc, _jax_out(d))
        tfold(tacc, _port_out(d))
        if i in (7, 15, 31):
            host = {k: v.numpy().copy() for k, v in tacc.items()}
            marks[i] = (jtel.telemetry_drain(jacc, skin_on, hs),
                        ttel.telemetry_drain(host, skin_on, hs))
    grid = GridSpec(radius=50.0, skin=skin)
    key = tdevprof.grid_config_key(grid)
    assert key == jdevprof.grid_config_key(grid)
    for i, (jl, tl) in marks.items():
        assert _same(jl, tl), i
    for prev, cur in ((None, 31), (7, 31), (15, 31), (7, 15)):
        jd = jtel.lanes_delta(marks[cur][0],
                              marks[prev][0] if prev is not None else None)
        td = ttel.lanes_delta(marks[cur][1],
                              marks[prev][1] if prev is not None else None)
        assert _same(jd, td)
        assert _same(jtel.workload_signature(jd, config=key),
                     ttel.workload_signature(td, config=key))
    assert _same(jtel.workload_signature({}),
                 ttel.workload_signature({}))


def test_bucket_add_matches_the_host_histogram():
    rng = np.random.default_rng(1)
    for edges in (ttel.COUNT_EDGES, ttel.SLACK_EDGES, ttel.TICK_MS_EDGES,
                  ttel.REBUILD_EDGES):
        e = np.asarray(edges, np.float32)
        vals = np.concatenate([e, (e[:-1] + e[1:]) / 2, e[-1:] * 2,
                               e[:1] - 1,
                               rng.uniform(-1, 2 * e[-1], 64)]
                              ).astype(np.float32)
        acc = torch.zeros(len(edges) + 1, dtype=torch.int32)
        ttel._bucket_add_vec(acc, torch.from_numpy(e),
                             torch.from_numpy(vals))
        ttel._bucket_add(acc, torch.from_numpy(e),
                         torch.from_numpy(vals[:1]))
        want = ttel.host_histogram(vals, edges)
        want[int(np.searchsorted(e, vals[0], side="left"))] += 1
        assert acc.numpy().tolist() == want.tolist()
        assert want.tolist() == jtel.host_histogram(
            np.concatenate([vals, vals[:1]]), edges).tolist()


def test_lane_set_and_fold_builder_counts_match_the_reference():
    for skin_on in (False, True):
        for mega in (False, True):
            for occ in (False, True):
                assert ttel.lane_edges(skin_on, mega, occ) == \
                    jtel.lane_edges(skin_on, mega, occ)
    assert ttel.RECOMMENDATION_KEYS == jtel.RECOMMENDATION_KEYS
    before = dict(ttel.TRACE_COUNTS)
    ttel.make_fold(half_skin=2.0)
    ttel.make_fold(mega=True)
    assert set(ttel.TRACE_COUNTS) == set(jtel.TRACE_COUNTS) | {
        "telemetry_update", "telemetry_update_live"}
    assert ttel.TRACE_COUNTS == dict(
        before, telemetry_update_live=before["telemetry_update_live"] + 2)
    acc = ttel.telemetry_init(True, occupancy=True, n_tiles=2, device="cpu")
    # the count lanes are views of one buffer, as the fold writes them
    assert all(acc[k].data_ptr() >= acc.counts.data_ptr()
               for k in ttel.lane_edges(True, occupancy=True))
    assert dataclasses.is_dataclass(TOut)
