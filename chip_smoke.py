"""Drive goworld_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and no phase's failure
is caught:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``goworld_tpu_torch/csrc`` with nvcc;
3. the counting-sort kernel against its plain version and a stable
   argsort at 2^20 keys (bench keys, then skewed keys), bit for bit;
4. the fused-sweep kernel against its plain version at 2^20 queries,
   then ``grid_neighbors_flags`` under fused+pallas against
   ranges+argsort on the card for the sort, exact and f32 rankings, and
   at a small size against the brute-force oracle;
5. the main path: the 2^20-entity bench world through ``create_state``
   and ``make_tick`` for TICKS ticks with the 4096-record input stream,
   checking the launch counts, events, records, and one tick against
   the same tick run on the kernels' plain versions;
6. a ``kernels`` JSON line: per kernel its launches on the main path,
   time, plain time, library time and bound;
7. the result line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.core.step import make_tick
from goworld_tpu_torch.ops import aoi
from goworld_tpu_torch.ops.aoi import grid_neighbors_flags
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
)
from goworld_tpu_torch.workload import bench_world, slice_config

N = 1 << 20
TICKS = 24
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 CUDA-core rate, used for the kernels' 32-bit integer work too
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    print(f"[1] gpu: {card}", flush=True)
    tag = f"({card})"

    path, secs, log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2] build: {path.name} in {secs:.1f} s; ptxas: "
          f"{' | '.join(regs[:6])}", flush=True)

    cfg = slice_config(N)
    g = cfg.grid
    st0, inputs = bench_world(cfg, SEED, dev)
    flag_bits = st0.has_client.to(torch.int32) << 1
    fh = aoi.front_half(g, st0.pos, st0.alive, None, st0.aoi_radius,
                        flag_bits, with_stats=True)

    # [3] sort parity: bench keys, then skewed keys with a heavy dump bin
    rng = np.random.default_rng(SEED + 7)
    skew = rng.integers(0, 64, N).astype(np.int32) * (fh.n_rows // 64)
    skew[rng.random(N) < 0.3] = fh.n_rows
    cases = {"bench": fh.srow,
             "skewed": torch.tensor(skew, device=dev)}
    for name, keys in cases.items():
        o_k, s_k = counting_sort_cells_cuda(keys, fh.n_rows)
        o_p, s_p = counting_sort_cells(keys, fh.n_rows)
        o_a = torch.argsort(keys, stable=True).to(torch.int32)
        torch.cuda.synchronize()
        if not (same(o_k, o_p) and same(s_k, s_p) and same(o_k, o_a)
                and same(s_k, keys[o_a.long()])):
            fail(f"counting sort differs from its plain version ({name})")
    print(f"[3] sort parity: bit-exact at n={N}, n_rows={fh.n_rows} "
          f"(bench and skewed keys)", flush=True)

    # [4] sweep parity at the slice shape, then the whole sweep
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st0.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    torch.cuda.synchronize()
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(1).sum())
        fail(f"fused sweep differs from its plain version in {bad} rows")
    flag_bits = (torch.rand(N, generator=torch.Generator(device=dev)
                            .manual_seed(3), device=dev) < 0.5)\
        .to(torch.int32) | (st0.has_client.to(torch.int32) << 1)
    for topk in ("sort", "exact", "f32"):
        outs = {}
        for sweep, sort in (("fused", "pallas"), ("ranges", "argsort")):
            spec = dataclasses.replace(g, sweep_impl=sweep, sort_impl=sort,
                                       topk_impl=topk)
            outs[sweep] = grid_neighbors_flags(
                spec, st0.pos, st0.alive, watch_radius=st0.aoi_radius,
                flag_bits=flag_bits, with_stats=True)
        a, b = outs["fused"], outs["ranges"]
        if not (all(same(x, y) for x, y in zip(a[:3], b[:3]))
                and all(same(x, y) for x, y in zip(a[3], b[3]))):
            fail(f"grid_neighbors_flags fused+pallas != ranges+argsort "
                 f"({topk})")
    small = slice_config(4096).grid
    srng = np.random.default_rng(SEED + 11)
    spos = np.zeros((4096, 3), np.float32)
    spos[:, 0] = srng.uniform(0, small.extent_x, 4096)
    spos[:, 2] = srng.uniform(0, small.extent_z, 4096)
    salive = srng.random(4096) < 0.9
    snbr, scnt, _, sstats = grid_neighbors_flags(
        small, torch.tensor(spos, device=dev),
        torch.tensor(salive, device=dev),
        flag_bits=torch.zeros(4096, dtype=torch.int32, device=dev),
        with_stats=True)
    if int(sstats[1]) or int(sstats[3]):
        fail("small oracle world overflowed its caps")
    oracle = aoi.neighbors_oracle(spos, salive, small.radius)
    snbr = snbr.cpu().numpy()
    got = [set(r[r < 4096].tolist()) for r in snbr]
    if got != oracle:
        fail("fused sweep disagrees with the brute-force oracle")
    print(f"[4] sweep parity: kernel == plain at n={N} (keys, demand); "
          f"fused+pallas == ranges+argsort for sort/exact/f32; "
          f"oracle exact at n=4096", flush=True)

    # [5] the main path
    tick = make_tick(cfg, device=dev)
    st = st0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS)]
    gauges = []
    snapshot = None
    # two untimed ticks in which any op that makes the host wait on the
    # card raises (the debug mode slows the host, so the timed run below
    # goes without it)
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(2):
        tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    kernels.reset_launches()
    wall0 = time.perf_counter()
    for t in range(TICKS):
        if t == TICKS // 2:
            snapshot = st
        starts[t].record()
        st, out = tick(st, inputs)
        ends[t].record()
        gauges.append(torch.stack([
            out.enter_n, out.leave_n, out.sync_n, out.attr_n,
            out.delta_rows_n, out.aoi_demand_max, out.aoi_over_k_rows,
            out.aoi_cell_max, out.aoi_over_cap_cells]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        if count != TICKS:
            fail(f"{name} launched {count} times in {TICKS} ticks")
    gv = torch.stack(gauges).cpu().numpy()
    if gv[0, 0] <= 0:
        fail("no enter events on tick 1")
    if (gv[:, 2] <= 0).any():
        fail("a tick produced no sync records")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([a.elapsed_time(b) for a, b in zip(starts, ends)])
    steady = ms[1:]
    p50, p99 = float(np.percentile(steady, 50)), float(
        np.percentile(steady, 99))
    rate = N / (p50 / 1e3)

    # one tick again on the kernels' plain versions, same input state
    st_k, out_k = tick(snapshot, inputs)
    plain_cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, sweep_impl="ranges", sort_impl="counting"))
    st_p, out_p = make_tick(plain_cfg, device=dev)(snapshot, inputs)
    for f in dataclasses.fields(st_k):
        if not same(getattr(st_k, f.name), getattr(st_p, f.name)):
            fail(f"state lane {f.name}: kernels != plain versions")
    for f in dataclasses.fields(out_k):
        if not same(getattr(out_k, f.name), getattr(out_p, f.name)):
            fail(f"output lane {f.name}: kernels != plain versions")
    print(f"[5] main path: {TICKS} ticks of {N} entities, launches "
          f"{launches}; tick 1 enter_n={int(gv[0, 0])} "
          f"leave_n={int(gv[0, 1])} sync_n={int(gv[0, 2])}; last tick "
          f"sync_n={int(gv[-1, 2])} delta_rows_n={int(gv[-1, 4])}; "
          f"overflow gauges max over run: demand_max={int(gv[:, 5].max())}"
          f" over_k_rows={int(gv[:, 6].max())} cell_max="
          f"{int(gv[:, 7].max())} over_cap_cells={int(gv[:, 8].max())}; "
          f"tick {TICKS // 2 + 1} bit-identical on plain versions; "
          f"ms/tick p50={p50:.3f} p99={p99:.3f} (ticks 2-{TICKS}, CUDA "
          f"events) wall {wall * 1e3 / TICKS:.3f} ms/tick; "
          f"{rate:.4g} entity-ticks/s {tag}", flush=True)

    # [6] kernel times at the main path's shapes (state after the run)
    flag_bits = (st.dirty.to(torch.int32)
                 | (st.has_client.to(torch.int32) << 1))
    fh = aoi.front_half(g, st.pos, st.alive, None, st.aoi_radius,
                        flag_bits, with_stats=True)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    k_top, k_dem = aoi.sweep_fused_cuda(*args)
    p_top, p_dem = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    sweep_err = int((k_top.long() - p_top.long()).abs().max()) + int(
        (k_dem - p_dem).abs().max())
    sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)
    sweep_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 3, 1)
    n_lanes = 9 * g.cell_cap
    s_len = fh.s_w.numel()
    sweep_bytes = (12 * s_len + 24 * N + 12 * N + 4 * N  # in
                   + 4 * g.k * N + 4 * N)                # out
    # per candidate lane: 5 distance, 3 validity, 6 key-pack operations;
    # per selection round (min(demand, k) + 1 a row): 2 per lane
    rounds = int((torch.clamp_max(k_dem, g.k) + 1).sum())
    sweep_ops = 14 * n_lanes * N + 2 * n_lanes * rounds
    o_k, s_k = counting_sort_cells_cuda(fh.srow, fh.n_rows)
    o_p, s_p = counting_sort_cells(fh.srow, fh.n_rows)
    sort_err = int((o_k - o_p).abs().max()) + int((s_k - s_p).abs().max())
    sort_ms = time_ms(
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows), 20)
    sort_plain = time_ms(
        lambda: counting_sort_cells(fh.srow, fh.n_rows), 3, 1)
    sort_lib = time_ms(lambda: torch.argsort(fh.srow, stable=True), 20)
    bits = max(1, fh.n_rows.bit_length())
    passes = -(-bits // 8)
    sort_bytes = 12 * N
    sort_ops = passes * 12 * N  # digit extract, histogram, rank, scatter

    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    rows = []
    for name, src, rep, err, kms, pms, lms, nb, no in (
            ("sweep_fused_cuda", "goworld_tpu_torch/csrc/aoi_fused.cu",
             "goworld_tpu/ops/aoi.py:919", sweep_err, sweep_ms,
             sweep_plain, None, sweep_bytes, sweep_ops),
            ("counting_sort_cells_cuda",
             "goworld_tpu_torch/csrc/counting_sort.cu",
             "goworld_tpu/ops/sort.py:157", sort_err, sort_ms, sort_plain,
             sort_lib, sort_bytes, sort_ops)):
        bms, by = bound(nb, no)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["sweep_fused" if "sweep" in name
                                 else "counting_sort"],
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
        })
        if err != 0:
            fail(f"{name} differs from its plain version at timing inputs")
    print(f"[6] kernel times on the next line, launches per tick: "
          f"{ {k: v / TICKS for k, v in launches.items()} } {tag}",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
