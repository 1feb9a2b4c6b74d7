"""Drive goworld_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and no phase's failure
is caught:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``goworld_tpu_torch/csrc`` with nvcc;
3. the counting-sort kernel against its plain version and a stable
   argsort at 2^20 keys (bench keys, then skewed keys), bit for bit;
   then at n = 1, 4095, 4097 and 311,296 and at key widths of 1, 21 and
   31 bits against a stable argsort (and the plain version wherever its
   n_rows + 1 tables fit);
4. the fused-sweep kernel against its plain version at 2^20 queries,
   then at k = 8 and 64, cell_cap 3, 4 and 28 (one and eight keys a
   lane), without flag bits, and on a clustered world where most rows
   have demand > 32, each time checking that the sorted slot ids it
   walks are a permutation of the rows; then ``grid_neighbors_flags``
   under fused+pallas against ranges+argsort on the card for the sort,
   exact and f32 rankings, and at a small size against the brute-force
   oracle;
5. the single-Space path: the 2^20-entity bench world through
   ``create_state`` and ``make_tick`` for TICKS ticks with the
   4096-record input stream, checking the launch counts, events,
   records, and one tick against the same tick run on the kernels'
   plain versions;
6. the sweep and sort kernels timed at that path's shapes by CUDA
   events over back-to-back calls, and their bounds;
7. the halo phase kernel against its plain version bit for bit at
   halo_cap 4096 in 84 cases (both 2D phases at 2x2 and 4x2, the 1D
   phase of 8 tiles and one tile shipping to itself; the layout's
   receivers, all and none; counts 0, H, > H and random; NaN, -0.0 and
   inf words; gids up to the meta bound), then ``exchange_halo_2d`` on
   the megaspace world and ``exchange_halo`` over 8 tiles under "async"
   against "ppermute", with 2 and 1 kernel launches a call;
8. the megaspace path: the 2^20-entity 2x2 megaspace through
   ``create_mega_state`` and ``make_mega_tick`` for MEGA_TICKS ticks,
   checking launch counts, events, records, ghosts, migrations and
   conservation, one tick against the same tick on the plain versions
   (ppermute ship, ranges sweep, counting sort), and one tick under the
   sync guard;
9. the fused sweep at the megaspace shape (queries Q < n rows: local
   rows over local + ghost rows, whose sorted slot ids are checked to be
   a permutation of them) against its plain version, and the phase
   kernel's times on the two phases of one exchange of the megaspace
   state by events, beside one ``exchange_halo_2d`` under each halo
   impl (their device times and kernels a call are read in [12]);
10. a small 2x2 megaspace against a brute-force interest oracle, across
    every kind of tile border (x, z, corner);
11. the serving World at its defaults (the live telemetry lanes, the
    residency plane sampled every 4 ticks, the audit plane every 8, the
    resident carry): ``workload.serve_world(..., boot=True)`` populates
    a World of 2^20 slots through ``Space.create_entity``, in batches
    entered through ticks whose events the caps hold (its time and the
    host's RSS before and after printed), then WORLD_TICKS
    ``World.tick``s of the game's traffic, each staging 4096 client
    syncs (each a step from where its player stands), 1024 hot-attr
    sets (some twice) and 64 destroys and creates, checking one sweep
    and one sort launch a tick, that the drained lanes account for every
    tick (rebuilt and occupancy each sum to the tick count, per_tile is
    the host's entity count), that a workload signature is served, that
    every audit sample judged its cohort with 0 mismatches (skips by
    reason, drops counted), that the census reads 0 re-allocated lanes;
    printing ``World.tick`` p50/p99 beside [5]'s and the World's
    without the planes (PERF.md runs AC and AE), the
    audit-sample ticks apart, the mean of its four spans, the fold's and
    the carry copy's device time by events, the records and events
    decoded against their true counts and the rows whose interest list
    changed against their cap; then STRESS_TICKS ticks whose syncs
    teleport to uniform points (the bench's input stream), printed
    apart with the mismatches the audit finds once their dropped events
    degrade the interest sets; one more tick whose step and fold run
    under the sync guard, the step on a clone held bit for bit against
    ``make_tick`` on the plain versions (ranges/argsort), its fetched
    outputs, positions, yaws and alive flags bit for bit against plain
    ``.cpu()`` copies; one judged audit sample of the full World timed
    on a scratch plane (a full world's samples are skipped: its sweep
    has cells past cell_cap); and twin Worlds of 2^16 slots at their
    defaults,
    one on the kernels and one on the plain versions, equal in sinks,
    hooks, state, telemetry lanes, signatures, audit stats and ledgers
    for TWIN_TICKS ticks of walking and teleporting syncs in turns;
12. every torch.profiler read, here after every timed path because a
    profiler session slows every later launch of the host-bound ticks:
    the sweep's and sort's own device time and kernel launches a call,
    the megaspace tile sweep's, the phase kernel's and one exchange's
    under each impl, the World's telemetry fold's and its resident carry
    copy's (at [11]'s last game tick); then a ``kernels`` JSON line: per
    kernel its launches on its paths (and by path), time, device time,
    kernel launches a call, plain time, library time and bound (the
    sweep's also by the all-lanes count of earlier runs:
    ``bound_ms_window_lanes``, and its numbers at the Verlet rebuild's
    shape: ``verlet_rebuild_shape``, and at the q16 path's:
    ``q16_rebuild_shape``);
13. (run before 12) the Verlet skin: the fused sweep at the rebuild's
    shape (k = verlet_cap_eff 48, no flag bits, reach padded by the
    skin) against its plain version, under a closed gate (its buffers
    unchanged byte for byte) and an open one, timed both ways; the
    input scatter with heavy slot repeats against the host's last write
    per slot; an uncut world of FLOAT_N entities run FLOAT_TICKS ticks
    on the card and on the CPU port, bit-equal in every lane; then the
    bench world uncut (``workload.uncut_config``: skin 4, verlet_cap
    48, syncs drawn with repeats) for VERLET_TICKS ticks, each beside a
    skin-0 tick in lockstep and bit-equal to it in every lane and
    output but the skin gauges and the cell gauges (cells of another
    size), one gated sweep and one sort launch a tick, the rebuild
    count and p50/p99 over all, reuse and rebuild ticks;
14. (run before 12) that world at precision="q16" (cell_cap 12, as
    13): the gated sweep at this path's rebuild shape (snapped
    positions, k 48, reach pad 4) against its plain version, gate open
    and closed; then Q16_TICKS ticks, each beside a twin on the plain
    path (ranges/counting) and bit-equal to it in every lane; each
    tick's lists equal ``grid_neighbors_flags`` (precision off, plain
    path) over the snapped positions on every row no truncation touches
    (no overflowed run at the last rebuild or in the reference, no full
    cache row); the velocity lane is bfloat16; p50/p99 as in 13;
15. (run before 12) several Spaces on one card, SPACES x SPACE_N
    (``workload.multi_config``/``multi_world``: 8 bench worlds of 2^17
    on a leading [S] axis): the batched sort and sweep against their
    plain versions (and every Space's sweep against its own launch) bit
    for bit, timed beside their plain versions, a per-Space
    ``torch.argsort`` and their bounds; two batched ticks under the sync
    guard; SPACE_TICKS batched ticks by CUDA events, one sweep and one
    sort launch a tick, the same a tick as a one-Space batched state;
    the same ticks again in lockstep with SPACES single-Space ticks,
    every lane of state and outputs equal on every tick; then
    ``serve_world(SPACE_WORLD_N, spaces=SPACES, boot=True)``: a World of
    SPACES Spaces at its defaults, booted through ticks whose events
    each Space's caps hold, WORLD_TICKS ``World.tick``s of the game's
    traffic plus SERVE_MIGRATIONS ``enter_space`` moves between random
    Spaces a tick (every staged migration applied), p50/p99 and the four
    spans, the planes checked as in 11, one more tick's step and fold
    under the sync guard; [12] reads the batched kernels' and the
    batched tick's device time beside the single-Space 2^20 tick's;
16. each phase's wall seconds, then the result line ``{"ok": true,
    "device": {...}}``;
17. (run before 12) NPC behaviors, BASELINE config 5: the policy kernel
    ``npc_mlp`` (``csrc/npc_mlp.cu``) against its plain version bit for
    bit at 2^20 rows of config 5's observations, at 1, 2, 3, 31 and 4097
    rows of extreme observations (+-3e38, 1e30, 0, -0.0, NaN) under
    ``init_policy(5)`` and random weights at hidden 128 and 16 (every
    lanes mode of layer_lanes there), and on ``mlp_underflow_case``
    (layer-2 products below float32's 2^-149 grid: the kernel's rounded
    layer 2); bf16 tanh on the card against the CPU's on all 65536
    inputs, through float64 and through the kernel's table; its time,
    plain time, cuBLAS bf16 chain time (not bit-equal) and bounds at the
    bf16 tensor-core and the float32 CUDA-core rate; an uncut world of FLOAT_N
    entities FLOAT_TICKS ticks under btree, mlp and the mixed scenario
    on the card and on the CPU port, bit-equal in every lane; the bench
    world uncut under btree and then mlp for BEHAVIOR_TICKS ticks (one
    sweep, one sort and, for mlp, one npc_mlp launch a tick; one tick
    under the sync guard; one tick against its plain twin), p50/p99 and
    the behavior stage's time beside the random walk's; every registry
    scenario SCN_TICKS ticks at SCN_N against its plain twin and mixed at
    2^20 for MIXED_TICKS ticks; the 2x2 megaspace under mlp for
    MEGA_TICKS ticks beside its plain twin tick; twin served Worlds of
    2^16 slots under mlp (kernels, plain versions) equal in sinks and
    state. [12] reads npc_mlp's device time;
18. (run before 12) the World's remaining planes at 2^20 slots: inside
    11, right after its game ticks, its World with ``pipeline_decode``
    turned on for WORLD_TICKS ticks of the same traffic (one sweep and
    one sort launch a tick; the host syncs a tick counted: one wait for
    the copy of the previous tick's outputs, and the decode's reads of
    live positions; decoded events against their true counts), p50/p99
    and the four spans beside 11's eager ones, its planes (lanes a tick
    behind, the audit's ``pipeline_decode`` skips, the census), one
    tick's step and fold under the sync guard, then drained and eager
    again for WORLD_TICKS more ticks, timed (the runs in turns); after
    11, freeze on that World after its ticks:
    ``checkpoint_async`` (its capture on the tick thread, its worker,
    its bytes), a ``SnapshotChain`` keyframe and, 8 ticks on, a delta
    (each captured on the tick thread and built on the caller), the
    audit's ``scrub_snapshots`` over both files (0 corrupt); a restore
    of the delta into a fresh World of 2^20 slots at the uncut config's
    skin, its poses equal to the source's lattice planes byte for byte,
    RESTORED_TICKS ticks (one sweep launch a tick, the first a Verlet
    rebuild); the governor on that World: every default candidate
    warmed off the tick thread, commits forced through GOVERNOR_SWAPS,
    each swap's first tick bit for bit against a fresh ``make_tick`` at
    the target config on a clone of the carried state, each config's
    launches; under ``table`` its sweep beside ``fused``'s (equal on
    every row no cell past cell_cap touches, both timed); the World's
    ``cost_report`` beside ``torch.cuda.max_memory_allocated``; twin
    Worlds of 2^16 slots, pipelined and eager, equal after the drain in
    sync records, entity messages, hooks, state, interest sets, ledgers,
    the pipelined lanes a tick behind the eager ones.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from goworld_tpu_torch import interop, kernels
from goworld_tpu_torch.core.state import WorldConfig, map_lane
from goworld_tpu_torch.core.step import (
    TickInputs,
    compute_velocity,
    make_tick,
)
from goworld_tpu_torch.entity import manager
from goworld_tpu_torch.models import npc_policy
from goworld_tpu_torch.models.npc_policy import build_obs, init_policy
from goworld_tpu_torch.ops import aoi, prng
from goworld_tpu_torch.ops.mlp import (layer_lanes, npc_mlp, npc_mlp_plain,
                                      tanh_bf16, tanh_by_table)
from goworld_tpu_torch.scenarios.spec import scenario_names
from goworld_tpu_torch.ops import telemetry as telem
from goworld_tpu_torch.ops.aoi import GridSpec, grid_neighbors_flags
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
    radix_plan,
)
from goworld_tpu_torch.parallel import halo
from goworld_tpu_torch.parallel.megaspace import (
    MegaConfig,
    tile_shifts,
    make_mega_tick,
)
from goworld_tpu_torch.utils import audit as audit_mod
from goworld_tpu_torch.utils import metrics
from goworld_tpu_torch.ops.integrate import apply_pos_inputs
from goworld_tpu_torch.parallel.mesh import tile_view
from goworld_tpu_torch.workload import (
    POLICY_SEED,
    behavior_config,
    behavior_world,
    bench_world,
    mega_config,
    mega_world,
    mlp_underflow_case,
    multi_config,
    multi_world,
    scenario_config,
    serve_world,
    slice_config,
    uncut_config,
    uncut_world,
)

N = 1 << 20
TICKS = 24
MEGA_DEV = 4          # 2x2 tiles, as bench.py's multichip world on 4 chips
MEGA_TICKS = 16
WORLD_TICKS = 16
STRESS_TICKS = 8
# [11]'s World at its defaults, sampled so that samples land inside its
# timed ticks
PLANES = dict(residency_sample_every=4, audit_sample_every=8)
TWIN_N = 1 << 16
TWIN_TICKS = 8
VERLET_TICKS = 64     # ~24 ticks between displacement rebuilds at skin 4
Q16_TICKS = 32
FLOAT_N = 4096
FLOAT_TICKS = 8
# [15] several Spaces on one card: 8 x 2^17 = 2^20 entities, BASELINE's
# 1M target as 8 Spaces
SPACES = 8
SPACE_N = 1 << 17
# [15]'s served World of SPACES Spaces: 2^14 slots a Space (was 2^17,
# whose ~1M-entity boot took 159 s of the run, PERF.md §4); cut so
# that the run, with [18] at 2^20, stays inside its time limit
SPACE_WORLD_N = 1 << 14
SPACE_TICKS = 24
SEED = 0
# [17] behaviors and scenarios
BEHAVIOR_TICKS = 24
MIXED_TICKS = 16
SCN_N = 4096
SCN_TICKS = 4
BEHAVIOR_WORLD_N = 1 << 16
BEHAVIOR_WORLD_TICKS = 4
# [18] the World's remaining planes
RESTORED_TICKS = 4
GOVERNOR_SWAPS = ["skin=0", "sweep=table,skin=0", "sort=counting,skin=0",
                  "default"]
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the
# float32 CUDA-core rate (used for the kernels' 32-bit integer work too)
# and the dense bf16 tensor-core rate (the policy's bf16 products)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12


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


def visits_every_row(fh) -> bool:
    """Whether the sorted view's first n slot ids (n rows, before the
    3*cell_cap sentinel lanes) are a permutation of [0, n), in each
    Space under a leading Space axis: the fused kernel walks its rows by
    them and writes only the rows they name."""
    n = fh.srow.shape[-1]
    ids = torch.sort(fh.s_w[..., :n] >> fh.code[0], dim=-1).values
    return bool((ids == torch.arange(n, dtype=ids.dtype,
                                     device=ids.device)).all())


def sweep_work(fh, dem, k: int, cc: int) -> tuple[int, float, int]:
    """(bytes, operations, in-range candidates) of one fused sweep call
    on these inputs: each input read once and each output written once;
    5 distance, 3 validity and 6 key-pack operations per in-range
    candidate (a run's lanes up to 3*cell_cap), and d*log2(d) compares
    to order a row's d valid keys."""
    n, q = fh.srow.numel(), fh.lo.numel() // 3
    nbytes = (12 * fh.s_w.numel() + 24 * q + 12 * n + 4 * n  # in
              + 4 * k * q + 4 * q)                           # out
    cand = int(torch.clamp(fh.hi - fh.lo, 0, 3 * cc).sum())
    d = dem.double()
    nops = 14 * cand + float((d * torch.log2(d.clamp_min(1))).sum())
    return nbytes, nops, cand


def bound(nbytes, nops, peak_ops=PEAK_OPS_S):
    """(least ms, what bounds it) against the card's peaks, the
    operations at ``peak_ops`` a second."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

def same_bits(a, b) -> bool:
    """Bit-for-bit equality (float lanes compared as their bits)."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def words(t: torch.Tensor) -> torch.Tensor:
    """A lane's 32-bit words (float lanes as their bits) as int64."""
    return (t.view(torch.int32) if t.is_floating_point() else t).long()


def lanes(obj) -> dict:
    """The tensor lanes of a state or outputs dataclass, nested ``base``
    flattened."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in lanes(v).items()})
        else:
            out[f.name] = v
    return out


def phase_cases(dev, h: int, m: int):
    """(label, src, strips, out, col0) of ship phases at halo_cap h over
    m own rows a tile: both 2D phases at 2x2 and 4x2, the 1D phase of 8
    tiles and one tile shipping to itself (shift 0, both segments), each
    with the layout's receivers, all and none, and counts of 0, H, > H
    and random. Lanes hold NaN payloads, -0.0 and infinities and gids up
    to ``meta_gid_bound()``; the block's columns [0, col0) hold an earlier
    phase's rows (the second segment) and flat rows past each count are
    garbage the kernel must not read."""
    one = (halo.Ring(1, (True,)), halo.Ring(-1, (True,)))
    layouts = {
        "2x2-x": (4, halo.rings_2d(2, 2)[0], 0, 4 * h),
        "2x2-z": (4, halo.rings_2d(2, 2)[1], 2 * h, 4 * h),
        "4x2-x": (8, halo.rings_2d(4, 2)[0], 0, 4 * h),
        "4x2-z": (8, halo.rings_2d(4, 2)[1], 2 * h, 4 * h),
        "1d8": (8, halo.rings_1d(8), 0, 2 * h),
        "one-tile": (1, one, 0, 2 * h),
        "one-tile-z": (1, one, 2 * h, 4 * h),
    }
    rng = np.random.default_rng(SEED + 21)
    bound = halo.meta_gid_bound()
    special = np.array([0x7FC01234, 0xFFA00001, 0x80000000, 0x7F800000,
                        0xFF800000, 0x00000001], np.uint32)

    def f32(shape):
        x = rng.normal(0, 1e4, shape).astype(np.float32)
        bits = x.reshape(-1).view(np.uint32)
        bits[rng.choice(bits.size, 64, replace=False)] = np.resize(special,
                                                                   64)
        return x

    def lanes(n_dev, rows, with_valid):
        gid = rng.integers(0, bound + 1, (n_dev, rows)).astype(np.int32)
        gid.reshape(-1)[:2] = [bound, 0]
        out = [f32((n_dev, rows, 3)), f32((n_dev, rows)),
               rng.random((n_dev, rows)) < 0.5]
        if with_valid:
            out.append(rng.random((n_dev, rows)) < 0.7)
        return [torch.tensor(x, device=dev) for x in (*out, gid)]

    for name, (n_dev, rings, col0, g) in layouts.items():
        src, out = lanes(n_dev, m, False), lanes(n_dev, g, True)
        for recv in ("layout", "all", "none"):
            rs = rings if recv == "layout" else tuple(
                halo.Ring(r.shift, (recv == "all",) * n_dev) for r in rings)
            for counts in ("random", "zero", "full", "over"):
                strips = []
                for ring in rs:
                    cnt = {"random": rng.integers(0, 3 * h // 2, n_dev),
                           "zero": np.zeros(n_dev, np.int64),
                           "full": np.full(n_dev, h),
                           "over": rng.integers(h + 1, m + col0 + 1, n_dev),
                           }[counts]
                    flat = rng.integers(-5, 10 ** 6, (n_dev, h + 1)) \
                        .astype(np.int32)
                    for t in range(n_dev):
                        take = min(int(cnt[t]), h)
                        flat[t, :take] = np.sort(rng.choice(
                            m + col0, take, replace=False))
                    strips.append((ring, torch.tensor(flat, device=dev)[:, :h],
                                   torch.tensor(cnt.astype(np.int32),
                                                device=dev)))
                yield f"{name}/{recv}/{counts}", src, strips, out, col0


def halo_parity(dev, mc: MegaConfig) -> None:
    """[7] the phase kernel against its plain version, then the 1D and
    2D exchanges under both impls."""
    h = mc.halo_cap
    n_cases = 0
    for label, src, strips, out, col0 in phase_cases(dev, h, 4 * h):
        got = [o.clone() for o in out]
        want = [o.clone() for o in out]
        kernels.reset_launches()
        halo.ship_phase(src, strips, got, col0)
        halo.ship_phase_plain(src, strips, want, col0)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["halo_ship_phase"] != 1:
            fail(f"ship_phase launched {kernels.LAUNCHES} ({label})")
        for name, a, b in zip(("gpos", "gyaw", "gdirty", "gvalid", "ggid"),
                              got, want):
            if not same_bits(a, b):
                fail(f"phase kernel != plain in {name} ({label}, h={h})")
        n_cases += 1
    names = ("gpos", "gyaw", "gdirty", "gvalid", "ggid", "strip_demand")
    # the 2D exchange at the megaspace shape
    st, _ = mega_world(mc, N, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    dirty = (torch.rand(st.alive.shape, generator=gen, device=dev) < 0.5) \
        & st.alive
    yaw = torch.rand(st.yaw.shape, generator=gen, device=dev) * 6.0 - 3.0
    visible = st.alive & (st.aoi_radius > 0.0)
    outs, launches = {}, {}
    for impl in halo.HALO_IMPLS:
        kernels.reset_launches()
        outs[impl] = halo.exchange_halo_2d(
            mc.shape, mc.cfg.capacity, st.pos, yaw, dirty, visible,
            mc.tile_w, mc.tile_d, mc.cfg.grid.radius, mc.halo_cap, impl=impl)
        launches[impl] = kernels.LAUNCHES["halo_ship_phase"]
    for name, a, b in zip(names, outs["async"], outs["ppermute"]):
        if not same_bits(a, b):
            fail(f"exchange_halo_2d {name}: async != ppermute")
    per_tile = outs["async"][3].sum(1).tolist()
    if min(per_tile) == 0:
        fail(f"a tile received no ghosts: {per_tile}")
    # the 1D exchange over 8 x-strip tiles of 32,768 entities
    n1, w1, r1 = 1 << 15, 1000.0, 50.0
    pos1 = torch.rand((8, n1, 3), generator=gen, device=dev) * w1
    pos1[..., 0] += torch.arange(8, device=dev)[:, None] * w1
    dirty1 = torch.rand((8, n1), generator=gen, device=dev) < 0.5
    alive1 = torch.rand((8, n1), generator=gen, device=dev) < 0.9
    yaw1 = torch.rand((8, n1), generator=gen, device=dev) * 6.0 - 3.0
    outs1 = {}
    for impl in halo.HALO_IMPLS:
        kernels.reset_launches()
        outs1[impl] = halo.exchange_halo(8, pos1, yaw1, dirty1, alive1, w1,
                                         r1, h, impl=impl)
        launches[f"{impl} 1d"] = kernels.LAUNCHES["halo_ship_phase"]
    for name, a, b in zip(names, outs1["async"], outs1["ppermute"]):
        if not same_bits(a, b):
            fail(f"exchange_halo {name}: async != ppermute")
    if not outs1["async"][3].any(1)[1:-1].all():
        fail("an inner 1D tile received no ghosts")
    want = {"async": 2, "ppermute": 0, "async 1d": 1, "ppermute 1d": 0}
    if launches != want:
        fail(f"phase kernel launches a call {launches}, want {want}")
    print(f"[7] halo: phase kernel == plain bit for bit in {n_cases} cases "
          f"(2x2 and 4x2 phases x/z, 8 tiles 1D, one tile to itself; "
          f"receivers of the layout/all/none; counts random/0/H/>H; NaN, "
          f"-0.0, inf words; gids to {halo.meta_gid_bound()}; h={h}); "
          f"exchange_halo_2d async == ppermute on every output at the "
          f"megaspace shape, ghosts per tile {per_tile}, strip_demand "
          f"{outs['async'][5].tolist()}; exchange_halo (8 tiles) async == "
          f"ppermute; launches a call {launches}", flush=True)


def mega_path(dev, mc: MegaConfig, tag: str) -> dict:
    """[8] the megaspace path, [9] the sweep at Q < n and the ship's
    times; returns the ship kernel's row of the kernels line."""
    n = mc.cfg.capacity
    g = mc.cfg.grid
    n_dev = mc.n_dev
    st0, inputs = mega_world(mc, N, SEED, dev)
    tick = make_mega_tick(mc, device=dev)
    # one untimed tick in which any op that makes the host wait on the
    # card raises
    torch.cuda.set_sync_debug_mode("error")
    tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(MEGA_TICKS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(MEGA_TICKS)]
    gauges, first, snapshot = [], None, None
    st = st0
    kernels.reset_launches()
    wall0 = time.perf_counter()
    for t in range(MEGA_TICKS):
        if t == MEGA_TICKS // 2:
            snapshot = st
        starts[t].record()
        st, out = tick(st, inputs)
        ends[t].record()
        if t == 0:
            first = out
        b = out.base
        gauges.append(torch.stack([
            b.enter_n.sum(), b.sync_n.min(), b.sync_n.sum(),
            out.arr_n.sum(), out.migrate_dropped.sum(),
            out.halo_demand.max(), out.global_alive.min(),
            out.global_alive.max(), out.migrate_demand.max(),
            b.leave_n.sum(), b.aoi_over_k_rows.sum(),
            b.aoi_over_cap_cells.sum()]).to(torch.int64))
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = dict(kernels.LAUNCHES)
    want = {"sweep_fused": n_dev * MEGA_TICKS,
            "counting_sort": n_dev * MEGA_TICKS,
            "halo_ship_phase": 2 * MEGA_TICKS, "npc_mlp": 0}
    if launches != want:
        fail(f"megaspace launches {launches} in {MEGA_TICKS} ticks, want "
             f"{want}")
    gv = torch.stack(gauges).cpu().numpy()
    (enter, sync_min, sync_sum, arr, dropped, hdem, ga_min, ga_max,
     mdem, leave, over_k, over_cap) = gv.T
    if enter[0] <= 0:
        fail("no enter events on tick 1")
    if (sync_min <= 0).any():
        fail("a tile produced no sync records in some tick")
    if (dropped != 0).any():
        fail(f"migrate_dropped {dropped.tolist()}")
    if (hdem > mc.halo_cap).any():
        fail(f"halo_demand {hdem.tolist()} over halo_cap {mc.halo_cap}")
    if (ga_min != N).any() or (ga_max != N).any():
        fail(f"global_alive left {N}: {ga_min.tolist()} {ga_max.tolist()}")
    ej, en = first.base.enter_j, first.base.enter_n
    live = torch.arange(ej.shape[1], device=dev)[None, :] < en[:, None]
    d_idx = torch.arange(n_dev, device=dev)[:, None]
    cross = int((live & (ej >= 0) & (ej // n != d_idx)).sum())
    if cross <= 0:
        fail("no ghost entered any tile's AOI on tick 1")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    arrived = int(arr.sum())
    migr = (f"arrivals {arrived} over the run" if arrived > 0 else
            f"no arrival over the run (migrate_demand max "
            f"{int(mdem.max())}, halo_demand max {int(hdem.max())})")
    ms = np.array([a.elapsed_time(b) for a, b in zip(starts, ends)])
    steady = ms[1:]
    p50 = float(np.percentile(steady, 50))
    p99 = float(np.percentile(steady, 99))

    # one tick again on the plain versions, same input state
    st_k, out_k = tick(snapshot, inputs)
    plain = dataclasses.replace(mc, halo_impl="ppermute", cfg=dataclasses
                                .replace(mc.cfg, grid=dataclasses.replace(
                                    g, sweep_impl="ranges",
                                    sort_impl="counting")))
    st_p, out_p = make_mega_tick(plain, device=dev)(snapshot, inputs)
    for what, a, b in (("state", st_k, st_p), ("output", out_k, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"megaspace {what} lane {name}: kernels != plain "
                     f"versions")
    print(f"[8] megaspace path: {MEGA_TICKS} ticks of {N} entities on "
          f"{mc.shape[0]}x{mc.shape[1]} tiles (capacity {n} a tile, "
          f"halo_cap {mc.halo_cap}), launches {launches} "
          f"({ {k: v / MEGA_TICKS for k, v in launches.items()} } a tick); "
          f"tick 1 enter_n={int(enter[0])} (cross-tile {cross}) "
          f"sync_n={int(sync_sum[0])}; last tick sync_n={int(sync_sum[-1])}"
          f" leave_n={int(leave[-1])}; {migr}; halo_demand max "
          f"{int(hdem.max())}; migrate_dropped 0; global_alive {N} every "
          f"tick; AOI over_k_rows max {int(over_k.max())} over_cap_cells "
          f"max {int(over_cap.max())}; tick {MEGA_TICKS // 2 + 1} "
          f"bit-identical on ppermute+ranges+counting; one tick under the "
          f"sync guard; ms/tick p50={p50:.3f} p99={p99:.3f} (ticks "
          f"2-{MEGA_TICKS}, CUDA events) wall "
          f"{wall * 1e3 / MEGA_TICKS:.3f} ms/tick; "
          f"{N / (p50 / 1e3):.4g} entity-ticks/s {tag}", flush=True)

    # [9] the fused sweep at the megaspace shape: tile 0's local rows
    # query local + ghost rows
    gen = torch.Generator(device=dev).manual_seed(9)
    dirty = (torch.rand(st.alive.shape, generator=gen, device=dev) < 0.5) \
        & st.alive
    visible = st.alive & (st.aoi_radius > 0.0)
    gpos, gyaw, gdirty, gvalid, ggid, _ = halo.exchange_halo_2d(
        mc.shape, n, st.pos, st.yaw, dirty, visible, mc.tile_w, mc.tile_d,
        g.radius, mc.halo_cap, impl="async")
    shifts = tile_shifts(mc, dev)
    pos_ext = torch.cat([st.pos[0], gpos[0]]) - shifts[0]
    ghosts = gpos.shape[1]
    flags = torch.cat([dirty[0], gdirty[0]]).to(torch.int32) | (torch.cat([
        st.has_client[0], torch.zeros(ghosts, dtype=torch.bool, device=dev)
    ]).to(torch.int32) << 1)
    wr = torch.cat([st.aoi_radius[0], torch.full(
        (ghosts,), float("inf"), device=dev)])
    fh = aoi.front_half(g, pos_ext, torch.cat([st.alive[0], gvalid[0]]), n,
                        wr, flags, with_stats=True)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, pos_ext, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    torch.cuda.synchronize()
    if not (fh.lo.shape[0] == n < pos_ext.shape[0]):
        fail("the megaspace sweep check did not run Q < n")
    if not visits_every_row(fh):
        fail("the megaspace tile's sorted slot ids are not a permutation "
             "of its local + ghost rows")
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(1).sum())
        fail(f"fused sweep at Q={n} < n={pos_ext.shape[0]} differs from "
             f"its plain version in {bad} rows")
    tile_sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)

    # the phase kernel's times at the megaspace shape: the two phases of
    # one exchange of this state, captured at the wrapper
    phases = []

    def capture(*a):
        phases.append(a)
        ship(*a)

    ship = halo.ship_phase
    halo.ship_phase = capture
    try:
        exchange = (mc.shape, n, st.pos, st.yaw, dirty, visible, mc.tile_w,
                    mc.tile_d, g.radius, mc.halo_cap)
        halo.exchange_halo_2d(*exchange, impl="async")
    finally:
        halo.ship_phase = ship
    if [p[3] for p in phases] != [0, 2 * mc.halo_cap]:
        fail(f"exchange_halo_2d shipped phases at columns "
             f"{[p[3] for p in phases]}")
    plain_out = [o.clone() for o in phases[0][2]]
    for src, strips, out, col0 in phases:
        ship(src, strips, out, col0)
        halo.ship_phase_plain(src, strips, plain_out, col0)
    torch.cuda.synchronize()
    err = max(int((words(a) - words(b)).abs().max())
              for a, b in zip(phases[0][2], plain_out))
    if err != 0:
        fail("phase kernel differs from its plain version at timing inputs")

    def both(fn):
        return lambda: [fn(*p) for p in phases]

    def exchange_with(impl):
        return lambda: halo.exchange_halo_2d(*exchange, impl=impl)

    # events first: ms a phase (a call), the plain version, one exchange
    # under each impl; torch.roll of one packed phase-1 strip buffer, only
    # as context
    ship_ms = time_ms(both(ship), 100) / 2
    ship_plain = time_ms(both(halo.ship_phase_plain), 20) / 2
    ex = {impl: {"ms": time_ms(exchange_with(impl), 50)}
          for impl in halo.HALO_IMPLS}
    h = mc.halo_cap
    gp, gy, gd, gv, gg = phases[0][2]
    bufs = halo._pack_strip(gp[:, :h], gy[:, :h], gd[:, :h], gv[:, :h],
                            gg[:, :h])
    roll_ms = time_ms(lambda: torch.roll(bufs, mc.shape[1], 0), 200)
    # bytes a phase needs: every live row's flat word, pos, dirty and gid
    # (and yaw where dirty) read once, the counts, and every row of the
    # phase's 2H columns of the five lanes written (22 B)
    nbytes = 0
    for _, strips, out, col0 in phases:
        cols = slice(col0, col0 + 2 * h)
        live = int(out[3][:, cols].sum())
        nbytes += live * (4 + 12 + 1 + 4) + int(out[2][:, cols].sum()) * 4 \
            + 2 * n_dev * 4 + n_dev * 2 * h * 22
    bms, by = bound(nbytes / 2, n_dev * 2 * h)
    print(f"[9] fused sweep == plain at the megaspace shape (Q={n} local "
          f"queries over n={pos_ext.shape[0]} local + ghost rows, tile 0), "
          f"{tile_sweep_ms:.5f} ms a call; phase kernel {ship_ms:.5f} ms a "
          f"call, plain {ship_plain:.5f} ms, bound "
          f"{bms:.6f} ms ({by}; {nbytes / 2:.0f} B a phase); one "
          f"exchange_halo_2d a call: " + ", ".join(
              f"{impl} {r['ms']:.5f} ms" for impl, r in ex.items())
          + f"; torch.roll of a "
          f"packed strip i32{list(bufs.shape)} {roll_ms:.5f} ms (context); "
          f"device times in [12] {tag}", flush=True)
    row = {
        "name": "ship_phase", "route": "cuda",
        "source": "goworld_tpu_torch/csrc/halo_ship.cu",
        "replaces": "goworld_tpu/parallel/halo.py:91",
        "launches": launches["halo_ship_phase"],
        "launches_per_tick": launches["halo_ship_phase"] / MEGA_TICKS,
        "max_abs_err": err,
        "ms": ship_ms, "device_ms": None, "launches_per_call": None,
        "plain_ms": ship_plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None,
        "library_note": "no one PyTorch call ships a phase (gather, ring "
                        "shift, fill and in-place write); the yardstick is "
                        "one async exchange_halo_2d",
        "exchange": ex,
        "roll_ms_context": roll_ms,
    }

    def read_device() -> str:
        """The ship's, the exchanges' and the tile sweep's device times
        (torch.profiler), read in [12] after every timed path."""
        row["device_ms"], row["launches_per_call"] = (
            x / 2 for x in kernels.device_ms(both(ship), 50))
        for impl, r in ex.items():
            r["device_ms"], r["kernels_per_call"] = kernels.device_ms(
                exchange_with(impl), 20)
        sweep_dev, sweep_lpc = kernels.device_ms(
            lambda: aoi.sweep_fused_cuda(*args), 20)
        return (f"megaspace tile sweep {sweep_dev:.5f} ms ({sweep_lpc:g} "
                f"kernels); phase kernel "
                f"{row['device_ms'] * 1e3:.2f} us a call in "
                f"{row['launches_per_call']:g} kernel; one exchange_halo_2d "
                + ", ".join(f"{impl} {r['device_ms']:.5f} ms in "
                            f"{r['kernels_per_call']:g} kernels"
                            for impl, r in ex.items()))

    return row, read_device


def device_times(profiled: dict, rows: list, plan) -> tuple[dict, str]:
    """Fill the rows' ``device_ms`` and ``launches_per_call`` from
    torch.profiler and check the launches a call. A profiler session
    leaves the card's profiling interface attached, which slows every
    later launch of the host-bound ticks, so every profiled read runs
    here, after every timed path; they also follow each other closely,
    since the profiler's clock conversion drifts after a process's first
    session (``probe_profiler.py``)."""
    got = {name: kernels.device_ms(fn, 20)
           for name, fn in profiled.items()}
    for row in rows:
        row["device_ms"], row["launches_per_call"] = got[row["name"]]
    sweep_lpc = got["sweep_fused_cuda"][1]
    sort_lpc = got["counting_sort_cells_cuda"][1]
    if sweep_lpc != 1 or sort_lpc > plan[0] + 1:
        fail(f"kernel launches a call: sweep {sweep_lpc}, sort {sort_lpc} "
             f"(plan {plan} allows {plan[0] + 1})")
    return got, ", ".join(f"{name} {ms:.5f} ms ({lpc:g} kernels)"
                          for name, (ms, lpc) in got.items())


def small_oracle(dev) -> None:
    """[10] 2x2 tiles of 4096 entities, below every cap: after each of 3
    ticks every tile's interest lists equal a brute-force search over
    all tiles, in the watcher tile's shifted float32 frame as the sweep
    computes it. A few entities sit around the corner point so that
    pairs cross every kind of border."""
    r, tw, per = 50.0, 1200.0, 4096
    cap = per + 512
    grid = GridSpec(radius=r, extent_x=tw + 2 * r, extent_z=tw + 2 * r,
                    k=64, cell_cap=28, row_block=cap, sweep_impl="fused",
                    sort_impl="pallas", topk_impl="sort", skin=0.0)
    cfg = WorldConfig(capacity=cap, grid=grid, npc_speed=5.0,
                      enter_cap=65536, leave_cap=65536, sync_cap=65536,
                      attr_sync_cap=4096, input_cap=4096,
                      delta_rows_cap=65536)
    mc = MegaConfig(cfg=cfg, n_dev=4, tile_w=tw, halo_cap=512,
                    migrate_cap=256, mesh_shape=(2, 2), tile_d=tw,
                    halo_impl="async")
    st, inputs = mega_world(mc, 4 * per, SEED + 3, dev)
    rng = np.random.default_rng(SEED + 4)
    pos = st.pos.cpu().numpy()
    for d in range(4):
        sx, sz = (1 if d // 2 else -1), (1 if d % 2 else -1)
        pos[d, 300:308, 0] = tw + sx * rng.uniform(1, 20, 8)
        pos[d, 300:308, 2] = tw + sz * rng.uniform(1, 20, 8)
    st = st.replace(pos=torch.tensor(pos, device=dev))
    tick = make_mega_tick(mc, device=dev)
    shifts = tile_shifts(mc, dev).cpu().numpy()
    kinds = {"x": 0, "z": 0, "corner": 0}
    rows = 0
    for _ in range(3):
        st, out = tick(st, inputs)
        b = out.base
        if int(b.aoi_over_k_rows.sum()) or int(b.aoi_over_cap_cells.sum()) \
                or int(out.halo_demand.max()) > mc.halo_cap \
                or int(out.migrate_dropped.sum()) \
                or int(out.migrate_demand.max()) > mc.migrate_cap:
            fail("small oracle megaspace hit a cap")
        pos = st.pos.cpu().numpy()
        alive = st.alive.cpu().numpy()
        nbr = st.nbr.cpu().numpy()
        cnt = st.nbr_cnt.cpu().numpy()
        gid = np.arange(4)[:, None] * cap + np.arange(cap)[None, :]
        all_pos, all_gid = pos[alive], gid[alive]
        for d in range(4):
            other = all_pos - shifts[d]
            mine = pos[d] - shifts[d]
            for i in range(cap):
                got = nbr[d, i, :cnt[d, i]]
                if not alive[d, i]:
                    if cnt[d, i] or (nbr[d, i] != mc.gid_sentinel).any():
                        fail(f"dead slot {d}:{i} has neighbors")
                    continue
                near = np.maximum(np.abs(other[:, 0] - mine[i, 0]),
                                  np.abs(other[:, 2] - mine[i, 2])) \
                    <= np.float32(r)
                want = np.sort(all_gid[near & (all_gid != d * cap + i)])
                if not np.array_equal(got, want):
                    fail(f"tile {d} slot {i}: {len(got)} neighbors, oracle "
                         f"{len(want)}")
                rows += 1
                e = want // cap
                ex, ez = e // 2 != d // 2, e % 2 != d % 2
                kinds["x"] += int((ex & ~ez).sum())
                kinds["z"] += int((~ex & ez).sum())
                kinds["corner"] += int((ex & ez).sum())
    if min(kinds.values()) == 0:
        fail(f"the oracle world lacks a kind of border pair: {kinds}")
    print(f"[10] small megaspace oracle: 2x2 tiles of {per}, 3 ticks, "
          f"{rows} interest lists equal the brute force; cross-tile pairs "
          f"{kinds}", flush=True)

def peak_rss_mb() -> float:
    """This process's peak resident memory, MB (Linux reports KB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mb() -> float:
    """This process's resident memory now, MB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * resource.getpagesize() / 2**20


def release_worlds() -> None:
    """Collect the Worlds just dropped: ``serve_world`` froze them out
    of the collector, as a game server does at boot, so they are handed
    back and collected here, outside every timed or profiled run."""
    gc.unfreeze()
    gc.collect()


def first_space(obj):
    """The one Space's lanes of a World's stacked state or outputs."""
    return type(obj)(**{f.name: map_lane(getattr(obj, f.name),
                                         lambda t: t[0])
                        for f in dataclasses.fields(obj)})


def world_ticks(served, n_ticks: int, teleport: bool) -> tuple[list, dict]:
    """``n_ticks`` of staged traffic (walking syncs, or with ``teleport``
    the stress stream) and ``World.tick``; (per tick: wall s, span s,
    decoded and true counts, whether it took an audit sample; launch
    counts of the run). Every tick must launch the sweep and the sort
    once each and deliver what the World decoded."""
    w = served.world
    rows = []
    kernels.reset_launches()
    for t in range(n_ticks):
        staged = served.stage(teleport=teleport)
        before = dict(kernels.LAUNCHES)
        sample = w.audit is not None and w.audit.want_sample(w.tick_count)
        t0 = time.perf_counter()
        w.tick()
        wall = time.perf_counter() - t0
        got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if got != {"sweep_fused": 1, "counting_sort": 1,
                   "halo_ship_phase": 0, "npc_mlp": 0}:
            fail(f"World.tick {t + 1} launched {got}")
        out, ops, sink = w.last_outputs, w.op_stats, served.sink.take()
        if sink["sync_records"] != ops["sync_records_sent"] or \
                sink["sync_records"] <= 0:
            fail(f"World.tick {t + 1}: sync sink got "
                 f"{sink['sync_records']}, decode sent "
                 f"{ops['sync_records_sent']}")
        owned = [len(o) for o in w._slot_owner]
        # a pipelined World has decoded the previous tick's outputs,
        # while its slots hold this tick's creates (checked after its
        # drain by the caller)
        if not w.pipeline_decode and out.alive_count.tolist() != owned:
            fail(f"World.tick {t + 1}: {out.alive_count.tolist()} alive "
                 f"rows for {owned} entities with slots")
        cfg = w.cfg

        def to_cap(lane, cap):
            # decodable (each Space's count up to its cap) and true
            v = getattr(out, lane)
            return int(np.minimum(v, cap).sum()), int(v.sum())

        migrated = None
        if "migrations" in staged:
            migrated = served.migrated()
            if migrated != staged["migrations"] or w._staged_migrate:
                fail(f"World.tick {t + 1}: {migrated} of "
                     f"{staged['migrations']} staged migrations applied")
        rows.append(dict(
            wall=wall, staged=staged, sample=sample, migrated=migrated,
            spans={name: d for name, _, d, _ in
                   metrics.timeline.records()[-1][2]},
            sync=(ops["sync_records_sent"], *to_cap("sync_n", cfg.sync_cap)),
            enter=(ops["aoi_enter_decoded"],
                   *to_cap("enter_n", cfg.enter_cap)),
            leave=(ops["aoi_leave_decoded"],
                   *to_cap("leave_n", cfg.leave_cap)),
            delta_rows=int(out.delta_rows_n.max()),
            messages=sink["messages"]))
    if min(r["enter"][0] for r in rows) <= 0 or any(
            r[k][0] > r[k][1] for r in rows for k in ("sync", "enter",
                                                     "leave")):
        fail("the World decoded no enters, or more than the outputs hold")
    return rows, dict(kernels.LAUNCHES)


def world_summary(rows: list, cfg) -> str:
    """``World.tick`` p50/p99 over ticks 2.., the ticks that took an
    audit sample and the ticks after them apart, the mean of its spans,
    and the records, events and changed interest rows a tick."""
    steady = rows[1:]
    wall = np.array([r["wall"] for r in steady]) * 1e3
    sampled = np.array([r["sample"] for r in steady])
    after = np.array([r["sample"] for r in rows[:-1]])
    spans = {k: float(np.mean([r["spans"][k] for r in steady])) * 1e3
             for k in steady[0]["spans"]}
    fetch = np.array([r["spans"]["fetch_outputs"] for r in steady]) * 1e3
    mean = {k: " / ".join(map(str, np.mean([r[k] for r in steady], axis=0)
                               .round(1).tolist()))
            for k in ("sync", "enter", "leave")}
    dr = [r["delta_rows"] for r in steady]
    return (f"World.tick wall p50={np.percentile(wall, 50):.3f} "
            f"p99={np.percentile(wall, 99):.3f} ms (ticks 2-{len(rows)}); "
            f"audit-sample ticks {np.round(wall[sampled], 3).tolist()} ms,"
            f" the ticks after them "
            f"{np.round(wall[after & ~sampled], 3).tolist()} ms, the rest "
            f"{pct(wall, ~sampled & ~after)} ms; fetch_outputs on the "
            f"sample ticks (their audit planes ride it) "
            f"{np.round(fetch[sampled], 3).tolist()} ms, on the rest "
            f"mean {fetch[~sampled].mean():.3f} ms; "
            f"mean span ms " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in spans.items())
            + f"; a tick (mean of 2-{len(rows)}), decoded / to cap / true: "
            f"sync records {mean['sync']}, enters {mean['enter']}, leaves "
            f"{mean['leave']}; rows whose interest list changed (the most "
            f"of a Space) mean {np.mean(dr):.1f} max {max(dr)} of "
            f"delta_rows_cap {cfg.delta_rows_cap}; client messages of the "
            f"last tick {rows[-1]['messages']}")


def event_timed(fn, events: list, keep: dict | None = None):
    """``fn`` with CUDA events recorded around each call into ``events``
    (and its last arguments into ``keep``)."""
    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        events.append((a, b))
        if keep is not None:
            keep["args"] = args
        return out

    return timed


def event_ms(events: list) -> str:
    ms = np.array([a.elapsed_time(b) for a, b in events])
    return (f"mean {ms.mean():.5f} p50 {np.percentile(ms, 50):.5f} max "
            f"{ms.max():.5f} ms over {ms.size} calls")


def unkeyed(sig: dict | None) -> dict | None:
    """A signature less its kernel-config key (twins differ in it)."""
    return None if sig is None else {k: v for k, v in sig.items()
                                     if k != "config"}


def audit_state(w) -> dict:
    """The audit plane's counts once its worker is idle."""
    w.audit.drain()
    snap = w.audit.snapshot(tick=w.tick_count)
    return dict(oracle=snap["oracle"], probes=snap["probes"],
                violations=snap["violations_total"],
                dropped=snap["samples_dropped"])


def planes_check(w, label: str) -> str:
    """[11]'s and [15]'s checks of the planes of a World at its
    defaults: the lanes account for every tick (rebuilt sums to the tick
    count, occupancy to it times the Spaces, per_tile is the host's
    count of entities with slots in each Space), a
    signature is served, every audit sample judged its cohort with 0
    mismatches and 0 violations, and the census reads 0 re-allocated
    lanes."""
    lanes = w._telem_lanes
    ticks = w.tick_count
    # occupancy takes one sample a Space a tick
    for lane, per in (("rebuilt", 1), ("occupancy", w.n_spaces)):
        if sum(lanes[lane]["counts"]) != ticks * per:
            fail(f"{label}: lane {lane} holds {sum(lanes[lane]['counts'])}"
                 f" samples for {ticks} ticks of {per} samples")
    owned = [len(o) for o in w._slot_owner]
    if lanes["occupancy"]["per_tile"] != owned:
        fail(f"{label}: per_tile {lanes['occupancy']['per_tile']} != "
             f"{owned} entities with slots")
    sig = w.workload_signature()
    if sig is None or "error" in sig:
        fail(f"{label}: no workload signature ({sig})")
    aud = audit_state(w)
    o = aud["oracle"]
    if o["samples"] <= 0 or o["mismatches"] or aud["probes"]["mismatches"] \
            or aud["violations"]:
        fail(f"{label}: audit {aud}")
    census = w.residency.census_snapshot()
    if census["samples"] <= 0 or census["realloc"] or \
            census["skipped_deleted"]:
        fail(f"{label}: census {census}")
    return (f"lanes hold all {ticks} ticks (per_tile "
            f"{lanes['occupancy']['per_tile']}), signature {sig['sig']}; "
            f"audit {o['samples']} samples, {o['entities_checked']} "
            f"entities judged, 0 mismatches, skipped {o['skipped']}, "
            f"dropped on a busy worker {aud['dropped']}, probes "
            f"{aud['probes']}; census {census['samples']} samples, "
            f"{len(census['aliased'])} lanes, 0 re-allocated")


def world_phase(dev, bare: tuple[float, float], tag: str,
                profiled: dict, eager: dict) -> tuple[dict, object]:
    """[11] the serving World at 2^20 slots at its defaults (the planes
    on, the carry resident) under its game traffic (its p50, p99 and
    spans into ``eager``; then [18]'s pipelined ticks), then the stress
    stream, its step and fold under the sync guard against the plain
    versions on a clone, and twin Worlds at 2^16 (with [18]'s third,
    pipelined); returns each run's launches and the served World (for
    [18]), and adds the fold and the carry copy to ``profiled``."""
    phase0 = time.perf_counter()
    rss0 = rss_mb()
    served = serve_world(N, SEED, dev, boot=True, world_kw=PLANES)
    w = served.world
    rss_pop = rss_mb()
    n_pop = len(w.entities) - 2  # less the nil space and the arena
    boot_aud = audit_state(w)
    if boot_aud["oracle"]["mismatches"] or boot_aud["violations"]:
        fail(f"audit during the boot: {boot_aud}")
    fold_ev, carry_ev, fold_args, carry_args = [], [], {}, {}
    real_fold, real_carry = w._telem_fn, manager._carry_into
    w._telem_fn = event_timed(real_fold, fold_ev, fold_args)
    manager._carry_into = event_timed(real_carry, carry_ev, carry_args)
    rows, launches = world_ticks(served, WORLD_TICKS, teleport=False)
    w._telem_fn, manager._carry_into = real_fold, real_carry
    wall = np.array([r["wall"] for r in rows[1:]]) * 1e3
    eager.update(p50=float(np.percentile(wall, 50)),
                 p99=float(np.percentile(wall, 99)),
                 spans={k: round(float(np.mean([r["spans"][k]
                                                for r in rows[1:]])) * 1e3, 3)
                        for k in rows[1]["spans"]})
    for name in ("pos", "vel"):
        if not torch.isfinite(getattr(w.state, name)).all():
            fail(f"non-finite {name} in the World's state")
    # the hot attr the last tick set twice landed on the device
    mobs = [w.entities[e] for e in served.mobs[:256]]
    slots = torch.tensor([e.slot for e in mobs], device=dev)
    dev_hp = w.state.hot_attrs[0, slots, 0].cpu().numpy()
    if not np.array_equal(dev_hp, np.array([e.attrs["hp"] for e in mobs],
                                           np.float32)):
        fail("the device's hot attrs differ from the entities' hp")
    game_planes = planes_check(w, "game traffic")
    print(f"[11] serving World at its defaults (telemetry, residency every "
          f"{PLANES['residency_sample_every']}, audit every "
          f"{PLANES['audit_sample_every']} ticks of "
          f"{w.audit.cohort}, resident carry): {n_pop} entities "
          f"({served.players.size} players with clients) created through "
          f"Space.create_entity and booted through {served.boot_ticks} "
          f"ticks ({served.boot_events} enter events, none past a cap; "
          f"audit during the boot {boot_aud['oracle']}) in "
          f"{served.populate_s:.2f} s; host RSS {rss0:.0f} MB before, "
          f"{rss_pop:.0f} MB after (+{rss_pop - rss0:.0f}); game traffic: "
          f"{WORLD_TICKS} World.ticks staging {rows[-1]['staged']} each "
          f"(each sync a step from where its player stands; hp set twice "
          f"on 64 mobs), launches {launches}, one sweep and one sort a "
          f"tick; {world_summary(rows, w.cfg)}; the fold by events "
          f"{event_ms(fold_ev)}, the resident carry copy by events "
          f"{event_ms(carry_ev)}; planes: {game_planes}; [5]'s bare tick "
          f"p50={bare[0]:.3f} p99={bare[1]:.3f} ms; the World.tick "
          f"without the planes (PERF.md runs AC, AE) p50 191.5, 368.0 p99 "
          f"249.2, 454.3 ms {tag}", flush=True)
    pipe_launches = pipelined_part(served, eager, tag)
    # the fold and the carry copy of the last game tick, for [12]
    acc0 = telem.telemetry_init(False, occupancy=True, device=dev)
    f_outs = fold_args["args"][1]
    profiled["World telemetry fold"] = \
        lambda acc=acc0, o=f_outs: telem.telemetry_update_live(acc, o)
    c_dst, c_src = carry_args["args"]
    dst = c_dst.apply(torch.clone)
    src = dst.replace(**{
        f.name: getattr(c_src, f.name).clone()
        for f in dataclasses.fields(c_src)
        if getattr(c_src, f.name) is not None
        and getattr(c_src, f.name).data_ptr()
        != getattr(c_dst, f.name).data_ptr()})
    profiled["World resident carry copy"] = \
        lambda d=dst, c=src: manager._carry_into(d, c)
    del fold_args, carry_args, c_dst, c_src, f_outs

    before = audit_state(w)["oracle"]
    stress, stress_launches = world_ticks(served, STRESS_TICKS,
                                          teleport=True)
    after = audit_state(w)["oracle"]
    print(f"[11] serving World, stress stream: {STRESS_TICKS} World.ticks "
          f"whose syncs teleport their players to uniform points (the "
          f"bench's input stream), launches {stress_launches}; "
          f"{world_summary(stress, w.cfg)}; changed rows past "
          f"delta_rows_cap (their events dropped, the interest sets "
          f"degraded) on "
          f"{sum(r['delta_rows'] > w.cfg.delta_rows_cap for r in stress)}"
          f" of {STRESS_TICKS} ticks, and the audit's samples over the "
          f"stream found {after['mismatches'] - before['mismatches']} "
          f"mismatches in "
          f"{after['entities_checked'] - before['entities_checked']} "
          f"entities judged; host peak RSS {peak_rss_mb():.0f} MB {tag}",
          flush=True)

    # one tick whose step and fold run under the sync guard, the step
    # on a clone too
    real, cap = w._step, {}

    def probe(state, inputs, policy=None):
        cap["state"] = state.apply(torch.clone)
        cap["inputs"] = type(inputs)(**{
            f.name: getattr(inputs, f.name).clone()
            for f in dataclasses.fields(inputs)})
        torch.cuda.set_sync_debug_mode("error")
        new = real(state, inputs, policy)
        # the resident step returns the carry it wrote in place: keep
        # what it wrote before the next tick writes it again
        cap["new"] = (new[0].apply(torch.clone), new[1])
        return new

    def fold_probe(acc, outs):
        try:
            return real_fold(acc, outs)
        except Exception as exc:  # the World would disable its lanes
            cap["fold_error"] = exc
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")

    w._step, w._telem_fn = probe, fold_probe
    served.stage()
    w.tick()
    w._step, w._telem_fn = real, real_fold
    if "fold_error" in cap or w._telem_fn is None:
        fail(f"the fold under the sync guard: {cap.get('fold_error')}")
    plain = make_tick(slice_config(N, sweep_impl="ranges",
                                   sort_impl="argsort"), device=dev)
    st_p, out_p = plain(first_space(cap["state"]),
                        first_space(cap["inputs"]))
    st_w, out_w = first_space(cap["new"][0]), first_space(cap["new"][1])
    for what, a, b in (("state", st_w, st_p), ("output", out_w, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"World step {what} lane {name}: kernels != plain "
                     f"versions (ranges/argsort)")
    # the World's one-copy fetch against a plain copy of each lane
    fetched = {f.name: getattr(w.last_outputs, f.name)
               for f in dataclasses.fields(w.last_outputs)}
    fetched["state.pos"], fetched["state.yaw"], fetched["state.alive"] = \
        w._dget([w.state.pos, w.state.yaw, w.state.alive])
    plain_copy = dict(lanes(cap["new"][1]), **{
        "state.pos": w.state.pos, "state.yaw": w.state.yaw,
        "state.alive": w.state.alive})
    for name, t in plain_copy.items():
        a, b = np.asarray(fetched[name]), t.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            fail(f"the World's fetch of {name} differs from .cpu()")
    # one judged audit sample at 2^20, timed: a sample of a full world
    # is skipped above (its sweep has cells past cell_cap every tick, and
    # the oracle is exact only without), so a scratch plane whose
    # ledger holds the World's census judges one with that
    # precondition lifted; its verdicts are timed, not checked
    real_ap, gauges = w.audit, {k: w.op_stats[k] for k in (
        "aoi_over_k_rows", "aoi_over_cap_cells")}
    scratch = audit_mod.AuditPlane("timing", cohort=real_ap.cohort)
    scratch.ledger.resync({k: e.type_name for k, e in w.entities.items()
                           if not e.destroyed}, w.tick_count)
    t0 = time.perf_counter()
    aud_planes = tuple(w._dget([w.state.pos[0], w.state.alive[0],
                                w.state.aoi_radius[0]]))
    t1 = time.perf_counter()
    w.audit = scratch
    w.op_stats.update(dict.fromkeys(gauges, 0))
    w._audit_sample(aud_planes)
    t2 = time.perf_counter()
    scratch.drain()
    t3 = time.perf_counter()
    w.audit = real_ap
    w.op_stats.update(gauges)
    judged = scratch.oracle_stats
    scratch.close()
    print(f"[11] one judged audit sample of the World ({N} slots, "
          f"cohort {real_ap.cohort}), by the host's clock: its planes' "
          f"fetch alone {(t1 - t0) * 1e3:.3f} ms "
          f"({sum(a.nbytes for a in aud_planes)} B), the capture on the "
          f"logic thread {(t2 - t1) * 1e3:.3f} ms, the oracle on the "
          f"worker {(t3 - t2) * 1e3:.3f} ms ({judged['entities_checked']}"
          f" entities judged, {judged['mismatches']} mismatches, which "
          f"the cells past cell_cap allow) {tag}", flush=True)
    del w, cap, st_p, out_p, st_w, out_w, aud_planes

    # twin Worlds of 2^16 slots at their defaults: kernels against plain
    # versions
    # versions, and ([18]) a third on the kernels with its decode
    # pipelined
    twins = {impl: serve_world(TWIN_N, SEED + 1, dev, record_hooks=True,
                               keep=True, boot=True, world_kw=dict(
                                   PLANES, pipeline_decode=impl[2]),
                               sweep_impl=impl[0], sort_impl=impl[1])
             for impl in (("fused", "pallas", False),
                          ("ranges", "argsort", False),
                          ("fused", "pallas", True))}
    (kern, plain_w, pipe) = twins.values()
    counts = {"hooks": 0, "sync records": 0, "messages": 0}
    twin_launches = {}
    kern_kept, pipe_kept, kern_hooks = [], [], []
    for t in range(TWIN_TICKS):
        lanes_before = kern.world._telem_lanes
        for name, sv in zip(("kernels", "plain", "pipelined"),
                            (kern, plain_w, pipe)):
            sv.stage(teleport=t % 2 == 1)
            kernels.reset_launches()
            sv.world.tick()
            twin_launches.setdefault(name, []).append(
                kernels.LAUNCHES["sweep_fused"]
                + kernels.LAUNCHES["counting_sort"])
        a, b = kern.sink.take()["kept"], plain_w.sink.take()["kept"]
        kern_kept += a
        pipe_kept += pipe.sink.take()["kept"]
        kern_hooks += kern.hooks
        if len(a) != len(b) or any(
                x[0] != y[0] or x[1] != y[1] or not (
                    all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
                        for u, v in zip(x[2:], y[2:])) if x[0] == "sync"
                    else x[2:] == y[2:]) for x, y in zip(a, b)):
            fail(f"twin Worlds' sinks differ at tick {t + 1}")
        if kern.hooks != plain_w.hooks:
            fail(f"twin Worlds' hook calls differ at tick {t + 1}")
        sa = interop.state_to_numpy(kern.world.state)
        sb = interop.state_to_numpy(plain_w.world.state)
        if any(sa[k].tobytes() != sb[k].tobytes() for k in sa):
            fail(f"twin Worlds' states differ at tick {t + 1}")
        ka, kb = kern.world, plain_w.world
        if ka._telem_lanes != kb._telem_lanes or any(
                unkeyed(getattr(ka, sig)()) != unkeyed(getattr(kb, sig)())
                for sig in ("workload_signature", "window_signature")):
            fail(f"twin Worlds' telemetry lanes or signatures differ at "
                 f"tick {t + 1}")
        if audit_state(ka) != audit_state(kb) or \
                ka.audit.ledger.snapshot(tick=t) != \
                kb.audit.ledger.snapshot(tick=t):
            fail(f"twin Worlds' audit stats or ledgers differ at tick "
                 f"{t + 1}")
        counts["hooks"] += len(kern.hooks)
        counts["sync records"] += sum(len(x[2]) for x in a
                                      if x[0] == "sync")
        counts["messages"] += sum(1 for x in a if x[0] == "msg")
        kern.hooks.clear()
        plain_w.hooks.clear()
    if twin_launches != {"kernels": [2] * TWIN_TICKS,
                         "plain": [0] * TWIN_TICKS,
                         "pipelined": [2] * TWIN_TICKS}:
        fail(f"twin launches a tick {twin_launches}")
    twin_aud = audit_state(kern.world)["oracle"]
    pipe.world.flush_pending_outputs()
    pipe_kept += pipe.sink.take()["kept"]
    check_pipelined_twin(kern, pipe, kern_kept, pipe_kept, kern_hooks,
                         lanes_before, tag)
    del twins, kern, plain_w, pipe, kern_kept, pipe_kept, kern_hooks
    release_worlds()
    secs = time.perf_counter() - phase0
    print(f"[11] World step on the kernels == make_tick on ranges/argsort "
          f"bit for bit (a clone of its state and flushed inputs, the step "
          f"and the telemetry fold under the sync guard); its one-copy "
          f"fetch of every output lane and of pos, yaw and alive == .cpu() "
          f"bit for bit; twin Worlds of {TWIN_N} slots at their defaults "
          f"(kernels, plain versions) equal in sinks, hooks, state, "
          f"telemetry lanes, workload and window signatures, audit stats "
          f"and ledgers for {TWIN_TICKS} ticks, walking and stress syncs in "
          f"turns ({counts}; audit {twin_aud}); phase {secs:.1f} s {tag}",
          flush=True)
    return {"world": launches, "world_stress": stress_launches,
            "world_pipelined": pipe_launches}, served


def pipelined_ticks(served, n_ticks: int) -> tuple[list, dict, dict]:
    """:func:`world_ticks` on a pipelined World, counting its host syncs
    (each tick's wait for the copy of the previous tick's outputs, and
    the decode's reads of the live positions and headings, which wait
    for the step in flight, as the reference's decode does: at most one
    of each a tick), then its drain: the slots' owners against the
    drained tick's alive rows."""
    w = served.world
    served.stage()
    w.tick()  # primes the pipeline: every timed tick decodes one
    syncs = {"copy waits": 0, "other reads": 0}  # pos/yaw caches
    real_finish, real_dget = w._finish_copy, w._dget

    def finish(pending):
        syncs["copy waits"] += 1
        return real_finish(pending)

    def dget(lanes_):
        syncs["other reads"] += 1
        return real_dget(lanes_)

    w._finish_copy, w._dget = finish, dget
    rows, launches = world_ticks(served, n_ticks, teleport=False)
    w._finish_copy, w._dget = real_finish, real_dget
    if syncs["copy waits"] != n_ticks or \
            syncs["other reads"] > 2 * n_ticks:
        fail(f"[18] pipelined World host syncs in {n_ticks} ticks: {syncs}")
    w.flush_pending_outputs()
    owned = [len(o) for o in w._slot_owner]
    if w.last_outputs.alive_count.tolist() != owned:
        fail(f"[18] drained: {w.last_outputs.alive_count.tolist()} alive "
             f"rows for {owned} entities with slots")
    return rows, launches, syncs


def window_over_cap(spec: GridSpec, pos, alive, watch_radius):
    """bool[N]: rows one of whose 9 window cells holds more than
    cell_cap entities (where the table, which keeps a cell's first
    cell_cap, and the runs of ``ranges``/``fused`` may part)."""
    cx, cz, srow, _, czp, n_rows = aoi._cell_rows(spec, pos, alive,
                                                  watch_radius)
    occ = torch.zeros(n_rows + 1, dtype=torch.int32, device=pos.device)
    occ.index_add_(0, srow.long(), torch.ones_like(srow))
    d = torch.arange(-1, 2, device=pos.device)
    rows = ((cx[:, None, None] + d[None, :, None] + 1) * czp
            + cz[:, None, None] + d[None, None, :] + 1)
    return (occ[rows.reshape(-1, 9).long()] > spec.cell_cap).any(1)


def pipelined_part(served, eager: dict, tag: str) -> dict:
    """[18] the first part, run inside [11] on its World right after its
    game ticks: the decode pipelined from here (the knob is read each
    tick; the eager decode has just drained), WORLD_TICKS ticks of the
    same traffic, the planes, one tick's step and fold under the sync
    guard; then drained and eager again for WORLD_TICKS more ticks (the
    runs in turns: eager, pipelined, eager) and [11]'s remaining paths.
    Returns the pipelined run's launches."""
    t0 = time.perf_counter()
    w = served.world
    before = audit_state(w)["oracle"]
    census0 = w.residency.census_snapshot()["samples"]
    w.pipeline_decode = True
    rows, launches, syncs = pipelined_ticks(served, WORLD_TICKS)
    # the planes: the lanes lag the decode by one tick's accumulator,
    # the audit records a skip for every sample tick
    lanes_ = w._telem_lanes
    held = w.tick_count - 1
    if sum(lanes_["rebuilt"]["counts"]) != held or \
            sum(lanes_["occupancy"]["counts"]) != held:
        fail(f"[18] pipelined lanes hold {sum(lanes_['rebuilt']['counts'])}"
             f" samples for {held} drained ticks")
    aud = audit_state(w)
    skipped = aud["oracle"]["skipped"].get("pipeline_decode", 0)
    census = w.residency.census_snapshot()
    if aud["oracle"]["samples"] != before["samples"] or skipped <= 0 \
            or aud["violations"]:
        fail(f"[18] pipelined audit {aud}")
    if census["samples"] <= census0 or census["realloc"]:
        fail(f"[18] pipelined census {census}")
    if w.workload_signature() is None:
        fail("[18] the pipelined World serves no signature")
    # one tick whose step and fold run under the sync guard
    real_step, real_fold, cap = w._step, w._telem_fn, {}

    def guarded(state, inputs, policy=None):
        torch.cuda.set_sync_debug_mode("error")
        return real_step(state, inputs, policy)

    def fold_guarded(acc, outs):
        try:
            return real_fold(acc, outs)
        except Exception as exc:  # the World would disable its lanes
            cap["fold_error"] = exc
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")

    w._step, w._telem_fn = guarded, fold_guarded
    served.stage()
    w.tick()
    w._step, w._telem_fn = real_step, real_fold
    if "fold_error" in cap or w._telem_fn is None:
        fail(f"[18] the fold under the sync guard: {cap.get('fold_error')}")
    w.flush_pending_outputs()
    served.sink.take()
    w.pipeline_decode = False
    # eager again for as many ticks, so that the order of the runs on
    # the World (eager, pipelined, eager) is seen in their times
    again, _ = world_ticks(served, WORLD_TICKS, teleport=False)
    wall = np.array([r["wall"] for r in rows[1:]]) * 1e3
    p50, p99 = float(np.percentile(wall, 50)), float(np.percentile(wall, 99))
    wall2 = np.array([r["wall"] for r in again[1:]]) * 1e3
    spans2 = {k: round(float(np.mean([r["spans"][k] for r in again[1:]]))
                       * 1e3, 3) for k in again[1]["spans"]}
    print(f"[18] pipelined decode on [11]'s World right after its game "
          f"ticks (pipeline_decode turned on between ticks): "
          f"{WORLD_TICKS} World.ticks of the same traffic, launches "
          f"{launches}, one sweep and one sort a tick; host syncs {syncs} "
          f"(a tick: one wait for the copy of the previous tick's outputs,"
          f" and the decode's reads of the live positions and headings "
          f"for clients' enter messages, which wait for the step in "
          f"flight as the reference's do; the step and the fold under the"
          f" sync guard raise none); {world_summary(rows, w.cfg)}; "
          f"against [11]'s eager World.tick p50={eager['p50']:.3f} "
          f"p99={eager['p99']:.3f} ms, spans {eager['spans']}: p50 "
          f"{p50 - eager['p50']:+.3f} ms, p99 {p99 - eager['p99']:+.3f} "
          f"ms; then eager again for {WORLD_TICKS} ticks: p50="
          f"{np.percentile(wall2, 50):.3f} p99={np.percentile(wall2, 99):.3f}"
          f" ms, spans {spans2}; planes: lanes hold the {held} drained "
          f"ticks, the audit "
          f"skipped {skipped} sample ticks as pipeline_decode, census "
          f"{census['samples']} samples, 0 re-allocated; "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def planes_phase(dev, served, tag: str) -> dict:
    """[18] the rest, on [11]'s World after its ticks: freeze and the
    snapshot chain, a restore into a fresh World at the uncut config's
    skin and the governor's swaps on that World; returns each path's
    launches."""
    import shutil
    import tempfile

    from goworld_tpu_torch import freeze
    from goworld_tpu_torch.workload import _game_types

    phase0 = time.perf_counter()
    w = served.world
    gc.freeze()  # as serve_world left it: [11]'s twins unfroze it
    # freeze and the snapshot chain on this World, after its ticks
    out_dir = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    t0 = time.perf_counter()
    handle = freeze.checkpoint_async(w, out_dir)
    t_ret = time.perf_counter() - t0
    for _ in range(2):  # the World ticks on while the worker writes
        served.stage()
        w.tick()
    handle.join(900)
    chain = freeze.SnapshotChain(w, out_dir, keyframe_every=8)
    recs, chain_ms = {}, {}
    for step in ("key", "delta"):
        if step == "delta":
            for _ in range(8):
                served.stage()
                w.tick()
        t0 = time.perf_counter()
        captured = chain.capture()
        t1 = time.perf_counter()
        data, _tick = chain.complete_capture(captured)
        kind, rec = chain.build(data)
        path = chain.write_record(kind, rec)
        t2 = time.perf_counter()
        if kind != step:
            fail(f"[18] the chain wrote a {kind} for a {step}")
        # a delta resolves against its keyframe's planes alone: the
        # keyframe's host section (a million records) goes at once
        recs[step] = rec if step == "delta" else {"kind": "key",
                                                  "planes": rec["planes"]}
        del rec
        chain_ms[step] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          os.path.getsize(path))
    src_ents = len(recs["delta"]["host"]["entities"])
    shipped = int((np.frombuffer(recs["delta"]["rows"], np.int32) < 0)
                  .sum())
    t0 = time.perf_counter()
    w.audit.scrub_snapshots(out_dir, w.game_id, w.tick_count)
    scrub_s = time.perf_counter() - t0
    scrub = dict(w.audit.scrub_stats)
    if scrub["files"] != 2 or scrub["corrupt"]:
        fail(f"[18] scrub of the chain: {scrub}")
    print(f"[18] freeze on [11]'s World after its ticks ({src_ents} "
          f"entities): checkpoint_async capture on the tick thread "
          f"{handle.capture_s * 1e3:.1f} ms (returned in "
          f"{t_ret * 1e3:.1f} ms), worker {handle.worker_s:.2f} s, "
          f"{handle.nbytes} B; SnapshotChain keyframe capture "
          f"{chain_ms['key'][0]:.1f} ms on the tick thread, fetch + build "
          f"+ write {chain_ms['key'][1]:.1f} ms, {chain_ms['key'][2]} B; "
          f"8 ticks on, delta capture {chain_ms['delta'][0]:.1f} ms, "
          f"{chain_ms['delta'][1]:.1f} ms, {chain_ms['delta'][2]} B "
          f"({shipped} of {src_ents} rows shipped); scrub_snapshots "
          f"{scrub} in {scrub_s:.1f} s {tag}", flush=True)
    del served, w, handle, chain, captured, data
    release_worlds()

    # restore into a fresh World of 2^20 slots at the uncut config's skin
    want = chain_planes(recs)
    data = freeze.resolve_record(recs["delta"], recs["key"])
    ucfg = uncut_config(N)
    rw = manager.World(ucfg, seed=SEED, device=dev, **PLANES)
    for name, cls in zip(("Mob", "Player", "Arena"), _game_types(None)):
        (rw.register_space if name == "Arena" else rw.register_entity)(
            name, cls)
    rw.create_nil_space()
    t0 = time.perf_counter()
    freeze.restore_world(rw, data)
    restore_s = time.perf_counter() - t0
    # the restored World's staged poses, quantized as the chain
    # quantizes them, are the source's lattice planes byte for byte (its
    # moving flags are staged with the spawns: checked on the device
    # after the first tick)
    ents = [rw.entities[e["id"]] for e in data["entities"]]
    got = staged_planes(ents, freeze.SnapshotChain(rw, out_dir))
    for nm in ("pos_xz", "pos_y", "yaw"):
        if got[nm] != want[nm]:
            fail(f"[18] the restored World's {nm} plane differs from the "
                 f"source's lattice plane")
    del ents, got
    shutil.rmtree(out_dir)
    restored, rebuilt = [], []
    for t in range(RESTORED_TICKS):
        kernels.reset_launches()
        rw.tick()
        restored.append(dict(kernels.LAUNCHES))
        rebuilt.append(int(rw.last_outputs.aoi_rebuilt[0]))
        if t == 0:
            ents = [rw.entities[e["id"]] for e in data["entities"]]
            got = rw.state.npc_moving[0].cpu().numpy()[
                [e.slot for e in ents]]
            if got.astype(np.uint8).tobytes() != want["moving"]:
                fail("[18] the restored World's moving flags differ from "
                     "the source's plane")
            del ents, got
    del want
    if any(r != {"sweep_fused": 1, "counting_sort": 1,
                 "halo_ship_phase": 0, "npc_mlp": 0} for r in restored):
        fail(f"[18] restored World launches a tick {restored}")
    if rebuilt[0] != 1:
        fail("[18] the restored World's first tick did not rebuild its "
             "Verlet cache")
    # the players never move on their own: their rows hold the restored
    # lattice positions and headings after the ticks
    rec_by_id = {e["id"]: e for e in data["entities"]}
    # (those whose staged pose has landed: the restore stages one a
    # slot, and input_cap of them land a tick)
    players = [e for e in rw.entities.values()
               if e.type_name == "Player" and e.slot is not None
               and e._pending_pos is None]
    slots = torch.tensor([e.slot for e in players], device=dev)
    got_pos = rw.state.pos[0, slots].cpu().numpy()
    got_yaw = rw.state.yaw[0, slots].cpu().numpy()
    ref_pos = np.array([rec_by_id[e.id]["pos"] for e in players],
                       np.float32)
    ref_yaw = np.array([rec_by_id[e.id]["yaw"] for e in players],
                       np.float32)
    if not (np.array_equal(got_pos, ref_pos)
            and np.array_equal(got_yaw, ref_yaw)):
        fail("[18] the restored players' rows differ from the source's "
             "lattice planes")
    print(f"[18] restore into a fresh World of {N} slots (the uncut "
          f"config, skin {ucfg.grid.skin}): {len(data['entities'])} "
          f"entities in {restore_s:.2f} s; its staged poses == the "
          f"source's lattice planes byte for byte "
          f"(pos_xz, pos_y, yaw; its device moving flags after the first "
          f"tick, moving); "
          f"{RESTORED_TICKS} ticks, launches a tick "
          f"{restored[-1]}, Verlet rebuilds {rebuilt}; "
          f"{len(players)} players' rows == their restored lattice pos "
          f"and yaw ({len(rw._staged_pos)} poses still staged at "
          f"input_cap {ucfg.input_cap} a tick) {tag}", flush=True)
    del data, rec_by_id, recs
    launches_by = {"restored": {k: sum(r[k] for r in restored)
                                for k in restored[0]}}
    launches_by.update(governor_swaps(dev, rw, tag))
    del rw
    release_worlds()
    print(f"[18] phase {time.perf_counter() - phase0:.1f} s {tag}",
          flush=True)
    return launches_by


def staged_planes(ents, chain) -> dict:
    """The pos_xz, pos_y and yaw planes of ``ents``' staged poses (a
    restore stages each entity's pose), quantized as
    ``freeze._extract_planes`` quantizes a record's, in numpy."""
    from goworld_tpu_torch import freeze

    pos = np.array([e._pending_pos for e in ents], np.float64)
    yaw = np.array([e._pending_yaw for e in ents], np.float64)
    (ox, oz), step = chain.origin, chain.step
    qxz = np.clip(np.floor((pos[:, [0, 2]] - (ox, oz)) / step), 0, 32767)
    qyaw = (np.round(yaw / freeze.YAW_STEP).astype(np.int64) & 0xFFFF) \
        .astype(np.uint16).view(np.int16)
    return {"pos_xz": qxz.astype(np.int16).tobytes(),
            "pos_y": pos[:, 1].astype(np.float32).tobytes(),
            "yaw": qyaw.tobytes()}


def chain_planes(recs: dict) -> dict:
    """The quantized planes the chain's delta record resolves to (its
    rows taken from the keyframe or its own sparse section)."""
    rows = np.frombuffer(recs["delta"]["rows"], np.int32)
    ref = rows >= 0
    out = {}
    for nm, (dt, wd) in (("pos_xz", (np.int16, 2)),
                         ("pos_y", (np.float32, 1)),
                         ("yaw", (np.int16, 1)), ("moving", (np.uint8, 1))):
        kp = np.frombuffer(recs["key"]["planes"][nm], dt).reshape(-1, wd)
        sp = np.frombuffer(recs["delta"]["sparse"][nm], dt).reshape(-1, wd)
        o = np.zeros((rows.size, wd), dt)
        o[ref] = kp[rows[ref]]
        o[~ref] = sp
        out[nm] = o.tobytes()
    return out


def governor_swaps(dev, rw, tag: str) -> dict:
    """[18] the governor on ``rw`` (2^20 slots at the uncut config's
    skin): every default candidate warmed, then commits forced through
    ``default -> skin=0 -> sweep=table,skin=0 -> sort=counting,skin=0 ->
    default``; each swap's first tick held bit for bit against a fresh
    ``make_tick`` at the target config on a clone of the carried state,
    and the launches of each config's ticks counted; under ``table`` its
    sweep timed beside ``fused``'s on the same positions; the World's
    cost report at the end. Returns each config's launches."""
    from goworld_tpu_torch.autotune import KernelGovernor

    gov = KernelGovernor(rw, name="chip_smoke", up_windows=1,
                         cooldown_windows=0)
    t0 = time.perf_counter()
    gov.warmset.warm_all()
    warm_all_s = time.perf_counter() - t0
    warms = {}
    for lbl in gov.warmset.labels():
        e = gov.warmset.entry(lbl)
        if not e.warm:
            fail(f"[18] warming {lbl}: {e.error}")
        warms[lbl] = round(e.warm_s, 3)
    swaps, launches_by, table_line = [], {}, ""
    for label in GOVERNOR_SWAPS:
        t0 = time.perf_counter()
        # a forced commit, as the governor commits a decided, warm swap
        ev = gov._commit(label, "chip_smoke", pre_p90=None)
        swap_ms = (time.perf_counter() - t0) * 1e3
        if ev is None or rw.cfg.grid != gov.warmset.entry(label).cfg.grid:
            fail(f"[18] the swap to {label} did not commit ({ev})")
        real, cap = rw._step, {}

        def first(state, inputs, policy=None, real=real, cap=cap):
            cap["state"] = state.apply(torch.clone)
            cap["inputs"] = type(inputs)(**{
                f.name: getattr(inputs, f.name).clone()
                for f in dataclasses.fields(inputs)})
            new = real(state, inputs, policy)
            cap["new"] = (new[0].apply(torch.clone), new[1])
            return new

        rw._step = first
        kernels.reset_launches()
        rw.tick()
        rw._step = real
        ticks = [dict(kernels.LAUNCHES)]
        st_f, out_f = make_tick(rw.cfg, device=dev)(
            first_space(cap["state"]), first_space(cap["inputs"]))
        for what, a, b in (("state", first_space(cap["new"][0]), st_f),
                           ("output", first_space(cap["new"][1]), out_f)):
            la, lb = lanes(a), lanes(b)
            for name in la:
                if not same_bits(la[name], lb[name]):
                    fail(f"[18] the first tick after the swap to {label}: "
                         f"{what} lane {name} != a fresh make_tick")
        del cap, st_f, out_f
        kernels.reset_launches()
        rw.tick()
        ticks.append(dict(kernels.LAUNCHES))
        g = rw.cfg.grid
        want = {"sweep_fused": int(g.sweep_impl == "fused"),
                "counting_sort": int(g.sort_impl == "pallas"),
                "halo_ship_phase": 0, "npc_mlp": 0}
        if any(t != want for t in ticks):
            fail(f"[18] launches a tick under {label}: {ticks}")
        launches_by[f"governor {label}"] = {
            k: sum(t[k] for t in ticks) for k in want}
        swaps.append(f"{label} {swap_ms:.3f} ms")
        if g.sweep_impl == "table":
            table_line = table_beside_fused(rw, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rw.tick()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rep = rw.cost_report()
    if rep.error:
        fail(f"[18] cost report: {rep.error}")
    print(f"[18] governor on the restored World ({N} slots, default = "
          f"skin {gov.warmset.entry('default').cfg.grid.skin}): warmed "
          f"{gov.warmset.labels()} in {warm_all_s:.2f} s ({warms} s "
          f"each, off the tick thread's stream); forced commits "
          f"{' -> '.join(['default'] + GOVERNOR_SWAPS)}, tick-thread ms "
          f"a swap: {', '.join(swaps)}; each swap's first tick == a fresh "
          f"make_tick at its config on a clone of the carried state, bit "
          f"for bit; launches {launches_by}; swap log {gov.log_lines()}; "
          f"{table_line}; cost_report: bytes_accessed "
          f"{rep.bytes_accessed:.6g}, flops {rep.flops:.6g}, argument "
          f"{rep.argument_size} B, output {rep.output_size} B, aliased "
          f"{rep.alias_size} B, peak {rep.peak_hbm_bytes} B, against "
          f"torch.cuda.max_memory_allocated {peak} B over one tick {tag}",
          flush=True)
    return launches_by


def table_beside_fused(rw, g: GridSpec) -> str:
    """``sweep_impl="table"`` and ``fused`` on the World's positions at
    its config: equal in every output lane on each row no cell past
    cell_cap touches (the table keeps a cell's first cell_cap, the runs
    more), and their ms by CUDA events."""
    st = first_space(rw.state)
    flags = st.dirty.to(torch.int32) | (st.has_client.to(torch.int32) << 1)
    fused = dataclasses.replace(g, sweep_impl="fused")

    def run(spec):
        return grid_neighbors_flags(spec, st.pos, st.alive,
                                    watch_radius=st.aoi_radius,
                                    flag_bits=flags, with_stats=True)

    a, b = run(g), run(fused)
    ok = ~window_over_cap(g, st.pos, st.alive, st.aoi_radius)
    for x, y in zip(a[:3], b[:3]):
        if not torch.equal(x[ok], y[ok]):
            fail("[18] the table sweep differs from fused on a row below "
                 "the caps")
    if not all(int(x) == int(y) for x, y in zip(a[3][2:], b[3][2:])):
        fail("[18] the table sweep's cell gauges differ from fused's")
    table_ms = time_ms(lambda: run(g), 5, 1)
    fused_ms = time_ms(lambda: run(fused), 5, 1)
    return (f"under table, grid_neighbors_flags {table_ms:.3f} ms beside "
            f"fused's {fused_ms:.3f} ms by events, equal in every output "
            f"lane on the {int(ok.sum())} rows no cell past cell_cap "
            f"touches ({int((~ok).sum())} rows apart)")


def check_pipelined_twin(eager, pipe, eager_kept: list, pipe_kept: list,
                         eager_hooks: list, lanes_before, tag: str) -> None:
    """[18] [11]'s twin of 2^16 slots on the kernels against a third
    twin whose decode is pipelined, after the pipelined one's drain: the
    same sinks and hooks (as multisets: the pipelined decode runs a tick
    later), state, interest sets and ledgers; its drained lanes are the
    eager one's a tick earlier."""
    def key(x):
        if x[0] == "sync":
            return (x[0], x[1], *(np.asarray(u).tobytes() for u in x[2:]))
        # an enter message's pose and attrs are read at its decode, a
        # tick later when pipelined, as the reference's are
        return (x[0], x[1], x[2], x[3]["type"], x[3].get("eid"))

    # a decode sends no enter message of a subject destroyed since (a
    # tick later when pipelined), and attr deltas go to the watchers of
    # the decode that drains them: the messages of destroyed subjects
    # and the attr deltas are left out, every sync record is compared
    gone = {e for sv in (eager, pipe) for e, x in sv.world.entities.items()
            if x.destroyed} | {x[3].get("eid") for kept in (eager_kept,
                                                           pipe_kept)
                               for x in kept if x[0] == "msg"
                               and x[3].get("eid") not in
                               eager.world.entities}

    def kept(items):
        return sorted(key(x) for x in items if x[0] == "sync" or (
            x[3]["type"] != "attrs" and x[3].get("eid") not in gone))

    n_sink = len(kept(pipe_kept))
    if kept(eager_kept) != kept(pipe_kept):
        fail("[18] pipelined and eager twins' sinks differ")
    if sorted(map(repr, eager_hooks)) != sorted(map(repr, pipe.hooks)):
        fail("[18] pipelined and eager twins' hook calls differ")
    sa = interop.state_to_numpy(eager.world.state)
    sb = interop.state_to_numpy(pipe.world.state)
    if any(sa[k].tobytes() != sb[k].tobytes() for k in sa):
        fail("[18] pipelined and eager twins' states differ")
    ia = {e.id: frozenset(e.interested_in)
          for e in eager.world.entities.values()}
    ib = {e.id: frozenset(e.interested_in)
          for e in pipe.world.entities.values()}
    if ia != ib:
        fail("[18] pipelined and eager twins' interest sets differ")
    if eager.world.audit.ledger.snapshot(tick=0) != \
            pipe.world.audit.ledger.snapshot(tick=0):
        fail("[18] pipelined and eager twins' ledgers differ")
    if pipe.world._telem_lanes != lanes_before:
        fail("[18] the pipelined twin's lanes are not the eager one's a "
             "tick earlier")
    print(f"[18] [11]'s twin Worlds of {TWIN_N} slots on the kernels, one "
          f"with its decode pipelined, {TWIN_TICKS} ticks: after the drain "
          f"the same {n_sink} sink items (every sync record; the entity "
          f"messages of subjects not destroyed) and the same hooks (as "
          f"multisets), state, interest sets and ledgers; the pipelined "
          f"lanes are the eager ones a tick earlier {tag}", flush=True)


def diff_count(a, b):
    """Words of two lanes that differ, as a device tensor (floats by
    their bits; no host sync); lanes that are None count as equal to
    None."""
    if a is None or b is None:
        return torch.tensor(int((a is None) != (b is None)))
    if a.is_floating_point():
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return (a != b).sum()


def pct(ms, sel) -> str:
    """p50/p99 of the ticks ``sel`` picks, or "none"."""
    x = ms[sel]
    if x.size == 0:
        return "none"
    return (f"p50={float(np.percentile(x, 50)):.3f} "
            f"p99={float(np.percentile(x, 99)):.3f} (n={x.size})")


def gate_phase(dev, cfg, st, tag, label: str,
               profiled: dict | None = None) -> dict:
    """The fused sweep at the Verlet rebuild's shape of ``cfg`` (k =
    verlet_cap_eff, no flag bits, reach padded by the skin, over the
    positions snapped as the tick snaps them): the kernel against its
    plain version, a closed gate leaving its buffers byte for byte, an
    open one writing the plain version's result; times by events and
    the bound, counted as in [6]; with ``profiled``, a closed launch
    joins it, read in [12]."""
    g = cfg.grid
    gv = dataclasses.replace(g, k=g.verlet_cap_eff)
    pos = aoi.quantize_positions(g, st.pos)
    fh = aoi.front_half(gv, pos, st.alive, None, st.aoi_radius, None,
                        with_stats=True, reach_pad=g.skin)
    if not visits_every_row(fh):
        fail("the rebuild's sorted slot ids are not a permutation")
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, pos, fh.reach, gv.k,
            gv.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    err = int((top_k.long() - top_p.long()).abs().max()) + int(
        (dem_k - dem_p).abs().max())
    if err:
        fail(f"fused sweep at the rebuild shape differs from its plain "
             f"version ({err})")
    out = (torch.full_like(top_k, 7), torch.full_like(dem_k, 5))
    before = [t.clone() for t in out]
    shut = torch.zeros((), dtype=torch.int32, device=dev)
    opened = torch.ones((), dtype=torch.int32, device=dev)
    aoi.sweep_fused_cuda(*args, gate=shut, out=out)
    if not (same(out[0], before[0]) and same(out[1], before[1])):
        fail("a closed gate wrote the sweep's buffers")
    aoi.sweep_fused_cuda(*args, gate=opened, out=out)
    if not (same(out[0], top_p) and same(out[1], dem_p)):
        fail("an open gate's sweep differs from the plain version")
    ms_open = time_ms(
        lambda: aoi.sweep_fused_cuda(*args, gate=opened, out=out), 20)
    ms_shut = time_ms(
        lambda: aoi.sweep_fused_cuda(*args, gate=shut, out=out), 20)
    ms_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 3, 1)
    nb, no, cand = sweep_work(fh, dem_p, gv.k, gv.cell_cap)
    bms, by = bound(nb, no)
    if profiled is not None:
        profiled["sweep_fused_cuda, gate closed"] = \
            lambda: aoi.sweep_fused_cuda(*args, gate=shut, out=out)
    print(f"{label} gated sweep at the rebuild shape (precision "
          f"{g.precision}, k={gv.k}, cell_cap {gv.cell_cap}, no flag "
          f"bits, reach pad {g.skin}, {cand / N:.2f} in-range candidates "
          f"a row, demand max {int(dem_p.max())}): kernel == plain; gate 0 "
          f"leaves both buffers byte for byte, gate 1 writes the plain "
          f"result; {ms_open:.5f} ms a call open, {ms_shut:.5f} ms closed, "
          f"plain {ms_plain:.3f} ms, bound {bms:.5f} ms by {by} {tag}",
          flush=True)
    return {"precision": g.precision, "k": gv.k, "cell_cap": gv.cell_cap,
            "flag_bits": False, "reach_pad": g.skin, "ms": ms_open, "gate_closed_ms": ms_shut, "plain_ms": ms_plain,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}


def inputs_and_floats(dev, tag) -> None:
    """[13] the input scatter with heavy repeats against a host-side
    last write, and a small uncut world run on the card and on the CPU
    port with every lane (floats included) bit-equal."""
    rng = np.random.default_rng(SEED + 17)
    ic, slots = 65536, 4096
    pos = rng.uniform(0, 1000, (N, 3)).astype(np.float32)
    yaw = rng.uniform(0, 6, N).astype(np.float32)
    idx = rng.integers(0, slots, ic).astype(np.int32)
    idx[rng.random(ic) < 0.05] = -3          # out of range: dropped
    idx[rng.random(ic) < 0.05] = N + 5
    vals = rng.uniform(0, 1000, (ic, 4)).astype(np.float32)
    n_in = 60000
    got = apply_pos_inputs(*(torch.tensor(a, device=dev) for a in (
        pos, yaw, idx, vals, np.asarray(n_in, np.int32))))
    ok = (np.arange(ic) < n_in) & (idx >= 0) & (idx < N)
    rec = np.flatnonzero(ok)
    uniq, first_rev = np.unique(idx[rec][::-1], return_index=True)
    last = rec[::-1][first_rev]
    want_pos, want_yaw = pos.copy(), yaw.copy()
    want_pos[uniq] = vals[last, :3]
    want_yaw[uniq] = vals[last, 3]
    touched = np.zeros(N, bool)
    touched[uniq] = True
    for a, b, name in ((got[0], want_pos, "pos"), (got[1], want_yaw, "yaw"),
                       (got[2], touched, "touched")):
        if a.cpu().numpy().tobytes() != b.tobytes():
            fail(f"apply_pos_inputs with repeated slots: {name} differs "
                 f"from the host's last write")
    cfg = uncut_config(FLOAT_N)
    worlds = {d: uncut_world(cfg, SEED + 3, d)
              for d in (dev, torch.device("cpu"))}
    ticks = {d: make_tick(cfg, device=d) for d in worlds}
    bad, rebuilds = [], 0
    for t in range(FLOAT_TICKS):
        new = {d: ticks[d](*worlds[d]) for d in worlds}
        for d in worlds:
            worlds[d] = (new[d][0], worlds[d][1])
        (sa, oa), (sb, ob) = new[dev], new[torch.device("cpu")]
        rebuilds += int(ob.aoi_rebuilt)
        for what, a, b in (("state", sa, sb), ("outputs", oa, ob)):
            la, lb = lanes(a), lanes(b)
            bad += [f"{what}.{k} @{t + 1}" for k in la
                    if not same_bits(None if la[k] is None
                                     else la[k].cpu(), lb[k])]
    if bad:
        fail(f"card and CPU port differ: {bad[:8]}")
    print(f"[13] inputs and floats: apply_pos_inputs with {n_in} records "
          f"onto {slots} slots ({uniq.size} hit, repeats and out-of-range "
          f"slots among them) == the host's last write per slot; an uncut "
          f"world of {FLOAT_N} (skin {cfg.grid.skin}, syncs with repeats) "
          f"{FLOAT_TICKS} ticks on the card == on the CPU port in every "
          f"lane bit for bit, floats and the Verlet cache included "
          f"({rebuilds} rebuilds) {tag}", flush=True)


def verlet_phase(dev, tag, profiled: dict) -> tuple[dict, dict]:
    """[13] the bench world uncut: 2^20 entities, skin 4, verlet_cap 48,
    syncs with repeats, VERLET_TICKS ticks, each beside a skin-0 tick in
    lockstep from the same start (the random walk reads no lists, so
    the two trajectories coincide); returns the gated sweep's numbers
    and the path's launches."""
    cfg = uncut_config(N)
    flat = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, skin=0.0))
    st, inputs = uncut_world(cfg, SEED, dev)
    gate = gate_phase(dev, cfg, st, tag, "[13]", profiled)
    inputs_and_floats(dev, tag)
    tick, tick0 = make_tick(cfg, device=dev), make_tick(flat, device=dev)
    st0 = st.replace(aoi_cache=None)
    torch.cuda.set_sync_debug_mode("error")
    tick(st, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    skip = {"aoi_cache", "aoi_rebuilt", "aoi_skin_slack",
            # cells of radius + skin against cells of radius
            "aoi_cell_max", "aoi_over_cap_cells"}
    diffs: dict = {}
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(VERLET_TICKS)]
    gauges, per_tick = [], []
    kernels.reset_launches()
    for t in range(VERLET_TICKS):
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs)
        ev[t][1].record()
        c1 = dict(kernels.LAUNCHES)
        per_tick.append((c1["sweep_fused"] - c0["sweep_fused"],
                         c1["counting_sort"] - c0["counting_sort"]))
        ev[t][2].record()
        st0, out0 = tick0(st0, inputs)
        ev[t][3].record()
        for a, b in ((st, st0), (out, out0)):
            la, lb = lanes(a), lanes(b)
            for k in la:
                if k.split(".")[0] not in skip:
                    diffs[k] = diffs.get(k, 0) + diff_count(la[k], lb[k])
        gauges.append(torch.stack([
            out.aoi_rebuilt.float(), out.aoi_skin_slack,
            out.enter_n.float(), out.sync_n.float(),
            out.aoi_over_k_rows.float(), out.aoi_over_cap_cells.float(),
            out0.aoi_over_cap_cells.float(), out.aoi_demand_max.float(),
            st.aoi_cache.over_v_rows.float()]))
    torch.cuda.synchronize()
    launches = {"sweep_fused": sum(p[0] for p in per_tick),
                "counting_sort": sum(p[1] for p in per_tick)}
    if per_tick != [(1, 1)] * VERLET_TICKS:
        fail(f"Verlet path launches a tick {per_tick}, want one gated "
             f"sweep and one sort")
    bad = {k: int(v) for k, v in diffs.items() if int(v)}
    if bad:
        fail(f"Verlet tick != skin-0 tick in lanes {bad}")
    gv = torch.stack(gauges).cpu().numpy()
    reb, slack = gv[:, 0] > 0, gv[:, 1]
    if not reb[0] or reb.sum() < 2:
        fail(f"rebuilds {np.flatnonzero(reb).tolist()}: want the first "
             f"tick and a displacement rebuild")
    if gv[0, 2] <= 0 or (gv[:, 3] <= 0).any():
        fail("no enter events on tick 1 or a tick without sync records")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([e[0].elapsed_time(e[1]) for e in ev])
    ms0 = np.array([e[2].elapsed_time(e[3]) for e in ev])
    later = np.arange(VERLET_TICKS) >= 1
    print(f"[13] bench world uncut: {VERLET_TICKS} ticks of {N} entities, "
          f"skin {cfg.grid.skin}, verlet_cap {cfg.grid.verlet_cap_eff}, "
          f"syncs with repeats; launches {launches} (one gated sweep and "
          f"one sort a tick); rebuilds {int(reb.sum())} at ticks "
          f"{(np.flatnonzero(reb) + 1).tolist()}; every lane and output "
          f"(but the skin gauges and the cell gauges of the other cell "
          f"size) bit-equal to the skin-0 tick in lockstep every tick; "
          f"min aoi_skin_slack {float(slack.min()):.5f}; gauges max: "
          f"over_k_rows {int(gv[:, 4].max())}, over_cap_cells "
          f"{int(gv[:, 5].max())} (skin 0: {int(gv[:, 6].max())}), "
          f"demand_max {int(gv[:, 7].max())}, over_v_rows "
          f"{int(gv[:, 8].max())}; ms/tick (CUDA events, ticks 2-"
          f"{VERLET_TICKS}) all {pct(ms, later)}, reuse "
          f"{pct(ms, later & ~reb)}, rebuild {pct(ms, later & reb)}, tick "
          f"1 {ms[0]:.3f}; the skin-0 tick {pct(ms0, later)} {tag}",
          flush=True)
    return gate, launches


def overflowed_rows(spec: GridSpec, pos, alive, watch_radius):
    """bool[N]: rows whose sweep under ``spec`` truncates a run (more
    than 3*cell_cap slots in one of its three z-triples)."""
    fh = aoi.front_half(spec, pos, alive, None, watch_radius, None)
    return ((fh.hi - fh.lo) > 3 * spec.cell_cap).any(1)


def q16_phase(dev, tag) -> tuple[dict, dict]:
    """[14] the uncut world at precision="q16" (cell_cap 12, as [13]):
    the gated sweep at this path's rebuild shape against its plain
    version; then Q16_TICKS ticks, each beside a twin of the same config
    on the plain path (``ranges`` sweep, plain counting sort) in
    lockstep, bit-equal in every lane of state, cache and outputs; and
    every tick, on the rows that no truncation touches, the lists equal
    ``grid_neighbors_flags`` (precision off, no skin, plain path) over
    the snapped positions. A row is left out of that last check when its
    cache row is full or a run of its sweep overflowed, at the last
    rebuild (cells of radius + skin, on the lattice) or in the
    reference's sweep: there Verlet and the skinless sweep truncate
    different candidates, as the reference package does. The velocity
    lane is bfloat16. Returns the gated sweep's numbers and the path's
    launches."""
    cfg = uncut_config(N, precision="q16")
    g = cfg.grid
    plain = dict(sweep_impl="ranges", sort_impl="counting")
    twin_cfg = dataclasses.replace(cfg, grid=dataclasses.replace(g, **plain))
    ref_spec = dataclasses.replace(g, precision="off", skin=0.0, **plain)
    reb_spec = dataclasses.replace(g, k=g.verlet_cap_eff, **plain)
    st, inputs = uncut_world(cfg, SEED, dev)
    if st.vel.dtype != torch.bfloat16:
        fail(f"q16 velocity lane is {st.vel.dtype}")
    gate = gate_phase(dev, cfg, st, tag, "[14]")
    tick, twin = make_tick(cfg, device=dev), make_tick(twin_cfg, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    tick(st, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    st_t = st
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(Q16_TICKS)]
    per_tick, gauges = [], []
    diffs: dict = {}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    mism, held, left = zero.clone(), zero.clone(), zero.clone()
    v = g.verlet_cap_eff
    kernels.reset_launches()
    for t in range(Q16_TICKS):
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs)
        ev[t][1].record()
        c1 = dict(kernels.LAUNCHES)
        per_tick.append((c1["sweep_fused"] - c0["sweep_fused"],
                         c1["counting_sort"] - c0["counting_sort"]))
        st_t, out_t = twin(st_t, inputs)
        for a, b in ((st, st_t), (out, out_t)):
            la, lb = lanes(a), lanes(b)
            for k in la:
                diffs[k] = diffs.get(k, 0) + diff_count(la[k], lb[k])
        snapped = aoi.quantize_positions(g, st.pos)
        nbr, cnt, _fl = grid_neighbors_flags(
            ref_spec, snapped, st.alive, watch_radius=st.aoi_radius,
            flag_bits=st.has_client.to(torch.int32) << 1)
        c = st.aoi_cache
        at_rebuild = torch.stack(
            [c.ref_x, torch.zeros_like(c.ref_x), c.ref_z], 1)
        skip = (overflowed_rows(ref_spec, snapped, st.alive, st.aoi_radius)
                | overflowed_rows(reb_spec, at_rebuild, c.ref_alive,
                                  c.ref_radius)
                | (aoi.unpack_ids21(c.cand)[:, v - 1] != N))
        row_diff = (nbr != st.nbr).any(1) | (cnt != st.nbr_cnt)
        mism += (row_diff & ~skip).sum()
        held += (~skip).sum()
        left += skip.sum()
        gauges.append(torch.stack([
            out.aoi_rebuilt.float(), out.aoi_skin_slack,
            out.sync_n.float(), out.aoi_over_k_rows.float(),
            c.over_v_rows.float(), c.over_cap_cells.float()]))
    torch.cuda.synchronize()
    launches = {"sweep_fused": sum(p[0] for p in per_tick),
                "counting_sort": sum(p[1] for p in per_tick)}
    if per_tick != [(1, 1)] * Q16_TICKS:
        fail(f"q16 path launches a tick {per_tick}")
    bad = {k: int(n) for k, n in diffs.items() if int(n)}
    if bad:
        fail(f"q16 tick on the kernels != its plain-path twin in lanes "
             f"{bad}")
    if int(mism):
        fail(f"q16 lists differ from the f32 sweep over the snapped "
             f"positions in {int(mism)} rows no truncation touches")
    if st.vel.dtype != torch.bfloat16 or not torch.isfinite(st.pos).all():
        fail("q16 state lost its bfloat16 velocity or finite positions")
    gv = torch.stack(gauges).cpu().numpy()
    reb = gv[:, 0] > 0
    if not reb[0] or reb.sum() < 2:
        fail(f"q16 rebuilds {np.flatnonzero(reb).tolist()}: want the "
             f"first tick and a displacement rebuild")
    ms = np.array([e[0].elapsed_time(e[1]) for e in ev])
    later = np.arange(Q16_TICKS) >= 1
    print(f"[14] q16: {Q16_TICKS} ticks of the uncut world at "
          f"precision=q16 (lattice step {g.quant_step}, cells "
          f"{g.cell_size}, cell_cap {g.cell_cap}), launches {launches}; "
          f"every lane of state, cache and outputs == the plain-path "
          f"twin (ranges/counting) every tick; lists == "
          f"grid_neighbors_flags (precision off, plain path) over the "
          f"snapped positions on {int(held)} row-ticks, {int(left)} "
          f"row-ticks left out (a run overflowed or a full cache row); "
          f"vel {st.vel.dtype}; rebuilds {int(reb.sum())} at ticks "
          f"{(np.flatnonzero(reb) + 1).tolist()}; min aoi_skin_slack "
          f"{float(gv[:, 1].min()):.5f}; sync_n last {int(gv[-1, 2])}; "
          f"over_k_rows max {int(gv[:, 3].max())}, over_v_rows max "
          f"{int(gv[:, 4].max())}, rebuild over_cap_cells max "
          f"{int(gv[:, 5].max())}; ms/tick (CUDA events, ticks 2-"
          f"{Q16_TICKS}) all {pct(ms, later)}, reuse "
          f"{pct(ms, later & ~reb)}, rebuild {pct(ms, later & reb)}, tick "
          f"1 {ms[0]:.3f} {tag}", flush=True)
    return gate, launches


def spaces_phase(dev, bare: tuple[float, float], tag: str,
                 profiled: dict) -> tuple[dict, dict, tuple]:
    """[15] several Spaces on one card: the batched sort and sweep
    against their plain versions at SPACES x SPACE_N, timed; SPACE_TICKS
    batched ticks by events (two more under the sync guard), their
    launches against those of a one-Space batched state; the same ticks
    again in lockstep with SPACES single-Space ticks, every lane equal
    on every tick; then the served game of SPACES Spaces at its
    defaults with its migrations between them. Returns (launches by
    path, the batched shape's kernel numbers, the batched tick's p50 and
    p99 ms) and adds the batched tick and kernels to ``profiled``."""
    phase0 = time.perf_counter()
    cfg = multi_config(SPACES, SPACE_N)
    g = cfg.grid
    st0, inputs = multi_world(cfg, SPACES, SEED, dev)
    flag_bits = st0.has_client.to(torch.int32) << 1
    fh = aoi.front_half(g, st0.pos, st0.alive, None, st0.aoi_radius,
                        flag_bits, with_stats=True)
    if not visits_every_row(fh):
        fail("[15] a Space's sorted slot ids are not a permutation of its "
             "rows")
    o_k, s_k = counting_sort_cells_cuda(fh.srow, fh.n_rows)
    o_p, s_p = counting_sort_cells(fh.srow, fh.n_rows)
    o_a = torch.argsort(fh.srow, dim=-1, stable=True).to(torch.int32)
    if not (same(o_k, o_p) and same(s_k, s_p) and same(o_k, o_a)):
        fail("[15] the batched sort differs from its plain version or a "
             "per-Space stable argsort")
    sort_err = int((o_k - o_p).abs().max()) + int((s_k - s_p).abs().max())
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st0.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(-1).sum())
        fail(f"[15] the batched sweep differs from its plain version in "
             f"{bad} rows")
    for d in range(SPACES):
        one = aoi.sweep_fused_cuda(*(a[d] for a in args[:6]), *args[6:])
        if not (same(one[0], top_k[d]) and same(one[1], dem_k[d])):
            fail(f"[15] the batched sweep's Space {d} differs from its "
                 f"own launch")
    sweep_err = int((top_k.long() - top_p.long()).abs().max()) + int(
        (dem_k - dem_p).abs().max())
    n_all = SPACES * SPACE_N
    sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)
    sweep_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 2, 1)
    sort_ms = time_ms(
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows), 20)
    sort_plain = time_ms(
        lambda: counting_sort_cells(fh.srow, fh.n_rows), 2, 1)
    sort_lib = time_ms(
        lambda: torch.argsort(fh.srow, dim=-1, stable=True), 20)
    plan = radix_plan((SPACES * (fh.n_rows + 1) - 1).bit_length())
    sw_bytes, sw_ops, cand = sweep_work(fh, dem_p, g.k, g.cell_cap)
    sw_bound, sw_by = bound(sw_bytes, sw_ops)
    so_bound, so_by = bound(12 * n_all, plan[0] * 12 * n_all)
    shape = {
        "sweep_fused_cuda": dict(
            spaces=SPACES, rows_a_space=SPACE_N, ms=sweep_ms,
            plain_ms=sweep_plain, library_ms=None, bound_ms=sw_bound,
            bound_by=sw_by, max_abs_err=sweep_err),
        "counting_sort_cells_cuda": dict(
            spaces=SPACES, rows_a_space=SPACE_N, ms=sort_ms,
            plain_ms=sort_plain, library_ms=sort_lib, bound_ms=so_bound,
            bound_by=so_by, max_abs_err=sort_err, plan=list(plan))}
    profiled[f"sweep_fused_cuda, {SPACES} Spaces"] = \
        lambda: aoi.sweep_fused_cuda(*args)
    profiled[f"counting_sort_cells_cuda, {SPACES} Spaces"] = \
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows)
    print(f"[15] batched kernels at {SPACES} x {SPACE_N}: sort == plain =="
          f" per-Space stable argsort (plan {plan}), sweep == plain, every "
          f"Space == its own launch, bit for bit; sweep {sweep_ms:.5f} ms a"
          f" call (bound {sw_bound:.5f} ms by {sw_by}, {cand / n_all:.2f} "
          f"in-range candidates a row, plain {sweep_plain:.3f}); sort "
          f"{sort_ms:.5f} ms (bound {so_bound:.5f} by {so_by}, plain "
          f"{sort_plain:.3f}) against torch.argsort(dim=-1, stable=True) "
          f"{sort_lib:.5f} ms {tag}", flush=True)
    del top_p, dem_p, o_p, s_p

    # the batched tick: two ticks under the sync guard, then the timed
    # run from a kept copy of the start
    tick = make_tick(cfg, device=dev)
    start = st0.apply(torch.clone)
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(2):
        tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(SPACE_TICKS)]
    kernels.reset_launches()
    st = start
    gauges = []
    for a, b in ev:
        a.record()
        st, out = tick(st, inputs)
        b.record()
        gauges.append(torch.stack([out.enter_n, out.sync_n,
                                   out.delta_rows_n]))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != {"sweep_fused": SPACE_TICKS,
                    "counting_sort": SPACE_TICKS, "halo_ship_phase": 0, "npc_mlp": 0}:
        fail(f"[15] the batched tick launched {launches} in {SPACE_TICKS} "
             f"ticks")
    gv = torch.stack(gauges).cpu().numpy()
    if (gv[0, 0] <= 0).any() or (gv[:, 1] <= 0).any():
        fail("[15] a Space had no enters on tick 1 or no sync records")
    ms = np.array([a.elapsed_time(b) for a, b in ev])[1:]
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    keep = (st, inputs)
    profiled[f"batched tick, {SPACES} Spaces"] = \
        lambda: tick(keep[0], keep[1])
    # launches a tick at S = 1 (the same batched path, one Space)
    st1, in1 = multi_world(cfg, 1, SEED, dev)
    kernels.reset_launches()
    for _ in range(4):
        st1, _ = tick(st1, in1)
    at_one = {k: v / 4 for k, v in kernels.LAUNCHES.items()}
    per = {k: v / SPACE_TICKS for k, v in launches.items()}
    if at_one != per:
        fail(f"[15] launches a tick depend on S: {at_one} at S=1, {per} "
             f"at S={SPACES}")
    del st1, in1

    # the same ticks in lockstep with SPACES single-Space ticks
    singles = [tile_view(start, d).apply(torch.clone) for d in range(SPACES)]
    one_in = [TickInputs(**{f.name: getattr(inputs, f.name)[d]
                            for f in dataclasses.fields(TickInputs)})
              for d in range(SPACES)]
    st, diffs = start, []
    for _ in range(SPACE_TICKS):
        st, out = tick(st, inputs)
        for d in range(SPACES):
            singles[d], o1 = tick(singles[d], one_in[d])
            la, lb = lanes(tile_view(st, d)), lanes(singles[d])
            oa = lanes(type(out)(**{f.name: getattr(out, f.name)[d]
                                    for f in dataclasses.fields(out)}))
            ob = lanes(o1)
            diffs += [diff_count(la[k], lb[k]) for k in la
                      if la[k] is not None or lb[k] is not None]
            diffs += [diff_count(oa[k], ob[k]) for k in oa]
    bad = int(torch.stack(diffs).sum())
    if bad:
        fail(f"[15] the batched tick differs from {SPACES} single-Space "
             f"ticks in {bad} words")
    del singles, start, diffs
    print(f"[15] batched tick, {SPACES} Spaces x {SPACE_N} (syncs drawn as"
          f" bench_world draws them, {cfg.input_cap} a Space): "
          f"{SPACE_TICKS} ticks, launches {launches} (a tick: {per}, the "
          f"same at S=1); two ticks under the sync guard raised nothing; "
          f"every lane of state and outputs == {SPACES} single-Space "
          f"ticks on every one of {SPACE_TICKS} ticks; tick 1 enter_n "
          f"{gv[0, 0].tolist()}; last tick sync_n {gv[-1, 1].tolist()}, "
          f"delta_rows_n {gv[-1, 2].tolist()}; ms/tick p50={p50:.3f} "
          f"p99={p99:.3f} (ticks 2-{SPACE_TICKS}, CUDA events); "
          f"{n_all / (p50 / 1e3):.4g} entity-ticks/s; [5]'s one Space of "
          f"{N}: p50={bare[0]:.3f} p99={bare[1]:.3f} {tag}", flush=True)

    # the served game of SPACES Spaces at its defaults
    served = serve_world(SPACE_WORLD_N, SEED, dev, boot=True,
                         world_kw=PLANES, spaces=SPACES)
    w = served.world
    n_pop = len(w.entities) - SPACES - 1
    rows, w_launches = world_ticks(served, WORLD_TICKS, teleport=False)
    staged = sum(r["staged"]["migrations"] for r in rows)
    applied = sum(r["migrated"] for r in rows)
    # one more tick whose batched step and fold run under the sync guard
    real_step, real_fold, guard = w._step, w._telem_fn, {}

    def guarded(fn):
        def call(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            except Exception as exc:
                guard["error"] = exc
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    w._step, w._telem_fn = guarded(real_step), guarded(real_fold)
    served.stage()
    w.tick()
    w._step, w._telem_fn = real_step, real_fold
    if guard or w._telem_fn is None:
        fail(f"[15] the World's step or fold under the sync guard: "
             f"{guard.get('error')}")
    planes = planes_check(w, "[15] World")
    print(f"[15] served World of {SPACES} Spaces x {SPACE_WORLD_N} slots "
          f"at its "
          f"defaults: {n_pop} entities ({served.players.size} players) "
          f"booted through {served.boot_ticks} ticks "
          f"({served.boot_events} enter events, none past a Space's cap) "
          f"in {served.populate_s:.2f} s; {WORLD_TICKS} World.ticks "
          f"staging {rows[-1]['staged']} each, launches {w_launches}, one "
          f"sweep and one sort a tick; migrations between Spaces applied "
          f"{applied} of {staged} staged; "
          f"{world_summary(rows, w.cfg)}; one more tick's step and fold "
          f"under the sync guard raised nothing; planes: {planes} "
          f"{tag}", flush=True)
    del served, w
    release_worlds()
    print(f"[15] phase {time.perf_counter() - phase0:.1f} s", flush=True)
    return ({"spaces_batched": launches, "spaces_world": w_launches}, shape,
            (p50, p99))


def nan_same(a, b) -> bool:
    """Bit-for-bit equality with every NaN taken as equal (a NaN's
    payload is the rounding routine's, not the function's)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and same_bits(
        torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def kept_same(a, b) -> bool:
    """Two sinks' kept records equal (sync records by their bytes)."""
    return len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and (
            all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
                for u, v in zip(x[2:], y[2:])) if x[0] == "sync"
            else x[2:] == y[2:]) for x, y in zip(a, b))


def mlp_weights(pol):
    return (pol.w1, pol.b1, pol.w2, pol.b2, pol.w3, pol.b3)


def tick_run(tick, st, inputs, pol, n_ticks: int, want: dict):
    """``n_ticks`` ticks timed by CUDA events, each tick's launches
    checked against ``want``; returns (state, p50, p99, snapshot)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n_ticks)]
    per, snapshot = [], None
    for t in range(n_ticks):
        if t == n_ticks // 2:
            snapshot = st
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs, pol)
        ev[t][1].record()
        per.append({k: kernels.LAUNCHES[k] - c0[k] for k in c0})
    torch.cuda.synchronize()
    if any(p != want for p in per):
        fail(f"launches a tick {per[:2]}..., want {want}")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([a.elapsed_time(b) for a, b in ev])[1:]
    return st, float(np.percentile(ms, 50)), float(np.percentile(ms, 99)), \
        snapshot


@contextlib.contextmanager
def mlp_held_to_plain():
    """Within the block, every policy forward pass the path makes (the
    wrapper as ``models.npc_policy.policy_accel`` calls it) also runs its
    plain version on the same observation and weights; yields a list of
    (rows, bit-equal) for each call. The plain run launches nothing."""
    seen, real = [], npc_policy.npc_mlp

    def held(obs, *ws, per_row=False):
        out = real(obs, *ws, per_row=per_row)
        seen.append((obs.shape[0],
                     nan_same(out, npc_mlp_plain(obs, *ws, per_row))))
        return out
    npc_policy.npc_mlp = held
    try:
        yield seen
    finally:
        npc_policy.npc_mlp = real


def plain_twin(cfg):
    """``cfg`` on the plain versions of the sweep and the sort."""
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, sweep_impl="ranges", sort_impl="counting"))


def check_twin(what: str, a, b) -> None:
    for x, y in ((a[0], b[0]), (a[1], b[1])):
        la, lb = lanes(x), lanes(y)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"{what}: lane {name} differs from the plain twin")


def behavior_phase(dev, tag, profiled: dict, walk: tuple) -> tuple:
    """[17] NPC behaviors (BASELINE config 5) and the scenario mixes:
    the npc_mlp kernel against its plain version, the card against the
    CPU port, config 5 at 2^20 under btree and mlp, the seven registry
    scenarios, the megaspace and a served World under mlp. Returns the
    kernel's row of the kernels line, the launches of each path and the
    megaspace's p50 under mlp."""
    phase0 = time.perf_counter()
    pol = init_policy(POLICY_SEED, device=dev)
    ws = mlp_weights(pol)
    h = pol.hidden
    # the kernel at config 5's observations: the uncut world after one
    # mlp tick, so the neighbor summary is live
    cfg = behavior_config(N, "mlp")
    g = cfg.grid
    st, inputs, _ = behavior_world(cfg, SEED, dev)
    tick = make_tick(cfg, device=dev)
    st1, _ = tick(st, inputs, pol)
    obs = build_obs(st1.pos, st1.vel, st1.yaw, st1.nbr, st1.nbr_cnt,
                    (g.extent_x, g.extent_z))
    if not nan_same(npc_mlp(obs, *ws), npc_mlp_plain(obs, *ws)):
        fail("[17] npc_mlp differs from its plain version at config 5")
    rng = np.random.default_rng(SEED + 17)
    odd, modes = {}, set()
    for hid in (h, 16):
        ph = ws if hid == h else mlp_weights(init_policy(POLICY_SEED, hid,
                                                         device=dev))
        for rows in (1, 2, 3, 31, 4097):
            x = rng.standard_normal((rows, 10)) * rng.choice(
                [1e-3, 1.0, 30.0, 1e30], (rows, 10))
            x[rng.random((rows, 10)) < 0.05] = 0.0
            x[rng.random((rows, 10)) < 0.05] = -0.0
            x[rng.random((rows, 10)) < 0.02] = 3e38
            x[rng.random((rows, 10)) < 0.02] = -3e38
            x[rng.random((rows, 10)) < 0.01] = np.nan
            xo = torch.tensor(x.astype(np.float32), device=dev)
            modes.add(layer_lanes(rows, hid))
            for wname, pw in (("init_policy(5)", ph), ("random", tuple(
                    torch.tensor(rng.standard_normal(tuple(w.shape)),
                                 dtype=torch.float32, device=dev)
                    .to(torch.bfloat16) for w in ph))):
                a, b = npc_mlp(xo, *pw), npc_mlp_plain(xo, *pw)
                odd[f"h{hid}/{rows}/{wname}"] = nan_same(a, b)
    # layer-2 products below the 2^-149 grid: the guard's rounded path
    uobs, uws = mlp_underflow_case(1 << 16, SEED, dev)
    odd["underflow"] = nan_same(npc_mlp(uobs, *uws),
                                npc_mlp_plain(uobs, *uws))
    if not all(odd.values()):
        fail(f"[17] npc_mlp differs from its plain version: {odd}")
    # tanh over every bf16 value: the card's float64 tanh and the
    # kernel's table on the card == the CPU's float64 tanh
    allb = torch.arange(65536, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    if not nan_same(tanh_bf16(allb.to(dev)).cpu(), tanh_bf16(allb)) or \
            not nan_same(tanh_by_table(allb.to(dev)).cpu(), tanh_bf16(allb)):
        fail("[17] bf16 tanh on the card differs from the CPU's")
    mlp_ms = time_ms(lambda: npc_mlp(obs, *ws), 20)
    mlp_plain = time_ms(lambda: npc_mlp_plain(obs, *ws), 2, 1)

    def cublas():
        x = obs.to(torch.bfloat16)
        x = torch.tanh(x @ ws[0] + ws[1])
        x = torch.tanh(x @ ws[2] + ws[3])
        return (x @ ws[4] + ws[5]).float()
    mlp_lib = time_ms(cublas, 20)
    mlp_ops = 2 * (10 * h + h * h + 3 * h) * N
    mlp_bytes = N * (10 + 3) * 4 + sum(w.numel() * 2 for w in ws)
    # the operands are bf16: the bound is the tensor cores' rate; the
    # float32 CUDA-core rate bounds only this design, which keeps XLA's
    # summation order (no mma)
    bms, by = bound(mlp_bytes, mlp_ops, PEAK_BF16_S)
    bms_fp32 = bound(mlp_bytes, mlp_ops)[0]
    # read first in [12]: a profiler session long after the process's
    # first one drops device events (probe_profiler.py)
    rest = list(profiled.items())
    profiled.clear()
    profiled["npc_mlp"] = lambda: npc_mlp(obs, *ws)
    profiled.update(rest)
    print(f"[17] npc_mlp: == its plain version bit for bit at {N} rows of "
          f"config 5's observations and at {sorted(odd)} (extremes "
          f"+-3e38, 1e30, 0, -0.0, NaN as NaN; lanes modes "
          f"{sorted(modes)}; the underflow case through layer 2's "
          f"rounded path); bf16 tanh card == CPU on all 65536 inputs, "
          f"by float64 and by the kernel's table; {mlp_ms:.4f} ms a call "
          f"(bound {bms:.4f} ms by "
          f"{by} at the bf16 tensor-core rate; {bms_fp32:.4f} ms at the "
          f"float32 CUDA-core rate, the bound of a design in XLA's "
          f"order), plain {mlp_plain:.2f} ms, cuBLAS bf16 chain (not "
          f"bit-equal) {mlp_lib:.4f} ms {tag}", flush=True)

    # the card against the CPU port, every lane
    launches = {}
    for name in ("btree", "mlp", "mixed"):
        c = scenario_config(FLOAT_N, name) if name == "mixed" \
            else behavior_config(FLOAT_N, name)
        sides = []
        for d in (dev, torch.device("cpu")):
            s, i, p = behavior_world(c, SEED, d)
            tk = make_tick(c, device=d)
            for _ in range(FLOAT_TICKS):
                s, o = tk(s, i, p)
            sides.append((s, o))
        la, lb = lanes(sides[0][0]), lanes(sides[1][0])
        la.update({f"out.{k}": v for k, v in lanes(sides[0][1]).items()})
        lb.update({f"out.{k}": v for k, v in lanes(sides[1][1]).items()})
        bad = [k for k in la if not same_bits(
            la[k], None if lb[k] is None else lb[k].to(dev))]
        if bad:
            fail(f"[17] {name}: the card differs from the CPU port in "
                 f"{bad}")
    print(f"[17] card == CPU port: {FLOAT_N} entities uncut, "
          f"{FLOAT_TICKS} ticks under btree, mlp and mixed, every lane "
          f"and output bit for bit {tag}", flush=True)

    # config 5 at full width
    stage = {}
    for name in ("btree", "mlp"):
        c = behavior_config(N, name)
        s0, i, p = behavior_world(c, SEED, dev)
        tk = make_tick(c, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        tk(s0, i, p)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = {"sweep_fused": 1, "counting_sort": 1,
                "halo_ship_phase": 0, "npc_mlp": int(name == "mlp")}
        kernels.reset_launches()
        s, p50, p99, snap = tick_run(tk, s0, i, p, BEHAVIOR_TICKS, want)
        launches[f"config5_{name}"] = dict(kernels.LAUNCHES)
        check_twin(f"[17] config 5 {name}", tk(snap, i, p),
                   make_tick(plain_twin(c), device=dev)(snap, i, p))
        key = prng.split(s.rng)[1]
        ext = (c.grid.extent_x, c.grid.extent_z)
        stage[name] = time_ms(lambda c=c, s=s, p=p: compute_velocity(
            c, key, s.pos, s.yaw, s, p, ext, s.nbr, s.nbr_cnt), 10)
        if name == "btree":
            walk_cfg = dataclasses.replace(c, behavior="random_walk")
            stage["random_walk"] = time_ms(lambda s=s: compute_velocity(
                walk_cfg, key, s.pos, s.yaw, s, None, ext, s.nbr,
                s.nbr_cnt), 10)
        print(f"[17] config 5 {name}: {BEHAVIOR_TICKS} ticks of {N} "
              f"entities uncut (skin {c.grid.skin}), launches a tick "
              f"{want}; one tick under the sync guard; tick "
              f"{BEHAVIOR_TICKS // 2 + 1} == its plain twin (ranges/"
              f"counting) bit for bit; ms/tick p50={p50:.3f} "
              f"p99={p99:.3f} (CUDA events, ticks 2-{BEHAVIOR_TICKS}; "
              f"[5]'s random walk at skin 0 p50={walk[0]:.3f}) {tag}",
              flush=True)
    print(f"[17] behavior stage ms a tick (compute_velocity, events, the "
          f"state after the run): "
          f"{ {k: round(v, 4) for k, v in stage.items()} } {tag}",
          flush=True)

    # every registry scenario, small, beside its plain twin; mixed at
    # full width
    for name in scenario_names():
        c = scenario_config(SCN_N, name)
        s, i, p = behavior_world(c, SEED, dev)
        tk, tp = make_tick(c, device=dev), \
            make_tick(plain_twin(c), device=dev)
        sp = s
        for _ in range(SCN_TICKS):
            a, b = tk(s, i, p), tp(sp, i, p)
            check_twin(f"[17] scenario {name}", a, b)
            s, sp = a[0], b[0]
    c = scenario_config(N, "mixed")
    s0, i, p = behavior_world(c, SEED, dev)
    tk = make_tick(c, device=dev)
    tk(s0, i, p)
    kernels.reset_launches()
    want = {"sweep_fused": 1, "counting_sort": 1, "halo_ship_phase": 0,
            "npc_mlp": 0}
    s, p50, p99, snap = tick_run(tk, s0, i, p, MIXED_TICKS, want)
    launches["mixed"] = dict(kernels.LAUNCHES)
    check_twin("[17] mixed at 2^20", tk(snap, i, p),
               make_tick(plain_twin(c), device=dev)(snap, i, p))
    print(f"[17] scenarios: all {len(scenario_names())} "
          f"({', '.join(scenario_names())}) {SCN_TICKS} ticks at {SCN_N} "
          f"== their plain twins; mixed at {N}: {MIXED_TICKS} ticks, "
          f"p50={p50:.3f} p99={p99:.3f} ms, tick {MIXED_TICKS // 2 + 1} "
          f"== its plain twin {tag}", flush=True)

    # the 2x2 megaspace under mlp
    mc = mega_config(N, MEGA_DEV)
    mc = dataclasses.replace(mc, cfg=dataclasses.replace(mc.cfg,
                                                         behavior="mlp"))
    s0, i = mega_world(mc, N, SEED, dev)
    tk = make_mega_tick(mc, device=dev)
    tk(s0, i, pol)
    kernels.reset_launches()
    want = {"sweep_fused": MEGA_DEV, "counting_sort": MEGA_DEV,
            "halo_ship_phase": 2, "npc_mlp": MEGA_DEV}
    s, p50, p99, snap = tick_run(tk, s0, i, pol, MEGA_TICKS, want)
    launches["megaspace_mlp"] = dict(kernels.LAUNCHES)
    plain = dataclasses.replace(mc, halo_impl="ppermute",
                                cfg=plain_twin(mc.cfg))
    with mlp_held_to_plain() as held:
        got = tk(snap, i, pol)
    if [r for r, _ in held] != [mc.cfg.capacity] * MEGA_DEV or \
            not all(ok for _, ok in held):
        fail(f"[17] megaspace mlp: npc_mlp against its plain version on "
             f"the tiles' observations (rows, equal): {held}")
    check_twin("[17] megaspace mlp", got,
               make_mega_tick(plain, device=dev)(snap, i, pol))
    # its device busy a tick, read in [12] against this p50
    profiled["megaspace tick, mlp"] = \
        lambda tk=tk, snap=snap, i=i: tk(snap, i, pol)
    mega_p50 = p50
    print(f"[17] megaspace 2x2 under mlp: {MEGA_TICKS} ticks of {N}, "
          f"launches a tick {want}; tick {MEGA_TICKS // 2 + 1}: npc_mlp "
          f"== its plain version on each tile's {mc.cfg.capacity} "
          f"observation rows, the tick == its plain twin (ppermute/"
          f"ranges/counting); p50={p50:.3f} "
          f"p99={p99:.3f} ms {tag}", flush=True)

    # a served World under mlp, kernels against the plain versions
    twins = [serve_world(BEHAVIOR_WORLD_N, SEED + 3, dev, keep=True,
                         boot=True, behavior="mlp",
                         sweep_impl=a, sort_impl=b)
             for a, b in (("fused", "pallas"), ("ranges", "argsort"))]
    kernels.reset_launches()
    for t in range(BEHAVIOR_WORLD_TICKS):
        for sv in twins:
            sv.stage()
            with mlp_held_to_plain() as held:
                sv.world.tick()
            if [r for r, _ in held] != [BEHAVIOR_WORLD_N] or not held[0][1]:
                fail(f"[17] served World mlp: npc_mlp against its plain "
                     f"version on the World's observations at tick "
                     f"{t + 1} (rows, equal): {held}")
        ka, kb = (sv.sink.take()["kept"] for sv in twins)
        sa, sb = (interop.state_to_numpy(sv.world.state) for sv in twins)
        if not kept_same(ka, kb) or any(
                sa[k].tobytes() != sb[k].tobytes() for k in sa):
            fail(f"[17] served mlp twin Worlds differ at tick {t + 1}")
    launches["world_mlp"] = dict(kernels.LAUNCHES)
    if launches["world_mlp"]["npc_mlp"] != 2 * BEHAVIOR_WORLD_TICKS:
        fail(f"[17] served World launches {launches['world_mlp']}")
    del twins
    release_worlds()
    print(f"[17] served World of {BEHAVIOR_WORLD_N} slots under mlp: "
          f"{BEHAVIOR_WORLD_TICKS} ticks, npc_mlp == its plain version on "
          f"every tick's {BEHAVIOR_WORLD_N} observation rows, kernel and "
          f"plain-version twins equal in sinks and state; phase "
          f"{time.perf_counter() - phase0:.1f} s {tag}", flush=True)
    row = {
        "name": "npc_mlp", "route": "cuda",
        "source": "goworld_tpu_torch/csrc/npc_mlp.cu",
        "replaces": "goworld_tpu/models/npc_policy.py:109 (policy_accel, "
                    "plain XLA dots; no TPU kernel)",
        "launches": sum(v["npc_mlp"] for v in launches.values()),
        "launches_by_path": {k: v["npc_mlp"] for k, v in launches.items()},
        "max_abs_err": 0, "ms": mlp_ms, "device_ms": None,
        "launches_per_call": None, "plain_ms": mlp_plain,
        "bound_ms": bms, "bound_by": by, "library_ms": mlp_lib,
        "bound_ms_fp32_cuda_cores": bms_fp32,
    }
    return row, launches, mega_p50



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
    walls, t_mark = {}, [time.perf_counter()]

    def phase_done(phase: str) -> None:
        now = time.perf_counter()
        walls[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    path, secs, log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2] build: {path.name} in {secs:.1f} s; ptxas: "
          f"{' | '.join(regs[:6])}", flush=True)
    phase_done("[1]-[2]")

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
    # tail tiles, a single key, the megaspace tile's key count, and key
    # widths of 1, 19, 21 and 31 bits
    shapes = []
    for n, n_rows in ((1, 1), (4095, fh.n_rows), (4097, 1),
                      (311_296, fh.n_rows), (N, (1 << 21) - 3),
                      (N, 2**31 - 2)):
        keys = torch.tensor(rng.integers(0, n_rows + 1, n).astype(np.int32),
                            device=dev)
        o_k, s_k = counting_sort_cells_cuda(keys, n_rows)
        o_a = torch.argsort(keys, stable=True).to(torch.int32)
        ok = same(o_k, o_a) and same(s_k, keys[o_a.long()])
        if n_rows < 1 << 24:  # the plain version's n_rows + 1 tables fit
            o_p, s_p = counting_sort_cells(keys, n_rows)
            ok = ok and same(o_k, o_p) and same(s_k, s_p)
        torch.cuda.synchronize()
        if not ok:
            fail(f"counting sort differs from a stable argsort at n={n}, "
                 f"n_rows={n_rows}")
        shapes.append(f"{n}x{n_rows.bit_length()}b"
                      f"{radix_plan(n_rows.bit_length())}")
    phase_done("[3]")
    print(f"[3] sort parity: bit-exact at n={N}, n_rows={fh.n_rows} "
          f"(bench and skewed keys, plan (passes, digit bits) "
          f"{radix_plan(fh.n_rows.bit_length())}); against a stable "
          f"argsort at n x key bits (plan) {', '.join(shapes)}", flush=True)

    # [4] sweep parity at the slice shape, then the whole sweep
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st0.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    torch.cuda.synchronize()
    if not visits_every_row(fh):
        fail("the sorted slot ids are not a permutation of the rows")
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(1).sum())
        fail(f"fused sweep differs from its plain version in {bad} rows")
    variants = []
    for k, cc, flagged in ((8, 12, True), (64, 12, True), (32, 3, True),
                           (32, 4, True), (32, 28, True), (32, 12, False)):
        gv = dataclasses.replace(g, k=k, cell_cap=cc)
        fv = aoi.front_half(gv, st0.pos, st0.alive, None, st0.aoi_radius,
                            flag_bits if flagged else None, with_stats=True)
        av = (fv.s_xz, fv.s_w, fv.lo, fv.hi, st0.pos, fv.reach, k, cc,
              fv.code, True)
        if not visits_every_row(fv) or not all(same(x, y) for x, y in zip(
                aoi.sweep_fused_cuda(*av),
                aoi.sweep_fused_plain(*av, row_block=g.row_block))):
            fail(f"fused sweep differs from its plain version at k={k}, "
                 f"cell_cap={cc}, id_shift={fv.code[0]}")
        variants.append(f"k{k}/cc{cc}/shift{fv.code[0]}")
    # a clustered world: ~10 entities a cell, so most rows have more valid
    # candidates than a warp has lanes and take the overflow rounds
    cn, cext = 1 << 18, 8100.0
    crng = np.random.default_rng(SEED + 13)
    cpos = np.zeros((cn, 3), np.float32)
    cpos[:, 0] = crng.uniform(0, cext, cn)
    cpos[:, 2] = crng.uniform(0, cext, cn)
    cpos = torch.tensor(cpos, device=dev)
    calive = torch.tensor(crng.random(cn) < 0.95, device=dev)
    cflags = torch.tensor(crng.integers(0, 4, cn).astype(np.int32),
                          device=dev)
    over = []
    for k, cc in ((32, 28), (64, 12)):
        cg = dataclasses.replace(g, extent_x=cext, extent_z=cext, k=k,
                                 cell_cap=cc)
        fc = aoi.front_half(cg, cpos, calive, None, None, cflags,
                            with_stats=True)
        ac = (fc.s_xz, fc.s_w, fc.lo, fc.hi, cpos, fc.reach, k, cc, fc.code,
              True)
        top_k, dem_k = aoi.sweep_fused_cuda(*ac)
        top_p, dem_p = aoi.sweep_fused_plain(*ac, row_block=g.row_block)
        share = float((dem_p > 32).float().mean())
        if not (visits_every_row(fc) and same(top_k, top_p)
                and same(dem_k, dem_p)):
            fail(f"fused sweep differs from its plain version on the "
                 f"clustered world (k={k}, cell_cap={cc})")
        if share <= 0.1:
            fail(f"the clustered world has only {share:.3f} of rows with "
                 f"demand > 32")
        over.append(f"k{k}/cc{cc}: {share:.3f} of rows over 32")
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
    print(f"[4] sweep parity: kernel == plain at n={N} (keys, demand), "
          f"also at {', '.join(variants)}; on a clustered world of {cn} "
          f"({'; '.join(over)}); fused+pallas == ranges+argsort for "
          f"sort/exact/f32; oracle exact at n=4096", flush=True)

    phase_done("[4]")

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
    if launches != {"sweep_fused": TICKS, "counting_sort": TICKS,
                    "halo_ship_phase": 0, "npc_mlp": 0}:
        fail(f"single-Space path launches {launches} in {TICKS} ticks")
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
    for what, a, b in (("state", st_k, st_p), ("output", out_k, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"{what} lane {name}: kernels != plain versions")
    print(f"[5] single-Space path: {TICKS} ticks of {N} entities, launches "
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

    phase_done("[5]")

    # [6] kernel times at the main path's shapes (state after the run)
    flag_bits = (st.dirty.to(torch.int32)
                 | (st.has_client.to(torch.int32) << 1))
    fh = aoi.front_half(g, st.pos, st.alive, None, st.aoi_radius,
                        flag_bits, with_stats=True)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    if not visits_every_row(fh):
        fail("the sorted slot ids are not a permutation of the rows")
    k_top, k_dem = aoi.sweep_fused_cuda(*args)
    p_top, p_dem = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    sweep_err = int((k_top.long() - p_top.long()).abs().max()) + int(
        (k_dem - p_dem).abs().max())
    sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)
    sweep_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 3, 1)
    n_lanes = 9 * g.cell_cap
    sweep_bytes, sweep_ops, cand = sweep_work(fh, p_dem, g.k, g.cell_cap)
    # the count of earlier bounds, kept beside it so that times before
    # and after the kernel's redesign read against one yardstick: every
    # lane of the 3x3 window, and 2 per lane per selection round
    # (min(demand, k) + 1 rounds a row)
    rounds = int((torch.clamp_max(p_dem, g.k) + 1).sum())
    window_ops = 14 * n_lanes * N + 2 * n_lanes * rounds
    window_bms, _ = bound(sweep_bytes, window_ops)
    o_k, s_k = counting_sort_cells_cuda(fh.srow, fh.n_rows)
    o_p, s_p = counting_sort_cells(fh.srow, fh.n_rows)
    sort_err = int((o_k - o_p).abs().max()) + int((s_k - s_p).abs().max())
    sort_ms = time_ms(
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows), 20)
    sort_plain = time_ms(
        lambda: counting_sort_cells(fh.srow, fh.n_rows), 3, 1)
    sort_lib = time_ms(lambda: torch.argsort(fh.srow, stable=True), 20)
    plan = radix_plan(max(1, fh.n_rows.bit_length()))
    # read by torch.profiler after the megaspace path (see device_times)
    profiled = {
        "sweep_fused_cuda": lambda: aoi.sweep_fused_cuda(*args),
        "counting_sort_cells_cuda":
            lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows),
        "torch.argsort": lambda: torch.argsort(fh.srow, stable=True),
        # the whole single-Space tick, beside [15]'s batched tick
        f"tick, one Space of {N}": lambda s=st: tick(s, inputs)}
    sort_bytes = 12 * N
    sort_ops = plan[0] * 12 * N  # digit extract, histogram, rank, scatter

    rows = []
    for name, src, rep, err, kms, pms, lms, nb, no in (
            ("sweep_fused_cuda", "goworld_tpu_torch/csrc/aoi_fused.cu",
             "goworld_tpu/ops/aoi.py:919", sweep_err, sweep_ms,
             sweep_plain, None, sweep_bytes, sweep_ops),
            ("counting_sort_cells_cuda",
             "goworld_tpu_torch/csrc/counting_sort.cu",
             "goworld_tpu/ops/sort.py:157", sort_err, sort_ms,
             sort_plain, sort_lib, sort_bytes, sort_ops)):
        bms, by = bound(nb, no)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["sweep_fused" if "sweep" in name
                                 else "counting_sort"],
            "max_abs_err": err, "ms": kms, "device_ms": None,
            "launches_per_call": None, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
        })
        if "sweep" in name:
            rows[-1]["bound_ms_window_lanes"] = window_bms
        if err != 0:
            fail(f"{name} differs from its plain version at timing inputs")
    print(f"[6] sweep and sort timed at the single-Space shapes, launches "
          f"per tick: { {k: v / TICKS for k, v in launches.items()} }; "
          f"sweep {sweep_ms:.5f} ms a call (bound "
          f"{rows[0]['bound_ms']:.5f} ms by {rows[0]['bound_by']} for "
          f"{cand / N:.2f} in-range candidates a row, {window_bms:.5f} ms "
          f"by the all-lanes count); sort {sort_ms:.5f} ms a call (plan "
          f"{plan}) against torch.argsort(stable=True) {sort_lib:.5f} ms: "
          f"sort {'<=' if sort_ms <= sort_lib else '>'} argsort {tag}",
          flush=True)

    phase_done("[6]")
    mc = mega_config(N, MEGA_DEV)
    halo_parity(dev, mc)
    phase_done("[7]")
    ship_row, mega_device = mega_path(dev, mc, tag)
    rows.append(ship_row)
    phase_done("[8]-[9]")
    small_oracle(dev)
    phase_done("[10]")
    eager = {}
    world, served = world_phase(dev, (p50, p99), tag, profiled, eager)
    phase_done("[11]")
    world.update(planes_phase(dev, served, tag))
    del served
    phase_done("[18]")
    gate, world["verlet"] = verlet_phase(dev, tag, profiled)
    phase_done("[13]")
    gate_q16, world["q16"] = q16_phase(dev, tag)
    phase_done("[14]")
    spaces, spaces_shape, spaces_ms = spaces_phase(dev, (p50, p99), tag,
                                                   profiled)
    world.update(spaces)
    phase_done("[15]")
    mlp_row, beh_launches, mega_mlp_p50 = behavior_phase(
        dev, tag, profiled, (p50, p99))
    rows.append(mlp_row)
    world.update({f"behaviors_{k}": v for k, v in beh_launches.items()})
    phase_done("[17]")
    for row, key in zip(rows[:2], ("sweep_fused", "counting_sort")):
        row["launches_by_path"] = {"single_space": row["launches"],
                                   **{p: n[key] for p, n in world.items()}}
        row["launches"] = sum(row["launches_by_path"].values())
    rows[0]["verlet_rebuild_shape"] = gate
    rows[0]["q16_rebuild_shape"] = gate_q16
    rows[0]["spaces_shape"] = spaces_shape["sweep_fused_cuda"]
    rows[1]["spaces_shape"] = spaces_shape["counting_sort_cells_cuda"]
    rows[2]["launches_by_path"] = {"megaspace": rows[2]["launches"]}

    got, dev_ms = device_times(profiled, rows[:2], plan)
    mlp_row["device_ms"], mlp_row["launches_per_call"] = got["npc_mlp"]
    if mlp_row["launches_per_call"] != 1:
        fail(f"[12] npc_mlp kernels a call: {mlp_row['launches_per_call']}")
    gate["gate_closed_device_ms"], gate["gate_closed_kernels"] = \
        got["sweep_fused_cuda, gate closed"]
    for row in rows[:2]:
        sh = row["spaces_shape"]
        sh["device_ms"], sh["launches_per_call"] = \
            got[f"{row['name']}, {SPACES} Spaces"]
    if rows[0]["spaces_shape"]["launches_per_call"] != 1 or \
            rows[1]["spaces_shape"]["launches_per_call"] > \
            rows[1]["spaces_shape"]["plan"][0] + 1:
        fail(f"[12] batched kernels' launches a call: "
             f"{[r['spaces_shape']['launches_per_call'] for r in rows[:2]]}")
    b8 = got[f"batched tick, {SPACES} Spaces"]
    b1 = got[f"tick, one Space of {N}"]
    bm = got["megaspace tick, mlp"]
    print(f"[12] device time a call (torch.profiler, after the timed "
          f"paths): {dev_ms}; {mega_device()}; device busy a tick: "
          f"{SPACES} Spaces batched {b8[0]:.3f} ms in {b8[1]:g} kernels "
          f"(idle share against [15]'s p50 {1 - b8[0] / spaces_ms[0]:.3f}),"
          f" one Space of {N} {b1[0]:.3f} ms in {b1[1]:g} kernels (against"
          f" [5]'s p50 {1 - b1[0] / p50:.3f}), the megaspace under mlp "
          f"{bm[0]:.3f} ms in {bm[1]:g} kernels (against [17]'s p50 "
          f"{1 - bm[0] / mega_mlp_p50:.3f}); kernel times on the next "
          f"line {tag}", flush=True)
    phase_done("[12]")
    print(f"[walls] phase seconds {walls}, total "
          f"{sum(walls.values()):.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
