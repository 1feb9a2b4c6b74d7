"""Where one tick's time goes on the card.

    python -m goworld_tpu_torch.profile_tick [--n 1048576] [--ticks 20]
                                             [--mega TILES |
                                              --world [--planes on|off] |
                                              --uncut [--q16]]
                                             [--behavior btree|mlp |
                                              --scenario NAME]
                                             [--spaces S]
                                             [--out chiprun_out]
    PYTHONPATH=DIR python goworld_tpu_torch/profile_tick.py ...

Runs the bench world of :mod:`goworld_tpu_torch.workload` through
``make_tick`` (with ``--mega``, the megaspace bench world over TILES
tiles through ``make_mega_tick``) and reports, as one JSON line on
stdout:

* ``tick_ms_mean``, ``tick_ms_p50``, ``tick_ms_p99``: the ticks' times
  by CUDA events (the stage events below included);
  ``tick_ms_p50_p99_unwrapped``: as many ticks before the stages are
  wrapped, and ``tick_ms_p50_p99_after_profiler``: as many after the
  profiled window (a torch.profiler session slows the host's later
  launches, so these two tell what it costs a host-bound tick);
* ``stages``: mean ms per tick of each of the tick's stages, and of
  the sweep's parts (front half, fused kernel, unpack), from CUDA events
  recorded around the stage functions (wrapped for this run only); the
  events sit on the device timeline, so a stage's time includes any wait
  for the host to launch its work;
* ``halo_exchange`` (``--mega``): per ``halo_impl``, the device ms
  and kernel launches a call of the halo exchange of one more tick,
  called alone under torch.profiler after the profiled window;
* ``kernels_top``: the device kernels with the most time over a short
  profiled window (torch.profiler), and ``busy_ms`` / ``idle_share``:
  the summed kernel time against the window's tick time;
* ``csrc_kernels``: device ms and calls a tick of each kernel built from
  ``csrc/`` (the ``__global__`` functions of its sources), and
  ``memset_ms_per_tick``.

With ``--world``, the served game of :func:`workload.serve_world` at
capacity ``--n`` instead: after three ticks (the first flushes the
population), ``--ticks`` ``World.tick``s with the game's traffic staged
before each (walking client syncs, :meth:`workload.Served.stage`),
reporting ``world_tick_ms`` (host wall, mean/p50/p99), ``per_tick``:
the mean true counts of enters, leaves, sync records and rows whose
interest list changed (each beside its cap in ``caps``),
``spans_ms``: mean/p50/p99 of the World's four spans (``flush_staging``,
``device_step``, ``fetch_outputs``, ``decode_fanout``) from its tick
timeline, ``step_event_ms``: the step by CUDA events around it, and
``busy_ms`` / ``idle_share`` / ``kernels_top`` / ``csrc_kernels`` over
a profiled window of ticks (idle against the ticks' host wall).
``--planes on`` (the default) builds the World at its defaults: the
live telemetry fold, the residency and audit planes and the resident
carry; ``fold_event_ms`` and ``carry_event_ms`` are the fold's and the
carry copy's device time by CUDA events around them (the step's events
include the copy), ``audit_tick_ms`` the walls of the ticks that took
an audit sample. ``--planes off`` builds the World without any of them
(``resident=False``), as it served before the planes, so the planes'
cost reads as the difference of two runs.

With ``--spaces S``, ``--n`` slots split over S Spaces of ``--n / S``
each (:func:`workload.multi_config`): without ``--world`` the batched
tick of :func:`workload.multi_world` (one launch of each kernel a tick
for all S), with it the served game of S Spaces with its migrations
between them (``per_tick`` then sums the Spaces' counts, each beside
its per-Space cap).

With ``--behavior btree|mlp`` (BASELINE config 5) or ``--scenario
NAME`` the bench world runs that behavior (uncut with ``--uncut``, else
at skin 0) and the behavior stage splits into its features, the
policy's forward pass (the npc_mlp kernel) and the rest.

With ``--uncut``, the bench world uncut (:func:`workload.uncut_config`:
the Verlet skin of 4, syncs with repeats), whose sweep stage is
``grid_neighbors_verlet`` (4a-4c then also count the rebuild branch,
run every tick, and 4c the re-rank's unpack; 4d is the re-rank); with
``--q16`` as well, at precision="q16" (the bench's cell_cap of 12),
as ``chip_smoke.py`` [14] runs it.

The full profiler table goes to ``<out>/profile_tick.txt``. Run as a
file with another checkout's root first on ``PYTHONPATH``, it measures
that checkout's package with this instrument (a stage whose function
that package lacks is left out), so two versions compare on one card.
Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.core import step
from goworld_tpu_torch.core.step import make_tick
from goworld_tpu_torch.entity import manager
from goworld_tpu_torch.ops import aoi
from goworld_tpu_torch.parallel import halo, megaspace
from goworld_tpu_torch.parallel import migrate as mig
from goworld_tpu_torch.parallel.megaspace import make_mega_tick
from goworld_tpu_torch.utils import metrics
from goworld_tpu_torch.workload import (
    behavior_config,
    behavior_world,
    bench_world,
    mega_config,
    mega_world,
    multi_config,
    multi_world,
    scenario_config,
    serve_world,
    slice_config,
    uncut_config,
    uncut_world,
)

STAGES = [
    ("1 input scatter", step, "apply_pos_inputs"),
    ("2 behavior", step, "compute_velocity"),
    ("2 behavior, scenario", step, "scenario_velocity"),
    ("2a features (btree)", step, "features_from_neighbors"),
    ("2a features (mlp observation)", step, "build_obs"),
    ("2b forward (npc_mlp)", step, "policy_accel"),
    ("3 integrate", step, "integrate"),
    ("4 aoi sweep", step, "grid_neighbors_flags"),
    ("4 aoi sweep, verlet", step, "grid_neighbors_verlet"),
    ("4a sweep front half", aoi, "front_half"),
    ("4b fused sweep kernel", aoi, "sweep_fused_cuda"),
    ("4c unpack top-k", aoi, "_unpack_top"),
    ("4d verlet re-rank", aoi, "_rank_candidates"),
    ("5 interest deltas", step, "interest_pairs"),
    ("6 sync records", step, "collect_sync"),
    ("6 attr records", step, "collect_attr_deltas"),
]

# the megaspace tick's stages; each runs once per tile (the halo once)
MEGA_STAGES = [
    ("1 input scatter", megaspace, "apply_pos_inputs"),
    ("2 behavior", megaspace, "compute_velocity"),
    ("3 integrate", megaspace, "integrate"),
    ("4 migrate pack", mig, "pack_emigrants"),
    ("4 migrate despawn", mig, "despawn_departed"),
    ("4 migrate insert", mig, "insert_arrivals"),
    ("5 halo exchange", megaspace, "exchange_halo_2d"),
    ("5 halo exchange 1d", megaspace, "exchange_halo"),
    ("5a phase kernel", halo, "ship_phase"),
    ("6 aoi sweep", megaspace, "grid_neighbors_flags"),
    ("6a sweep front half", aoi, "front_half"),
    ("6b fused sweep kernel", aoi, "sweep_fused_cuda"),
    ("6c unpack top-k", aoi, "_unpack_top"),
    ("7 interest deltas", megaspace, "interest_pairs"),
    ("8 sync records", megaspace, "collect_sync"),
    ("8 attr records", megaspace, "collect_attr_deltas"),
    ("9 stack tiles", megaspace, "stack_states"),
    ("9 stack outputs", megaspace, "_stack_outputs"),
]


def _csrc_kernel_names() -> set[str]:
    """Names of the ``__global__`` functions in ``csrc/*.cu``."""
    pat = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    return {name for src in kernels.CSRC.glob("*.cu")
            for name in pat.findall(src.read_text())}


def _timed(fn, name, marks):
    def wrapper(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        marks.append((name, a, b))
        return out
    return wrapper


def _halo_exchange(tick, st, inputs) -> dict:
    """Per ``halo_impl``, ``[device ms, kernel launches]`` a call of the
    halo exchange of one more tick, called alone (after every event
    timing: the profiler is attached by now anyway)."""
    calls = []
    saved = [(attr, getattr(megaspace, attr))
             for attr in ("exchange_halo_2d", "exchange_halo")]
    for attr, fn in saved:
        setattr(megaspace, attr, lambda *a, fn=fn, **kw: calls.append(
            (fn, a, kw)) or fn(*a, **kw))
    try:
        tick(st, inputs)
    finally:
        for attr, fn in saved:
            setattr(megaspace, attr, fn)
    fn, a, kw = calls[0]
    return {impl: list(kernels.device_ms(
        lambda impl=impl: fn(*a, **{**kw, "impl": impl}), 5))
        for impl in halo.HALO_IMPLS}


def _tick_times(tick, st, inputs, n):
    """Run ``n`` ticks; (state after them, each tick's ms by CUDA
    events as f64[n])."""
    ev = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, _out = tick(st, inputs)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return st, torch.tensor([a.elapsed_time(b) for a, b in ev],
                            dtype=torch.float64)


def _p50_p99(ms) -> list[float]:
    return ms.quantile(torch.tensor([0.5, 0.99], dtype=torch.float64)
                       ).tolist()


def _stats(ms: list[float]) -> dict:
    t = torch.tensor(ms, dtype=torch.float64)
    p50, p99 = _p50_p99(t)
    return {"mean": float(t.mean()), "p50": p50, "p99": p99}


def _device_rows(prof, window: int):
    """(busy ms over the window, the top kernels, the csrc/ kernels,
    memset ms a tick) of a profiled window of ``window`` ticks."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top = [{"kernel": e.key[:90], "calls_per_tick": e.count / window,
            "ms_per_tick": e.device_time_total / 1e3 / window}
           for e in events[:15]]
    csrc, ours = {}, _csrc_kernel_names()
    for e in events:
        key = e.key.removeprefix("void ")
        name = key.split("::", 1)[-1].split("(")[0].split("<")[0]
        if key.startswith("(anonymous namespace)::") and name in ours:
            row = csrc.setdefault(name, {"ms_per_tick": 0.0,
                                         "calls_per_tick": 0.0})
            row["ms_per_tick"] += e.device_time_total / 1e3 / window
            row["calls_per_tick"] += e.count / window
    memset_ms = sum(e.device_time_total for e in events
                    if e.key.startswith("Memset")) / 1e3 / window
    return busy_ms, top, csrc, memset_ms


def _event_timed(fn, events: list):
    """``fn`` with CUDA events recorded around each call into
    ``events``."""
    def timed(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    return timed


def _world_main(args, card: str) -> int:
    """``--world``: where a served World.tick's time goes."""
    on = args.planes == "on"
    world_kw = {} if on else dict(telemetry_live=False, residency=False,
                                  audit=False, resident=False)
    served = serve_world(args.n // args.spaces, seed=0, device="cuda",
                         world_kw=world_kw, spaces=args.spaces)
    w = served.world
    for _ in range(3):
        served.stage()
        w.tick()
    real, events = w._step, []
    w._step = _event_timed(real, events)
    fold_events, carry_events = [], []
    real_fold, real_carry = w._telem_fn, manager._carry_into
    if real_fold is not None:
        w._telem_fn = _event_timed(real_fold, fold_events)
    manager._carry_into = _event_timed(real_carry, carry_events)
    walls, counts, audit_walls = [], [], []
    names = ("enter_n", "leave_n", "sync_n", "delta_rows_n")
    for _ in range(args.ticks):
        served.stage()
        sample = w.audit is not None and w.audit.want_sample(w.tick_count)
        t0 = time.perf_counter()
        w.tick()
        walls.append((time.perf_counter() - t0) * 1e3)
        if sample:
            audit_walls.append(walls[-1])
        counts.append([int(getattr(w.last_outputs, k).sum())
                       for k in names])
    w._step, manager._carry_into = real, real_carry
    if real_fold is not None:
        w._telem_fn = real_fold
    torch.cuda.synchronize()
    spans: dict[str, list] = {}
    for rec in metrics.timeline.records()[-args.ticks:]:
        for name, _, d, _ in rec[2]:
            spans.setdefault(name, []).append(d * 1e3)
    window = 5
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    wall_ms = 0.0
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(window):
            served.stage()
            t0 = time.perf_counter()
            w.tick()
            wall_ms += (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    busy_ms, top, csrc, memset_ms = _device_rows(prof, window)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    spaces = f"_spaces{args.spaces}" if args.spaces > 1 else ""
    (out / f"profile_tick_world_{args.planes}{spaces}.txt").write_text(
        f"{card}\n" + prof.key_averages().table(
            sort_by="device_time_total", row_limit=60))
    print(json.dumps({
        "gpu": card, "n": args.n, "world": True, "spaces": args.spaces,
        "population": len(w.entities) - 2, "populate_s": served.populate_s,
        "ticks": args.ticks, "world_tick_ms": _stats(walls),
        "per_tick": dict(zip(names, np.mean(counts, axis=0).tolist())),
        "caps": {k: getattr(w.cfg, k.replace("_n", "_cap"))
                 for k in names},
        "spans_ms": {k: _stats(v) for k, v in spans.items()},
        "step_event_ms": _stats([a.elapsed_time(b) for a, b in events]),
        "planes": args.planes,
        "fold_event_ms": _stats([a.elapsed_time(b)
                                 for a, b in fold_events])
        if fold_events else None,
        "carry_event_ms": _stats([a.elapsed_time(b)
                                  for a, b in carry_events])
        if carry_events else None,
        "audit_tick_ms": audit_walls,
        "window_ticks": window, "window_wall_ms": wall_ms,
        "busy_ms": busy_ms / window,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "kernels_top": top, "csrc_kernels": csrc,
        "memset_ms_per_tick": memset_ms,
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--mega", type=int, default=0, metavar="TILES",
                    help="profile the megaspace tick over TILES tiles")
    ap.add_argument("--world", action="store_true",
                    help="profile the served World's tick")
    ap.add_argument("--planes", choices=("on", "off"), default="on",
                    help="with --world: the World at its defaults, or "
                         "without its planes and resident carry")
    ap.add_argument("--uncut", action="store_true",
                    help="profile the bench world uncut (the Verlet skin)")
    ap.add_argument("--q16", action="store_true",
                    help="with --uncut: at precision='q16'")
    ap.add_argument("--behavior", choices=("random_walk", "btree", "mlp"),
                    default="random_walk",
                    help="BASELINE config 5: the btree or mlp behavior")
    ap.add_argument("--scenario", default=None,
                    help="a registry scenario (scenarios/spec.py)")
    ap.add_argument("--spaces", type=int, default=1,
                    help="split --n over this many Spaces (the batched "
                         "tick; with --world, a World of that many)")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if args.spaces < 1 or args.n % args.spaces:
        ap.error("--spaces must divide --n")
    behaviors = args.behavior != "random_walk" or args.scenario is not None
    if behaviors and (args.mega or args.world or args.spaces > 1):
        ap.error("--behavior and --scenario profile the single-Space tick")
    if args.spaces > 1 and (args.mega or args.uncut):
        ap.error("--spaces runs the skin-0 bench world or --world")
    if not torch.cuda.is_available():
        print("profile_tick needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    if args.world:
        return _world_main(args, card)
    if args.mega:
        mc = mega_config(args.n, args.mega)
        st, inputs = mega_world(mc, args.n, seed=0, device="cuda")
        tick = make_mega_tick(mc)
        stage_list = MEGA_STAGES
    elif args.uncut or behaviors:
        grid_kw = dict(precision="q16") if args.q16 else {}
        if not args.uncut:
            grid_kw["skin"] = 0.0
        cfg = scenario_config(args.n, args.scenario, **grid_kw) \
            if args.scenario else behavior_config(args.n, args.behavior,
                                                  **grid_kw)
        st, inputs, policy = behavior_world(cfg, seed=0, device="cuda")
        tick = functools.partial(make_tick(cfg), policy=policy)
        stage_list = STAGES
    elif args.spaces > 1:
        cfg = multi_config(args.spaces, args.n // args.spaces)
        st, inputs = multi_world(cfg, args.spaces, seed=0, device="cuda")
        tick = make_tick(cfg)
        stage_list = STAGES
    else:
        cfg = slice_config(args.n)
        st, inputs = bench_world(cfg, seed=0, device="cuda")
        tick = make_tick(cfg)
        stage_list = STAGES
    for _ in range(3):
        st, _out = tick(st, inputs)
    torch.cuda.synchronize()
    st, before = _tick_times(tick, st, inputs, args.ticks)

    stage_list = [s for s in stage_list if hasattr(s[1], s[2])]
    marks = []
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in stage_list]
    for name, mod, attr in stage_list:
        setattr(mod, attr, _timed(getattr(mod, attr), name, marks))
    try:
        st, per_tick = _tick_times(tick, st, inputs, args.ticks)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    stages = {}
    for name, a, b in marks:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    stages = {k: v / args.ticks for k, v in stages.items()}
    tick_mean = float(per_tick.mean())
    tick_p50, tick_p99 = _p50_p99(per_tick)
    top_level = sum(v for k, v in stages.items() if k[1] == " ")
    stages["other (rng split, flags, new state, Python)"] = \
        tick_mean - top_level

    window = 5
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(window):
            st, _out = tick(st, inputs)
        b.record()
        torch.cuda.synchronize()
    window_ms = a.elapsed_time(b)
    st, after = _tick_times(tick, st, inputs, args.ticks)
    halo_dev = _halo_exchange(tick, st, inputs) if args.mega else None
    busy_ms, top, csrc, memset_ms = _device_rows(prof, window)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    suffix = "_mega" if args.mega else "_q16" if args.q16 else \
        "_uncut" if args.uncut else \
        f"_spaces{args.spaces}" if args.spaces > 1 else ""
    if behaviors:
        suffix += f"_{args.scenario or args.behavior}"
    (out / f"profile_tick{suffix}.txt").write_text(
        f"{card}\n" + prof.key_averages().table(
            sort_by="device_time_total", row_limit=60))
    print(json.dumps({
        "gpu": card, "n": args.n, "mega_tiles": args.mega,
        "spaces": args.spaces,
        "uncut": args.uncut, "q16": args.q16, "ticks": args.ticks,
        "behavior": args.behavior, "scenario": args.scenario,
        "tick_ms_mean": tick_mean, "tick_ms_p50": tick_p50,
        "tick_ms_p99": tick_p99,
        "tick_ms_p50_p99_unwrapped": _p50_p99(before),
        "halo_exchange": halo_dev,
        "tick_ms_p50_p99_after_profiler": _p50_p99(after),
        "stages_ms": stages,
        "window_ticks": window, "window_ms": window_ms,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / window_ms if window_ms else None,
        "kernels_top": top, "csrc_kernels": csrc,
        "memset_ms_per_tick": memset_ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
