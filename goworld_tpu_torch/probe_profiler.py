"""Whether torch.profiler keeps every device event of a session.

    python -m goworld_tpu_torch.probe_profiler

Prints one JSON line with two readings:

- ``sweep``: the fused sweep's kernel launches a call at the bench
  world's shapes (20 back-to-back calls, one kernel each) by
  ``kernels.device_ms`` at the process's first profiler session and
  ``WAITS_S`` seconds later, each beside the reads ``device_ms`` had to
  take again because a session lost events;
- ``sessions``: ``SESSIONS`` back-to-back sessions of each variant in
  ``VARIANTS`` (a host sleep after the session starts, then that many
  lead marker kernels, ``torch.cuda._sleep``'s), each session 100 small
  kernels and a last marker, with the sessions that lost any event, the
  most events one lost, the losses that were not a prefix of the
  session's events, and the sessions ``kernels.whole_session`` keeps.

Losses that are prefixes, and lead markers that absorb them, are why
``device_ms`` reads as it does. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops import aoi
from goworld_tpu_torch.workload import bench_world, slice_config

REPS = 20
WAITS_S = (0.0, 30.0, 60.0)
SESSIONS = 30
VARIANTS = ((0.0, 1), (0.5, 1), (0.0, 32))  # (host sleep s, lead markers)


def marked_session(x: torch.Tensor, pre_sleep: float,
                   lead: int) -> tuple[list[bool], int]:
    """One session's device kernels in order of start, True for a marker,
    and the count it launched."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(pre_sleep)
        for _ in range(lead):
            torch.cuda._sleep(1)
        for _ in range(100):
            x.add_(1)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    return ["spin_kernel" in e.name for e in ev], lead + 101


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_profiler needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = slice_config(1 << 20)
    g = cfg.grid
    st, _ = bench_world(cfg, 0, "cuda")
    fh = aoi.front_half(g, st.pos, st.alive, None, st.aoi_radius,
                        st.has_client.to(torch.int32) << 1, with_stats=True)
    sweep_args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st.pos, fh.reach, g.k,
                  g.cell_cap, fh.code, True)
    t0 = time.perf_counter()
    sweep = []
    for wait in WAITS_S:
        time.sleep(max(0.0, wait - (time.perf_counter() - t0)))
        ms, launches = kernels.device_ms(
            lambda: aoi.sweep_fused_cuda(*sweep_args), REPS)
        sweep.append({"s_after_first": time.perf_counter() - t0,
                      "device_ms": ms, "launches_per_call": launches,
                      "rereads": kernels.PROFILE_REREADS})
    x = torch.zeros(1 << 16, device="cuda")
    sessions = {f"sleep {p} s, lead {n}": {
        "lost_any": 0, "most_lost": 0, "not_prefix": 0, "whole": 0}
        for p, n in VARIANTS}
    for _ in range(SESSIONS):
        for (pre, lead), r in zip(VARIANTS, sessions.values()):
            got, launched = marked_session(x, pre, lead)
            want = [True] * lead + [False] * 100 + [True]
            r["lost_any"] += len(got) != launched
            r["most_lost"] = max(r["most_lost"], launched - len(got))
            r["not_prefix"] += got != want[launched - len(got):]
            r["whole"] += kernels.whole_session(got)
    print(json.dumps({"gpu": card, "reps": REPS, "sweep": sweep,
                      "sessions": SESSIONS, "by_variant": sessions}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
