"""Whether torch.profiler keeps every device event late in a process.

    python -m goworld_tpu_torch.probe_profiler

Reads the fused sweep's kernel launches a call at the bench world's
shapes (20 back-to-back calls, one kernel each) with
``kernels.device_ms`` at the process's first profiler session and again
WAIT_S seconds later, and prints one JSON line with each reading's
launches and device ms a call. A later reading under 1 launch a call
shows the profiler dropping device events, which is why
``chip_smoke.py`` reads every profile together, after its timed paths.
Needs a CUDA card.
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
WAIT_S = 100.0  # about the gap between chip_smoke.py's first and last reads


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
    rows = []
    for wait in (0.0, WAIT_S):
        time.sleep(max(0.0, wait - (time.perf_counter() - t0)))
        ms, launches = kernels.device_ms(
            lambda: aoi.sweep_fused_cuda(*sweep_args), REPS)
        rows.append({"s_after_first": time.perf_counter() - t0,
                     "device_ms": ms, "launches_per_call": launches})
    print(json.dumps({"gpu": card, "reps": REPS, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
