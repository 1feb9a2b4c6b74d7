"""Where the sweep and sort kernels' time goes, by ablation on the card.

    python -m goworld_tpu_torch.ablate_kernels [--n 1048576]

Builds ``csrc/aoi_fused.cu`` and ``csrc/counting_sort.cu`` as they ship
and in altered copies, one change each (a text substitution of the
source, compiled with the package's nvcc flags), runs every copy on the
front half of the bench world and prints one JSON line: per copy its
device time a call (torch.profiler, every device activity of the call)
and whether its output equals the shipped kernel's. An ablation that
drops work answers wrongly on purpose; it only shows what that work
costs. The substitutions match the sources' text exactly, so an edit
to a source can make one miss: the script then stops and names it.
Needs a CUDA card and nvcc; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops import aoi
from goworld_tpu_torch.ops.sort import radix_plan
from goworld_tpu_torch.workload import bench_world, slice_config

# name: (source, substitutions, sort plan or None for the shipped one)
ABLATIONS = {
    "sweep": ("aoi_fused.cu", [], None),
    "sweep, no bitonic sort": (
        "aoi_fused.cu",
        [("        if (size / 2 >= demand) break;", "        break;")], None),
    "sweep, no key stores": (
        "aoi_fused.cu",
        [("      if (lane < k) out[lane] = x;",
          "      if (lane < k && x == 0x1234567) out[lane] = x;")], None),
    "sweep, no prefetch of the next row": (
        "aoi_fused.cu",
        [("    if (t + 1 < items) {  // the next row's words load under this "
          "one\n      next_row = row_of(t + 1);\n      next = "
          "fetch(next_row);\n    }\n", ""),
         ("    const int row = next_row;\n    const int v = next;",
          "    const int row = row_of(t);\n    const int v = fetch(row);")],
        None),
    "sort": ("counting_sort.cu", [], None),
    "sort, __match_any_sync ranks": (
        "counting_sort.cu",
        [("    const unsigned peers = match_digit(d, dbits);",
          "    const unsigned peers = __match_any_sync(0xffffffffu, d);")],
        None),
    "sort, look-back window 16": (
        "counting_sort.cu",
        [("constexpr int kWindow = 4;", "constexpr int kWindow = 16;")],
        None),
    "sort, 2 passes of 10 bits": (
        "counting_sort.cu",
        [("constexpr int kMaxDigitBits = 8;",
          "constexpr int kMaxDigitBits = 10;")], (2, 10)),
    "sort, 4 passes of 5 bits": ("counting_sort.cu", [], (4, 5)),
}


def _build(src: str, subs, tmp: Path, tag: int):
    text = (kernels.CSRC / src).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"ablation text not in {src}: {old!r}")
        text = text.replace(old, new)
    cu, so = tmp / f"v{tag}.cu", tmp / f"v{tag}.so"
    cu.write_text(text)
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o",
         str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, so


def _sweep_call(so, fh, pos, g):
    lib = kernels.load(so, ["gw_sweep_fused"])
    q = fh.lo.shape[0]
    # filled, so that a copy that skips stores cannot match by chance
    top = torch.full((q, g.k), -1, dtype=torch.int32, device=pos.device)
    dem = torch.full((q,), -1, dtype=torch.int32, device=pos.device)
    c = fh.code

    def call():
        kernels.check(lib.gw_sweep_fused(
            fh.s_xz.data_ptr(), fh.s_w.data_ptr(), fh.s_w.shape[0],
            fh.lo.data_ptr(), fh.hi.data_ptr(), pos.data_ptr(),
            fh.reach.data_ptr(), q, g.k, g.cell_cap, pos.shape[0], 1,
            c[0], c[1], c[2], c[3], float(c[4]), c[5], None, top.data_ptr(),
            dem.data_ptr(), kernels.stream_handle(pos.device)), "sweep")
        return top, dem
    return call


def _sort_call(so, srow, plan):
    lib = kernels.load(so, ["gw_counting_sort_scratch_len",
                            "gw_counting_sort"])
    n = srow.shape[0]
    slen = lib.gw_counting_sort_scratch_len(n, *plan)
    scratch = torch.empty(slen, dtype=torch.int32, device=srow.device)
    out = torch.full((2, n), -1, dtype=torch.int32, device=srow.device)

    def call():
        kernels.check(lib.gw_counting_sort(
            srow.data_ptr(), n, 1, 0, plan[0], plan[1], scratch.data_ptr(),
            slen,
            out[0].data_ptr(), out[1].data_ptr(),
            kernels.stream_handle(srow.device)), "sort")
        return out[0], out[1]
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_kernels needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = slice_config(args.n)
    g = cfg.grid
    st, _ = bench_world(cfg, seed=0, device="cuda")
    fh = aoi.front_half(g, st.pos, st.alive, None, st.aoi_radius,
                        st.has_client.to(torch.int32) << 1)
    shipped_plan = radix_plan(max(1, fh.n_rows.bit_length()))
    rows, ref = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: _build(src, subs, Path(tmp), t)
                  for t, (name, (src, subs, _)) in enumerate(
                      ABLATIONS.items())}
        for name, (src, _, plan) in ABLATIONS.items():
            proc, so = builds[name]
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
            kind = "sweep" if src == "aoi_fused.cu" else "sort"
            call = (_sweep_call(so, fh, st.pos, g) if kind == "sweep" else
                    _sort_call(so, fh.srow, plan or shipped_plan))
            out = call()
            torch.cuda.synchronize()
            if kind not in ref:
                ref[kind] = [t.clone() for t in out]
            same = all(torch.equal(a, b) for a, b in zip(out, ref[kind]))
            rows.append({"ablation": name, "plan": plan or (
                shipped_plan if kind == "sort" else None),
                "device_ms": kernels.device_ms(call, 20)[0],
                "same_output": same})
    print(json.dumps({"gpu": card, "n": args.n, "ablations": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
