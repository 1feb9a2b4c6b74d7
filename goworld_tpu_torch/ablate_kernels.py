"""Where the kernels' time goes, by ablation on the card.

    python -m goworld_tpu_torch.ablate_kernels [--n 1048576]
    python -m goworld_tpu_torch.ablate_kernels --mlp [--mlp-old PATH]

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

``--mlp`` does the same for ``csrc/npc_mlp.cu`` on config 5's
observations at ``--n`` rows (hidden 128), and for an older
``npc_mlp.cu`` given by ``--mlp-old`` (its interface has no tanh table:
the one-thread-per-column design it replaced). Each copy's output is
held against ``npc_mlp_plain`` on those observations and on
``workload.mlp_underflow_case`` (layer-2 products below float32's
2^-149 grid), its time by CUDA events and by the profiler.
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


# name: (old source?, substitutions) of csrc/npc_mlp.cu or --mlp-old
MLP_ABLATIONS = {
    "mlp": (False, []),
    "mlp, layer 2 always on the rounded mul and add": (
        False, [("const bool rounded = __syncthreads_or(low);",
                 "const bool rounded = __syncthreads_or(low) || true;")]),
    "mlp, layer 2 always FFMA (no guard)": (
        False, [("const bool rounded = __syncthreads_or(low);",
                 "const bool rounded = __syncthreads_or(low) && false;")]),
    "mlp, tanh as the identity (no table lookup)": (
        False, [("  const uint32_t u = __float_as_uint(x) >> 16;\n  return "
                 "__uint_as_float(\n      (static_cast<uint32_t>(tab[u & "
                 "0x7fffu]) | (u & 0x8000u)) << 16);",
                 "  return x;")]),
    "mlp, layer 1 by FFMA (wrong on overflow)": (
        False, [("  tile_dot<L, false>(&s.x0[0][0]",
                 "  tile_dot<L, true>(&s.x0[0][0]")]),
    "mlp, k loop unrolled 2": (
        False, [("#pragma unroll 8\n  for (int k0 = 0;",
                 "#pragma unroll 2\n  for (int k0 = 0;")]),
    "mlp, k loop unrolled 4": (
        False, [("#pragma unroll 8\n  for (int k0 = 0;",
                 "#pragma unroll 4\n  for (int k0 = 0;")]),
    "mlp, no output layer": (
        False, [("    switch (l3) {", "    if (n < 0) switch (l3) {")]),
    "old": (True, []),
    "old, fmaf for the rounded mul and add": (
        True, [("        res[i][r] = __fadd_rn(res[i][r], __fmul_rn(x[r], "
                "w));", "        res[i][r] = fmaf(x[r], w, res[i][r]);")]),
    "old, float32 tanhf for the float64 tanh": (
        True, [("  return round_bf(__double2float_rn(tanh(static_cast<"
                "double>(x))));", "  return round_bf(tanhf(x));")]),
    "old, both": (
        True, [("        res[i][r] = __fadd_rn(res[i][r], __fmul_rn(x[r], "
                "w));", "        res[i][r] = fmaf(x[r], w, res[i][r]);"),
               ("  return round_bf(__double2float_rn(tanh(static_cast<"
                "double>(x))));", "  return round_bf(tanhf(x));")]),
}


def _build(src, subs, tmp: Path, tag: int):
    text = (src if isinstance(src, Path) else kernels.CSRC / src) \
        .read_text()
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


def _mlp_call(so, old: bool, obs, ws):
    import ctypes

    from goworld_tpu_torch.ops.mlp import layer_lanes, tanh_table

    lib = ctypes.CDLL(str(so))
    fn = lib.gw_npc_mlp
    sig = kernels.SIGNATURES["gw_npc_mlp"][0]
    fn.argtypes = sig[:12] + sig[13:] if old else sig
    fn.restype = ctypes.c_int
    out = torch.full((obs.shape[0], 3), -1.0, device=obs.device)
    lanes = layer_lanes(obs.shape[0], ws[0].shape[1])
    table = () if old else (tanh_table(obs.device).data_ptr(),)

    def call():
        kernels.check(fn(obs.data_ptr(), obs.shape[0], ws[0].shape[1],
                         *(w.data_ptr() for w in ws), *lanes, *table,
                         out.data_ptr(), kernels.stream_handle(obs.device)),
                      "npc_mlp")
        return out
    return call


def _events_ms(fn, reps: int) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def mlp_main(n: int, old_src: Path | None, card: str) -> int:
    from goworld_tpu_torch.core.step import make_tick
    from goworld_tpu_torch.models.npc_policy import build_obs
    from goworld_tpu_torch.ops.mlp import npc_mlp_plain
    from goworld_tpu_torch.workload import (behavior_config, behavior_world,
                                            mlp_underflow_case)

    cfg = behavior_config(n, "mlp")
    st, inputs, pol = behavior_world(cfg, 0, "cuda")
    st, _ = make_tick(cfg, device="cuda")(st, inputs, pol)
    obs = build_obs(st.pos, st.vel, st.yaw, st.nbr, st.nbr_cnt,
                    (cfg.grid.extent_x, cfg.grid.extent_z))
    ws = tuple(getattr(pol, k) for k in ("w1", "b1", "w2", "b2", "w3", "b3"))
    cases = {"config 5": (obs, ws),
             "underflow": mlp_underflow_case(1 << 16, 0, "cuda")}
    plain = {k: npc_mlp_plain(*v[:1], *v[1]) for k, v in cases.items()}
    todo = {k: v for k, v in MLP_ABLATIONS.items()
            if old_src is not None or not v[0]}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: _build(old_src if old else "npc_mlp.cu", subs,
                               Path(tmp), t)
                  for t, (name, (old, subs)) in enumerate(todo.items())}
        for name, (old, _) in todo.items():
            proc, so = builds[name]
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
            same = {}
            for case, (x, w) in cases.items():
                got = _mlp_call(so, old, x, w)().clone()
                ref = plain[case]
                same[case] = bool(
                    torch.equal(got.isnan(), ref.isnan())
                    and torch.equal(got.nan_to_num().view(torch.int32),
                                    ref.nan_to_num().view(torch.int32)))
            call = _mlp_call(so, old, obs, ws)
            rows.append({"ablation": name, "ms": _events_ms(call, 20),
                         "device_ms": kernels.device_ms(call, 10)[0],
                         "same_as_plain": same,
                         "ptxas": [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln]})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"gpu": card, "n": n, "hidden": pol.hidden,
                      "mlp_ablations": rows}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--mlp", action="store_true",
                    help="ablate csrc/npc_mlp.cu instead of the sweep/sort")
    ap.add_argument("--mlp-old", type=Path, default=None,
                    help="also ablate this older npc_mlp.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_kernels needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    if args.mlp:
        return mlp_main(args.n, args.mlp_old, card)
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
