"""Build, load and count the package's CUDA kernels.

The sources in ``csrc/`` are compiled for Hopper (``sm_90a``) with
``nvcc`` at first use, one ``nvcc`` per source started together, and
linked into one shared library with a plain C interface. The library
lands in ``_build/`` (listed in ``.gitignore``) under a name keyed on a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. It is loaded with ``ctypes``.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
Only a wrapper given CPU tensors takes its kernel's plain version.

``LAUNCHES`` counts the kernel launches of each wrapper; a wrapper adds
one where it launches its kernel and nowhere else. :func:`device_ms`
reads a call's own time on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {"sweep_fused": 0, "counting_sort": 0, "halo_ship_phase": 0,
            "npc_mlp": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of goworld_tpu_torch are built from csrc/ at first use")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgoworld_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns (library path, build seconds, compiler log); the seconds are
    0 when an existing library was found."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)
        ]
        failed = []
        for s, p in zip(sources, procs):
            text, _ = p.communicate()
            log.append(f"== {s.name}\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out, time.perf_counter() - t0, "\n".join(log)


_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _U = ctypes.c_longlong, ctypes.c_ulonglong
# (argument types, result type) of each C entry point
SIGNATURES = {
    "gw_sweep_fused": ([_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P],
                       _I),
    "gw_counting_sort_scratch_len": ([_I, _I, _I], ctypes.c_longlong),
    "gw_counting_sort": ([_P, _I, _I, _I, _I, _I, _P, ctypes.c_longlong, _P,
                          _P, _P], _I),
    "gw_halo_ship_phase": ([_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, *[_P, _L, _P, _I, _U] * 2, _P], _I),
    "gw_npc_mlp_max_hidden": ([], _I),
    "gw_npc_mlp": ([_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                    _P], _I),
}


def load(path: Path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a kernel library and type its C entry points ``names``."""
    so = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(so, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build()[0])


def stream_handle(device: torch.device) -> int:
    """The current torch stream of ``device`` as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Reject a tensor the kernels do not take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms a call, kernel launches a call) of ``fn()`` from
    torch.profiler: every device activity of ``reps`` calls (kernels and
    memsets) summed, over ``reps``, after one call that is not profiled;
    memsets and copies are not counted as launches. The profiling
    interface stays attached after the session and slows every later
    launch from the host, so time by events before this, not after.
    Read every profile soon after the process's first session: later
    sessions lose device events (``probe_profiler.py``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.device_time_total for e in ev)
    launches = sum(e.count for e in ev
                   if not e.key.startswith(("Memset", "Memcpy")))
    return us / 1e3 / reps, launches / reps

