"""Flush subnormals on the CPU, as XLA's CPU runtime does.

XLA's CPU executable runs under a scoped flush-to-zero and
denormals-are-zero mode: every float op of the JAX package's tick
computes a subnormal result as zero and reads a subnormal input as
zero. The mode lives in each thread's MXCSR register. The port's ticks
on the CPU (``make_tick``'s and ``make_mega_tick``'s tick, and the
World's step with its telemetry fold) run their float work inside
:func:`flushed`, which sets the mode on the calling thread and on every
thread of that thread's OpenMP team (ATen's intra-op pool), and puts
the caller's floating-point environment back on exit, on the caller and
its pool. Other threads, numpy and the JAX package in the same process
see no change, and so does a float helper called outside a tick.

The pool's threads are reached through ``GOMP_parallel`` of the
``libgomp`` that torch loaded: a team of ``torch.get_num_threads()``
threads started from the calling thread is the pool that ATen's
``omp parallel`` regions of that thread use (libgomp keeps one pool per
master thread and hands its threads out in order), whether it started
before the scope or starts with it. Each thread of the team runs libm's
``fesetenv`` on one shared, read-only environment: the caller's with
FTZ and DAZ set on entry, the caller's as it was on exit. No Python
runs on the pool's threads, so the interpreter lock is never handed
round. The caller leaves the scope exactly as it entered; the pool's
threads leave it in the caller's environment, which is theirs unless
something set one of them apart (a pool started under another mode).

Tensors on the card are not touched: CUDA keeps subnormals in
PyTorch's elementwise kernels and in a kernel built without
``-ftz=true`` (``ROADMAP.md`` Queue C4).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

_FENV_BYTES = 32      # sizeof(fenv_t) on x86-64 glibc
_MXCSR_AT = 28        # the mxcsr word's offset in it
_FTZ_DAZ = 0x8040     # MXCSR flush-to-zero (bit 15), denormals-are-zero (6)

_tls = threading.local()


@functools.cache
def _libs() -> tuple[ctypes.CDLL, ctypes.CDLL, int]:
    """(the libgomp torch runs its intra-op pool on, libm, the address
    of libm's ``fesetenv``)."""
    info = torch.__config__.parallel_info()
    if "ATen parallel backend: OpenMP" not in info:
        raise NotImplementedError(
            "the subnormal flush reaches ATen's pool through libgomp; this "
            "torch's parallel backend is not OpenMP (ROADMAP.md Queue C4)")
    path = None
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libgomp" in line:
                path = line.split()[-1]
                break
    if path is None:
        raise NotImplementedError(
            "torch runs on OpenMP but no libgomp is mapped; the subnormal "
            "flush knows only libgomp's pool (ROADMAP.md Queue C4)")
    gomp = ctypes.CDLL(path)
    gomp.GOMP_parallel.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint, ctypes.c_uint]
    gomp.GOMP_parallel.restype = None
    libm = ctypes.CDLL("libm.so.6")
    for fn in (libm.fegetenv, libm.fesetenv):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return gomp, libm, ctypes.cast(libm.fesetenv, ctypes.c_void_p).value


def _set_team(env) -> None:
    """``fesetenv(env)`` on every thread of the calling thread's OpenMP
    team of ``torch.get_num_threads()`` (the caller is thread 0)."""
    gomp, _, fesetenv = _libs()
    gomp.GOMP_parallel(fesetenv, ctypes.addressof(env),
                       torch.get_num_threads(), 0)


def _flushing(env: bytes) -> bytes:
    mxcsr = int.from_bytes(env[_MXCSR_AT:_MXCSR_AT + 4], "little")
    return (env[:_MXCSR_AT] + (mxcsr | _FTZ_DAZ).to_bytes(4, "little")
            + env[_MXCSR_AT + 4:])


@contextlib.contextmanager
def flushed(device=None):
    """Flush-to-zero and denormals-are-zero on the calling thread and
    its intra-op pool while the block runs; a no-op for a device other
    than the CPU and inside an open scope of the same thread."""
    if (device is not None and torch.device(device).type != "cpu") \
            or getattr(_tls, "depth", 0):
        yield
        return
    saved = ctypes.create_string_buffer(_FENV_BYTES)
    if _libs()[1].fegetenv(saved):
        raise OSError("fegetenv failed")
    flush = ctypes.create_string_buffer(_flushing(saved.raw), _FENV_BYTES)
    _tls.depth = 1
    try:
        _set_team(flush)
        yield
    finally:
        _tls.depth = 0
        _set_team(saved)

