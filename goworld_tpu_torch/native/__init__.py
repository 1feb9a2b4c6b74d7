"""Build and load the package's native host cores.

Three C++ sources beside this file run on the host, off the
interpreter's hot path: ``packet_codec.cpp`` (the sync-record batch
codec of :mod:`goworld_tpu_torch.net.codec`), ``kcp_core.cpp`` (the KCP
ARQ state machine of :mod:`goworld_tpu_torch.net.kcp`) and
``snappy_core.cpp`` (the snappy block codec and CRC32C of
:mod:`goworld_tpu_torch.net.snappy`). Each is compiled with ``g++`` (or
``$CXX``) at first use into ``goworld_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed on a hash of its source and flags, so
an edited source rebuilds and an unchanged one loads at once, and it is
loaded with ``ctypes``, as the CUDA kernels are (:mod:`goworld_tpu_torch.
kernels`). The build writes a temporary file and renames it into place,
so processes that build at once never load a half-written library.

Nothing here falls back: a missing compiler, a failed build or a failed
load raises. ``python -m goworld_tpu_torch build`` builds all three
(:func:`build_all`, one compiler per source, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-shared")
CORES = ("packet_codec", "kcp_core", "snappy_core")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path(name: str) -> Path:
    """Where the library of core ``name`` for its current source lives."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one compiler for core ``name``; None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    try:
        proc = subprocess.Popen(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(
            f"cannot run the C++ compiler {_cxx()!r} for {name}.cpp "
            f"({exc}); the native cores of goworld_tpu_torch are built "
            "at first use") from exc
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise RuntimeError(f"{_cxx()} failed on {name}.cpp:\n{text}")
    os.replace(tmp, out)


def build(name: str) -> Path:
    """Compile core ``name`` unless its library exists; its path."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return library_path(name)


def build_all() -> list[Path]:
    """Build every core, one compiler per source started together."""
    started = [(n, _start(n)) for n in CORES]
    for name, s in started:
        if s is not None:
            _finish(name, s)
    return [library_path(n) for n in CORES]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of core ``name`` (built on first call)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(
                    f"cannot load the native core {path}: {exc}") from exc
            _loaded[name] = lib
    return lib
