"""Operation monitor — in-process op latency/count accounting.

The port's copy of ``goworld_tpu/utils/opmon.py``, with a table of its
own.

Reference being rebuilt: ``engine/opmon`` (``opmon.go:37-118``): named
operations record count / cumulative time / max time; a periodic dump logs
the table; ops exceeding a warn threshold log immediately. Used by the gate
around packet handling (``GateService.go:435-442``) and by storage ops
(``storage.go:165``). Also covers ``engine/gwvar`` (expvar flags): instead
of an HTTP expvar page, :func:`expose`/:func:`vars` give a process-wide
string->value map that the CLI ``status`` and tests can read.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from goworld_tpu_torch.utils import log

logger = log.get("opmon")

_WARN_THRESHOLD = 0.120  # seconds (reference consts.OPMON_WARN 120ms-ish)


class _OpStat:
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0


class Monitor:
    """Process-wide op stats. One global instance (:data:`monitor`), plus
    per-subsystem instances where isolation helps tests."""

    def __init__(self, warn_threshold: float = _WARN_THRESHOLD):
        self._stats: dict[str, _OpStat] = {}
        self._lock = threading.Lock()
        self.warn_threshold = warn_threshold

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _OpStat()
            st.count += 1
            st.total += seconds
            if seconds > st.max:
                st.max = seconds
        if seconds > self.warn_threshold:
            logger.warning("op %s took %.1f ms", name, seconds * 1e3)

    def op(self, name: str) -> "_Op":
        """``with monitor.op("handle_packet"): ...``"""
        return _Op(self, name)

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": st.count,
                    "avg_ms": (st.total / st.count * 1e3) if st.count else 0.0,
                    "max_ms": st.max * 1e3,
                }
                for name, st in self._stats.items()
            }

    def dump(self) -> None:
        """Reference's periodic dump (``opmon.go:92-118``)."""
        for name, row in sorted(self.snapshot().items()):
            logger.info(
                "op %-32s count=%-8d avg=%.2fms max=%.2fms",
                name, row["count"], row["avg_ms"], row["max_ms"],
            )

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


class _Op:
    __slots__ = ("_mon", "_name", "_t0")

    def __init__(self, mon: Monitor, name: str):
        self._mon = mon
        self._name = name

    def __enter__(self) -> "_Op":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._mon.record(self._name, time.perf_counter() - self._t0)


monitor = Monitor()


# -----------------------------------------------------------------------
# gwvar-style exposed variables (reference engine/gwvar/gwvar.go:1-29)
# -----------------------------------------------------------------------
_vars: dict[str, Any] = {}
_vars_lock = threading.Lock()


def expose(name: str, value: Any) -> None:
    with _vars_lock:
        _vars[name] = value


def vars() -> dict[str, Any]:
    with _vars_lock:
        return dict(_vars)
