"""Operation monitor — in-process op latency/count accounting; the port's
copy of ``goworld_tpu/utils/opmon.py``, with a registry of its own.

Reference being rebuilt: ``engine/opmon`` (``opmon.go:37-118``): named
operations record count / cumulative time / max time; ops exceeding a
warn threshold log immediately. The World records its tick here. Also
covers ``engine/gwvar`` (expvar flags): :func:`expose`/:func:`vars` give a
process-wide string->value map (the World exposes its AOI gauges).
"""

from __future__ import annotations

import threading
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
