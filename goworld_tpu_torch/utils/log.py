"""Leveled logging with per-process source tags, the port's copy of
``goworld_tpu/utils/log.py``.

Loggers hang under ``goworld_tpu_torch``, so that the two packages' logs
stay apart in one process (the tests run both). Every line emitted
inside a traced hop (:mod:`goworld_tpu_torch.utils.tracing`) carries
``trace=<trace_id>``.
"""

from __future__ import annotations

import logging
import sys

# stdlib-only module, imports nothing back from log — no cycle
from goworld_tpu_torch.utils import tracing

_root = logging.getLogger("goworld_tpu_torch")


class _TraceIdFilter(logging.Filter):
    """Stamp ``record.trace`` with the current trace id (empty when no
    traced hop is active — the common case costs one module-bool load)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.trace = ""
        if tracing.active:
            ctx = tracing.current()
            if ctx is not None:
                record.trace = f" trace={ctx.trace_hex}"
        return True


_trace_filter = _TraceIdFilter()


def setup(source: str, level: str = "info", logfile: str | None = None) -> None:
    """Configure logging for this process. ``source`` tags every line."""
    _root.setLevel(getattr(logging, level.upper(), logging.INFO))
    _root.handlers.clear()
    fmt = logging.Formatter(
        f"%(asctime)s %(levelname).1s {source} %(name)s:"
        f"%(trace)s %(message)s"
    )
    h: logging.Handler = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    h.addFilter(_trace_filter)
    _root.addHandler(h)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        fh.addFilter(_trace_filter)
        _root.addHandler(fh)
    _root.propagate = False


def get(name: str) -> logging.Logger:
    return _root.getChild(name)
