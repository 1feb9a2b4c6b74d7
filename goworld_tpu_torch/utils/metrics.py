"""Metrics registry and per-tick timeline, the part of
``goworld_tpu/utils/metrics.py`` that the World uses.

* :class:`Registry` — process-wide counters and gauges keyed by name
  and labels, the port's own: its series never mix with the JAX
  package's in one process.
* :class:`TickTimeline` — a ring buffer of per-tick phase spans. The
  World opens a tick record and times its four phases in it
  (``flush_staging``, ``device_step``, ``fetch_outputs``,
  ``decode_fanout``), with the step's dispatch time folded in as tick
  args; ``profile_tick --world`` reads them back with
  :meth:`TickTimeline.records`.

A span is two ``perf_counter`` calls and one tuple append, so the
recorder stays on. The histograms, the Prometheus export and the Chrome
trace export serve the debug HTTP endpoints, which are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["Counter", "Gauge", "Registry", "TickTimeline", "REGISTRY",
           "counter", "gauge", "timeline"]


class Counter:
    """Monotonic counter (``_total`` naming convention)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Instantaneous value (queue depths, backlog, flags)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Registry:
    """Process-wide metric registry. Metrics are created on first use
    and returned again on re-request (same name + labels), so call
    sites can hold direct references to the hot-path objects."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, {label-key tuple: metric})
        self._families: dict[str, tuple[str, str, dict]] = {}

    def _get(self, kind: str, name: str, help_: str,
             labels: dict[str, str]):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = (kind, help_, {})
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}")
            m = fam[2].get(key)
            if m is None:
                m = fam[2][key] = Counter() if kind == "counter" \
                    else Gauge()
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)



class _Span:
    """``with timeline.span("device_step"): ...`` — records a phase span
    into the currently open tick. No-op when no tick is open."""

    __slots__ = ("_tl", "_name", "_args", "_t0")

    def __init__(self, tl: "TickTimeline | None", name: str, args):
        self._tl = tl
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        tl = self._tl
        if tl is None:
            return
        open_ = tl._open
        if open_ is None:
            return
        start = self._t0 - open_[1]
        open_[2].append(
            (self._name, start, time.perf_counter() - self._t0,
             self._args)
        )


_NULL_SPAN = _Span(None, "", None)


class TickTimeline:
    """Ring buffer of per-tick phase spans. One open tick at a time; the
    logic thread opens and closes ticks and records spans, any thread
    may read the records."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._recs: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # open tick: [wall_us, perf_t0, spans, args]
        self._open: list | None = None

    @property
    def is_open(self) -> bool:
        return self._open is not None

    def begin_tick(self) -> None:
        """Open a tick record; an unclosed previous tick is discarded."""
        self._open = [time.time() * 1e6, time.perf_counter(), [], {}]

    def span(self, name: str, **args) -> _Span:
        if self._open is None:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def set_tick_args(self, **kw) -> None:
        """Fold extra attribution into the open tick's args."""
        if self._open is not None:
            self._open[3].update(kw)

    def end_tick(self) -> float | None:
        """Close the open tick; returns its wall duration in seconds."""
        open_, self._open = self._open, None
        if open_ is None:
            return None
        dur = time.perf_counter() - open_[1]
        with self._lock:
            self._recs.append((open_[0], dur, open_[2], open_[3]))
        return dur

    def records(self) -> list:
        """(wall_us, seconds, [(span, start s, seconds, args)], args)
        per closed tick, oldest first."""
        with self._lock:
            return list(self._recs)



REGISTRY = Registry()
timeline = TickTimeline()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help=help, **labels)

