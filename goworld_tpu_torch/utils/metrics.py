"""Metrics registry and per-tick timeline, the part of
``goworld_tpu/utils/metrics.py`` that the World and its planes use.

* :class:`Registry` — process-wide counters, gauges and fixed-bucket
  histograms keyed by name and labels, the port's own: its series never
  mix with the JAX package's in one process. The histograms take the
  drained telemetry lanes (:meth:`Histogram.add_counts`) and back the
  sync-age and residency trackers.
* :class:`TickTimeline` — a ring buffer of per-tick phase spans. The
  World opens a tick record and times its four phases in it
  (``flush_staging``, ``device_step``, ``fetch_outputs``,
  ``decode_fanout``), with the step's dispatch time folded in as tick
  args; ``profile_tick --world`` reads them back with
  :meth:`TickTimeline.records`.

A span is two ``perf_counter`` calls and one tuple append, so the
recorder stays on. The Prometheus export and the Chrome trace export
serve the debug HTTP endpoints, which are not ported yet.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "TickTimeline",
           "REGISTRY", "counter", "gauge", "histogram", "timeline",
           "DEFAULT_MS_BUCKETS"]

# latency buckets in milliseconds: sub-ms through the 16 ms roofline
# frame up to multi-second stalls
DEFAULT_MS_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 33.0, 66.0,
                      133.0, 266.0, 533.0, 1066.0, 2133.0, 4266.0)


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


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum + count. Buckets
    are upper bounds; an implicit ``+Inf`` bucket catches the rest."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        uppers = sorted(float(b) for b in buckets)
        if not uppers:
            raise ValueError("histogram needs at least one bucket")
        self._lock = threading.Lock()
        self._uppers = uppers
        self._counts = [0] * (len(uppers) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._uppers, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_n(self, v: float, n: int) -> None:
        """``n`` samples of the same value in one locked update (the
        record-weighted sync-age lanes)."""
        if n <= 0:
            return
        i = bisect.bisect_left(self._uppers, v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n

    def add_counts(self, counts, sum_: float = 0.0) -> None:
        """Merge a pre-bucketed count vector (``len(uppers)+1``
        entries, last = +Inf): the drained telemetry lanes, bucketed on
        the device with this class's bisect_left-on-upper-edges rule.
        ``sum_`` is optional: the lanes carry no per-sample sum."""
        if len(counts) != len(self._uppers) + 1:
            raise ValueError(
                f"count vector has {len(counts)} entries, histogram "
                f"has {len(self._uppers) + 1} buckets"
            )
        with self._lock:
            n = 0
            for i, c in enumerate(counts):
                c = int(c)
                self._counts[i] += c
                n += c
            self._count += n
            self._sum += float(sum_)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "buckets": list(zip(self._uppers, self._counts)),
                "inf": self._counts[-1],
                "sum": self._sum,
                "count": self._count,
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class Registry:
    """Process-wide metric registry. Metrics are created on first use
    and returned again on re-request (same name + labels), so call
    sites can hold direct references to the hot-path objects. A
    histogram family keeps the buckets of its first registration."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, buckets, {label-key tuple: metric})
        self._families: dict[str, tuple[str, str, tuple | None, dict]] = {}

    def _get(self, kind: str, name: str, help_: str, buckets,
             labels: dict[str, str]):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = (kind, help_, buckets, {})
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}")
            m = fam[3].get(key)
            if m is None:
                if kind == "counter":
                    m = Counter()
                elif kind == "gauge":
                    m = Gauge()
                else:
                    m = Histogram(fam[2])
                fam[3][key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, None, labels)

    def histogram(self, name: str, buckets=DEFAULT_MS_BUCKETS,
                  help: str = "", **labels) -> Histogram:
        return self._get("histogram", name, help, tuple(buckets), labels)

    def histogram_snapshot(self, name: str) -> list | None:
        """``[(labels, Histogram.snapshot()), ...]`` for a histogram
        family, or None when it doesn't exist (or isn't a histogram)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam[0] != "histogram":
                return None
            children = list(fam[3].items())
        return [(dict(key), m.snapshot()) for key, m in children]



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


def histogram(name: str, buckets=DEFAULT_MS_BUCKETS, help: str = "",
              **labels) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, help=help, **labels)
