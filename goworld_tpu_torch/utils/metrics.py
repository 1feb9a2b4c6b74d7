"""Unified telemetry: metrics registry + per-tick timeline recorder.

The port's copy of ``goworld_tpu/utils/metrics.py``, with a registry of
its own: its series never mix with the JAX package's in one process.

The reference engine ships opmon + expvar + pprof on every process
(``engine/binutil/binutil.go:17-75``); :mod:`opmon` rebuilds the op
table and gwvar map, but nothing gave the live serve loops the per-tick
phase attribution that ``bench.py`` produces offline. This module is
that attribution as an always-on subsystem:

* :class:`Registry` — process-wide counters, gauges and fixed-bucket
  histograms. Lock-protected, labels rendered as name suffixes
  (``name{k="v"}``), exported in Prometheus text exposition format
  (served by ``debug_http`` as ``/metrics``).
* :class:`TickTimeline` — a ring buffer of per-tick phase spans
  (drain-inputs / device-step / fetch-outputs / fan-out, with the
  jitted step's timing folded in as tick args), exportable as Chrome
  ``chrome://tracing`` / Perfetto JSON (served as ``/trace``).

Overhead budget: one span is two ``perf_counter`` calls and one tuple
append; a full game tick records ~6 spans — microseconds against the
16 ms frame (< 0.1%), so the recorder stays on unconditionally.

Metric naming scheme (see docs/OBSERVABILITY.md):
``<subsystem>_<what>_<unit|total>`` — e.g. ``tick_latency_ms``,
``aoi_overflow_total``, ``gate_packet_handle_ms``,
``dispatcher_route_total{msgtype="..."}``.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import deque
from typing import Any

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "TickTimeline",
    "REGISTRY", "counter", "gauge", "histogram", "timeline",
    "DEFAULT_MS_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    "parse_prometheus_text",
]

# latency buckets in milliseconds: sub-ms through the 16 ms roofline
# frame up to multi-second stalls
DEFAULT_MS_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 33.0, 66.0,
                      133.0, 266.0, 533.0, 1066.0, 2133.0, 4266.0)
# size buckets (records per batch, queue depths, ...)
DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                        4096, 16384, 65536)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as integers."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


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

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

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
        """``n`` samples of the same value in one locked update — the
        record-weighted sync-age lanes observe one value per BATCH but
        must weight it by the records delivered (one bisect, not n)."""
        if n <= 0:
            return
        i = bisect.bisect_left(self._uppers, v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n

    def add_counts(self, counts, sum_: float = 0.0) -> None:
        """Merge a pre-bucketed count vector (``len(uppers)+1``
        entries, last = +Inf) — the in-graph telemetry lanes drain
        into the live registry through this (the device accumulator
        shares the bisect_left-on-upper-edges semantics of
        ``observe``, so merged counts are bit-compatible). ``sum_``
        is optional: lanes carry no per-sample sum, so quantiles stay
        exact while the ``_sum`` series only covers host-observed
        samples."""
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


class _Family:
    __slots__ = ("kind", "help", "buckets", "children")

    def __init__(self, kind: str, help_: str, buckets):
        self.kind = kind
        self.help = help_
        self.buckets = buckets
        # label-key tuple -> (labels dict, metric)
        self.children: dict[tuple, tuple[dict, Any]] = {}


class Registry:
    """Process-wide metric registry. Metrics are created on first use
    and returned again on re-request (same name + labels), so call
    sites can hold direct references to the hot-path objects."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get(self, kind: str, name: str, help_: str, buckets,
             labels: dict[str, str]):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, help_, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            child = fam.children.get(key)
            if child is None:
                if kind == "counter":
                    m: Any = Counter()
                elif kind == "gauge":
                    m = Gauge()
                else:
                    m = Histogram(fam.buckets)
                child = fam.children[key] = (
                    {k: str(v) for k, v in labels.items()}, m,
                )
            return child[1]

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, None, labels)

    def histogram(self, name: str, buckets=DEFAULT_MS_BUCKETS,
                  help: str = "", **labels) -> Histogram:
        return self._get("histogram", name, help, tuple(buckets), labels)

    def expose_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        out: list[str] = []
        with self._lock:
            # snapshot the children lists too: _get inserts new children
            # concurrently (e.g. the dispatcher's lazy per-msgtype route
            # counters) and dict iteration would die mid-scrape
            fams = [
                (name, fam.kind, fam.help, list(fam.children.values()))
                for name, fam in sorted(self._families.items())
            ]
        for name, kind, help_, children in fams:
            if help_:
                out.append(f"# HELP {name} {_escape(help_)}")
            out.append(f"# TYPE {name} {kind}")
            for labels, m in children:
                if kind in ("counter", "gauge"):
                    out.append(
                        f"{name}{_render_labels(labels)} {_fmt(m.value)}"
                    )
                    continue
                snap = m.snapshot()
                cum = 0
                for upper, cnt in snap["buckets"]:
                    cum += cnt
                    lb = dict(labels, le=_fmt(upper))
                    out.append(
                        f"{name}_bucket{_render_labels(lb)} {cum}"
                    )
                lb = dict(labels, le="+Inf")
                out.append(
                    f"{name}_bucket{_render_labels(lb)} {snap['count']}"
                )
                out.append(
                    f"{name}_sum{_render_labels(labels)} "
                    f"{_fmt(snap['sum'])}"
                )
                out.append(
                    f"{name}_count{_render_labels(labels)} "
                    f"{snap['count']}"
                )
        return "\n".join(out) + "\n" if out else ""

    def histogram_snapshot(self, name: str) -> list | None:
        """``[(labels, Histogram.snapshot()), ...]`` for a histogram
        family, or None when it doesn't exist (or isn't a histogram).
        The devprof ``/costs`` SLO verdict reads ``tick_latency_ms``
        through this instead of poking family internals."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != "histogram":
                return None
            children = list(fam.children.values())
        return [(dict(labels), m.snapshot()) for labels, m in children]

    def reset(self) -> None:
        """Drop every registered metric (tests)."""
        with self._lock:
            self._families.clear()


# =======================================================================
# per-tick phase timeline
# =======================================================================
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
    """Ring buffer of per-tick phase spans, exportable as Chrome trace
    JSON. One open tick at a time; the logic thread opens/closes ticks
    and records spans, any thread may snapshot (``/trace``)."""

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
        """Fold extra attribution (e.g. the jitted step's phase timing)
        into the open tick's args."""
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
        with self._lock:
            return list(self._recs)

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()
        self._open = None

    def coverage(self) -> float:
        """Fraction of recorded tick wall time covered by phase spans
        (spans are sequential, never nested)."""
        recs = self.records()
        total = sum(r[1] for r in recs)
        if total <= 0:
            return 0.0
        covered = sum(s[2] for r in recs for s in r[2])
        return covered / total

    def chrome_trace(self, process_name: str = "goworld_tpu") -> dict:
        """Chrome ``chrome://tracing`` / Perfetto JSON object format:
        one ``tick`` umbrella event per tick (tick args attached) with
        its phase spans nested inside on the same track."""
        pid = os.getpid()
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }, {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "logic"},
        }]
        for wall_us, dur, spans, args in self.records():
            events.append({
                "name": "tick", "ph": "X", "ts": wall_us,
                "dur": dur * 1e6, "pid": pid, "tid": 0,
                "args": args or {},
            })
            for name, start, sdur, sargs in spans:
                ev = {
                    "name": name, "ph": "X",
                    "ts": wall_us + start * 1e6, "dur": sdur * 1e6,
                    "pid": pid, "tid": 0,
                }
                if sargs:
                    ev["args"] = sargs
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_trace_json(self, process_name: str = "goworld_tpu") -> str:
        return json.dumps(self.chrome_trace(process_name))


# =======================================================================
# process-wide instances + scrape-side parsing
# =======================================================================
REGISTRY = Registry()
timeline = TickTimeline()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help=help, **labels)


def histogram(name: str, buckets=DEFAULT_MS_BUCKETS, help: str = "",
              **labels) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, help=help, **labels)


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Parse Prometheus text exposition into ``{series: value}`` where
    ``series`` is the name with its label suffix verbatim. Shared by
    ``tools/scrape_metrics.py``, ``cli.py status`` and the tests."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, val = line.rpartition(" ")
        try:
            out[series] = float(val)
        except ValueError:
            continue
    return out
