"""Cross-process distributed tracing: context propagation + span recorder.

The port's copy of ``goworld_tpu/utils/tracing.py``, with a recorder
and a sample rate of its own.

The reference engine has no tracing layer; its opmon/pprof surface stops
at process boundaries. This module is the Dapper/OpenTelemetry-shaped
missing piece for a location-transparent RPC fabric: a client call hops
gate -> dispatcher -> game (and a second game during migration) before
anything runs, and per-process telemetry (:mod:`metrics`) cannot say
*which hop* a packet spent its 16 ms budget in.

Three parts, all stdlib:

* :class:`TraceContext` — 16B trace_id + 8B span_id + 1B flags, packed
  as a 25-byte wire trailer by :mod:`goworld_tpu_torch.net.packet` (keyed off
  ``TRACE_FLAG``, bit 15 of the msgtype field — untraced packets pay
  zero bytes, see the wire-compat test).
* sampling + thread-local *current context*: the gate roots a context
  on sampled client packets (:func:`maybe_sample`); every hop installs
  its own child as current (:func:`use` / :func:`hop`), and
  ``packet.new_packet`` auto-stamps outbound packets with it, so
  multi-hop chains (entity RPC fan-out, migration acks) stay linked
  without per-call-site plumbing.
* :class:`SpanRecorder` — a ring buffer of completed spans with
  parent/child linkage, exported next to the :class:`TickTimeline`
  ring in ``debug_http /trace`` as Chrome/Perfetto ``X`` events (one
  named track per service), merged cluster-wide by
  ``tools/merge_traces.py`` which synthesizes the flow arrows.

Overhead discipline: with sampling off, the wire is byte-identical and
the per-packet cost is one ``is None`` check (plus one module-bool load
in ``new_packet``); spans cost two ``perf_counter`` calls + one deque
append, same budget as the tick timeline.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from random import random as _rand
from typing import Any

__all__ = [
    "TraceContext", "SpanRecorder", "recorder",
    "CTX_WIRE_SIZE", "FLAG_SAMPLED",
    "new_trace", "maybe_sample", "set_sample_rate", "sample_rate",
    "current", "use", "hop", "root",
]

CTX_WIRE_SIZE = 25      # 16B trace_id + 8B span_id + 1B flags
FLAG_SAMPLED = 0x01

# fast-path gate: False until the first set_sample_rate(>0) or use();
# packet.new_packet checks this single module bool before touching the
# thread-local, so fully-untraced processes pay one global load
active = False

_rate = 0.0
_tls = threading.local()


def _new_id(n: int) -> bytes:
    return os.urandom(n)


class TraceContext:
    """One position in a trace: (trace_id, span_id, flags). A packet
    carries the context of the span that *emitted* it; the receiving
    hop records its own span with ``parent = carried span_id``."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: bytes, span_id: bytes, flags: int = FLAG_SAMPLED):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    # -- wire form (the 25B packet trailer) -----------------------------
    def pack(self) -> bytes:
        return self.trace_id + self.span_id + bytes((self.flags & 0xFF,))

    @classmethod
    def unpack(cls, b: bytes) -> "TraceContext":
        if len(b) != CTX_WIRE_SIZE:
            raise ValueError(f"bad trace context length {len(b)}")
        return cls(bytes(b[:16]), bytes(b[16:24]), b[24])

    # -- lineage --------------------------------------------------------
    def child(self) -> "TraceContext":
        """Same trace, fresh span id (the receiving hop's own span)."""
        return TraceContext(self.trace_id, _new_id(8), self.flags)

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    @property
    def trace_hex(self) -> str:
        return self.trace_id.hex()

    @property
    def span_hex(self) -> str:
        return self.span_id.hex()

    def __repr__(self) -> str:  # log-friendly
        return f"TraceContext({self.trace_hex[:8]}../{self.span_hex})"


def new_trace(flags: int = FLAG_SAMPLED) -> TraceContext:
    """Root a brand-new trace (the gate-ingress stamp)."""
    return TraceContext(_new_id(16), _new_id(8), flags)


def set_sample_rate(rate: float) -> None:
    """Probability that :func:`maybe_sample` roots a trace (0 = off).
    Set per process: via ``trace_sample_rate`` in the cluster ini, the
    debug-http ``/tracing?rate=`` endpoint, or ``goworld_tpu trace``."""
    global _rate, active
    _rate = min(1.0, max(0.0, float(rate)))
    # disarming also drops the fast-path flag, restoring the documented
    # one-global-load overhead; an inbound traced packet re-raises it
    # (use.__enter__), so cross-process propagation keeps working
    active = _rate > 0.0


def sample_rate() -> float:
    return _rate


def maybe_sample() -> TraceContext | None:
    """Roll the sampling dice; a new root context or None."""
    if _rate <= 0.0:
        return None
    if _rate < 1.0 and _rand() >= _rate:
        return None
    return new_trace()


# =======================================================================
# thread-local current context (one logic/IO thread per process kind)
# =======================================================================
def current() -> TraceContext | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class use:
    """``with use(ctx): ...`` — install ``ctx`` as the thread's current
    context; ``new_packet`` stamps outbound packets with it."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: TraceContext):
        self._ctx = ctx

    def __enter__(self) -> TraceContext:
        global active
        active = True
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        _tls.stack.pop()


# =======================================================================
# span recorder
# =======================================================================
class _Span:
    """Timing scope for one span; records on exit."""

    __slots__ = ("_rec", "_name", "_track", "_ctx", "_parent", "_args",
                 "_wall_us", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, track: str,
                 ctx: TraceContext, parent: str | None, args):
        self._rec = rec
        self._name = name
        self._track = track
        self._ctx = ctx
        self._parent = parent
        self._args = args

    def __enter__(self) -> "_Span":
        self._wall_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.record(
            self._name, self._track, self._ctx, self._parent,
            self._wall_us, (time.perf_counter() - self._t0) * 1e6,
            self._args,
        )


class SpanRecorder:
    """Ring buffer of completed spans. Unlike :class:`TickTimeline`
    (one open tick, logic thread only) any thread records here — gate
    and dispatcher services have no tick loop. Exported beside the
    timeline in the same ``/trace`` JSON."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._recs: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, name: str, track: str, ctx: TraceContext,
               parent: str | None, wall_us: float, dur_us: float,
               args: dict | None = None) -> None:
        with self._lock:
            self._recs.append(
                (name, track, ctx.trace_hex, ctx.span_hex, parent,
                 wall_us, dur_us, args or None)
            )

    def span(self, name: str, track: str, ctx: TraceContext,
             parent: str | None, **args: Any) -> _Span:
        """``with recorder.span("route", "dispatcher1", ctx, parent):``"""
        return _Span(self, name, track, ctx, parent, args or None)

    def records(self) -> list:
        """(name, track, trace_hex, span_hex, parent_hex, wall_us,
        dur_us, args) tuples, oldest first."""
        with self._lock:
            return list(self._recs)

    def tail(self, n: int) -> list:
        """The newest ``n`` records (oldest first) WITHOUT copying the
        whole ring — the flight recorder correlates incident bundles
        with the last sampled trace ids at freeze time."""
        with self._lock:
            k = min(n, len(self._recs))
            return [self._recs[len(self._recs) - k + i]
                    for i in range(k)]

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)

    def chrome_events(self, pid: int, base_tid: int = 8) -> list[dict]:
        """Chrome-trace ``X`` events, one named thread track per
        service track (tids from ``base_tid`` up, clear of the tick
        timeline's ``logic`` tid 0). Span linkage rides in ``args``
        (``trace_id``/``span_id``/``parent_id``) for
        ``tools/merge_traces.py`` to turn into flow arrows."""
        events: list[dict] = []
        tids: dict[str, int] = {}
        for name, track, trace_hex, span_hex, parent, wall_us, dur_us, \
                args in self.records():
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = base_tid + len(tids)
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": track},
                })
            ev_args = {"trace_id": trace_hex, "span_id": span_hex}
            if parent:
                ev_args["parent_id"] = parent
            if args:
                ev_args.update(args)
            events.append({
                "name": name, "ph": "X", "ts": wall_us, "dur": dur_us,
                "pid": pid, "tid": tid, "args": ev_args,
            })
        return events


recorder = SpanRecorder()


class root:
    """The ROOT twin of :class:`hop`: record a parentless span for a
    freshly-rooted context (gate ingress, game-initiated migration) and
    install it as current so outbound packets are auto-stamped.

    ``with root("gate_ingress", "gate1", maybe_sample(), msgtype=13):``
    """

    __slots__ = ("_span", "_use", "ctx")

    def __init__(self, name: str, track: str, ctx: TraceContext,
                 **args: Any):
        self.ctx = ctx
        self._span = recorder.span(name, track, ctx, None, **args)
        self._use = use(ctx)

    def __enter__(self) -> TraceContext:
        self._span.__enter__()
        self._use.__enter__()
        return self.ctx

    def __exit__(self, *exc) -> None:
        self._use.__exit__(*exc)
        self._span.__exit__(*exc)


class hop:
    """One traced hop: derive a child context from the inbound one,
    record a span for the handler's duration, and install the child as
    current so every outbound packet created inside is auto-stamped.

    ``with hop("route", "dispatcher1", inbound, msgtype=8) as my:
        pkt.trace = my        # the forwarded packet carries MY span
        ...handle...``
    """

    __slots__ = ("_span", "_use", "ctx")

    def __init__(self, name: str, track: str, inbound: TraceContext,
                 **args: Any):
        self.ctx = inbound.child()
        self._span = recorder.span(name, track, self.ctx,
                                   inbound.span_hex, **args)
        self._use = use(self.ctx)

    def __enter__(self) -> TraceContext:
        self._span.__enter__()
        self._use.__enter__()
        return self.ctx

    def __exit__(self, *exc) -> None:
        self._use.__exit__(*exc)
        self._span.__exit__(*exc)
