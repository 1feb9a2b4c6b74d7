"""Distributed-tracing context and span recorder, the part of
``goworld_tpu/utils/tracing.py`` that the World uses.

A :class:`TraceContext` (16-byte trace id, 8-byte span id, flags) names
one position in a trace. A hop installs its own child context as the
thread's current one (:class:`use`, :class:`hop`) and records a span for
its duration into the process-wide :data:`recorder`. ``World._invoke``
gives a traced RPC its own span this way. The wire trailer, sampling and
the Chrome-trace export belong to the net stack, which is not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any

__all__ = ["TraceContext", "SpanRecorder", "recorder", "FLAG_SAMPLED",
           "new_trace", "current", "use", "hop"]

FLAG_SAMPLED = 0x01

# fast-path gate: False until the first use(); callers check this one
# module bool before touching the thread-local
active = False

_tls = threading.local()


def _new_id(n: int) -> bytes:
    return os.urandom(n)


class TraceContext:
    """One position in a trace: (trace_id, span_id, flags)."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: bytes, span_id: bytes,
                 flags: int = FLAG_SAMPLED):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

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

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_hex[:8]}../{self.span_hex})"


def new_trace(flags: int = FLAG_SAMPLED) -> TraceContext:
    """Root a brand-new trace."""
    return TraceContext(_new_id(16), _new_id(8), flags)


def current() -> TraceContext | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class use:
    """``with use(ctx): ...`` — install ``ctx`` as the thread's current
    context."""

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
    """Ring buffer of completed spans; any thread records here."""

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
        return _Span(self, name, track, ctx, parent, args or None)

    def records(self) -> list:
        """(name, track, trace_hex, span_hex, parent_hex, wall_us,
        dur_us, args) tuples, oldest first."""
        with self._lock:
            return list(self._recs)


recorder = SpanRecorder()


class hop:
    """One traced hop: derive a child context from the inbound one,
    record a span for the handler's duration, and install the child as
    current.

    ``with hop("invoke", "game1", inbound, method="Foo") as my: ...``
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
