"""Overload-protection plane: admission control, prioritized
backpressure and load shedding.

The fault plane (:mod:`goworld_tpu_torch.utils.faults`) can *create* overload
— delay/dup storms, kill-restart thundering herds — but nothing in the
stack survived it gracefully: the game's backlog alarm literally
advised "shed load" with no mechanism behind it, the gate admitted
unlimited clients at unlimited rates, and a stalled downstream grew
queues without bound. This module makes degradation a **designed
ladder** instead of an OOM:

* :class:`OverloadGovernor` — a per-process state machine
  ``NORMAL → DEGRADED → SHEDDING → REJECTING`` driven by measured
  signals (tick latency vs ``tick_interval``, backlog ticks, queue
  depth fractions, reconnect-pend fractions) with hysteresis so it
  never flaps. The decision is a **pure function of the observation
  sequence**: two runs fed identical signal streams produce
  byte-identical transition logs (the seeded-replay property the fault
  plane already has).
* **Traffic classes** — every wire msgtype maps to one of five
  priority classes; shedding drops the cheapest class first and
  *never* touches correctness-critical classes (migration /
  persistence / control / RPC).
* :class:`ClassQueues` — bounded priority queues for the game ingress:
  the pump drains highest-priority first, overflow evicts only within
  the overflowing class, every drop counted.
* :class:`TokenBucket` — per-client packet/byte rate limiting at the
  gate edge (deterministic under an injected clock).
* :class:`CircuitBreaker` — wraps the kvdb/storage retry paths: after
  a failure budget the breaker opens and callers fail fast (degrading
  persistence) instead of stalling ticks on a dead backend; half-open
  probes close it again.

Observability: current state in the ``overload_state`` gauge,
transitions in ``overload_transitions_total{from,to}`` and as
zero-duration instants in the tracing span ring, per-class drops in
``shed_total{class,stage}``, all served at debug-http ``/overload``
(see docs/ROBUSTNESS.md "Overload & degradation").
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from goworld_tpu_torch.utils import consts, log, metrics

logger = log.get("overload")

__all__ = [
    "NORMAL", "DEGRADED", "SHEDDING", "REJECTING", "STATE_NAMES",
    "state_rank",
    "CLASS_CRITICAL", "CLASS_RPC", "CLASS_SYNC", "CLASS_EVENTS",
    "CLASS_NOISE", "CLASS_NAMES", "classify", "shed_counter",
    "OverloadGovernor", "ClassQueues", "TokenBucket", "CircuitBreaker",
    "register", "unregister", "snapshot",
]

# =======================================================================
# states
# =======================================================================
NORMAL = 0
DEGRADED = 1
SHEDDING = 2
REJECTING = 3
STATE_NAMES = ("NORMAL", "DEGRADED", "SHEDDING", "REJECTING")


def state_rank(name: str) -> int:
    """Severity rank of a governor state NAME (the scraped ``/overload``
    payload ships names, not ints). Unknown names rank as NORMAL — a
    scrape gap or version skew must never synthesize load, only miss
    it (the rebalance policy's donor test is ``rank >= DEGRADED``)."""
    try:
        return STATE_NAMES.index(str(name))
    except ValueError:
        return NORMAL

# =======================================================================
# traffic classes (priority order; LOWER number = more important)
# =======================================================================
CLASS_CRITICAL = 0   # migration / persistence / control / lifecycle
CLASS_RPC = 1        # entity RPC (server- and client-originated)
CLASS_SYNC = 2       # attr / position sync fan-out (server -> client)
CLASS_EVENTS = 3     # client-origin event streams (position spam; the
                     # client re-sends continuously, dropping self-heals)
CLASS_NOISE = 4      # heartbeats
CLASS_NAMES = ("critical", "rpc", "sync", "events", "noise")
N_CLASSES = len(CLASS_NAMES)

# the cheapest class a state sheds at ingress: packets with
# class >= floor are dropped (N_CLASSES = shed nothing). DEGRADED sheds
# nothing at ingress — it degrades by striding/coalescing fan-out.
_SHED_FLOOR = {
    NORMAL: N_CLASSES,
    DEGRADED: N_CLASSES,
    SHEDDING: CLASS_EVENTS,
    REJECTING: CLASS_SYNC,
}


def _build_class_map() -> dict[int, int]:
    from goworld_tpu_torch.net import proto

    m: dict[int, int] = {}
    for mt in (
        # handshake / readiness / lifecycle / freeze / registry: the
        # control plane — dropping any of these wedges the cluster
        proto.MT_SET_GAME_ID, proto.MT_SET_GATE_ID,
        proto.MT_SET_GAME_ID_ACK,
        proto.MT_NOTIFY_CREATE_ENTITY, proto.MT_NOTIFY_DESTROY_ENTITY,
        proto.MT_DECLARE_SERVICE, proto.MT_UNDECLARE_SERVICE,
        proto.MT_CREATE_ENTITY_ANYWHERE, proto.MT_LOAD_ENTITY_ANYWHERE,
        proto.MT_NOTIFY_CLIENT_CONNECTED,
        proto.MT_NOTIFY_ALL_GAMES_CONNECTED,
        proto.MT_START_FREEZE_GAME, proto.MT_START_FREEZE_GAME_ACK,
        proto.MT_NOTIFY_GAME_CONNECTED, proto.MT_NOTIFY_GAME_DISCONNECTED,
        proto.MT_NOTIFY_DEPLOYMENT_READY, proto.MT_GAME_LBC_INFO,
        proto.MT_KVREG_REGISTER,
        proto.MT_GAME_READY,
    ):
        m[mt] = CLASS_CRITICAL
    for mt in (
        proto.MT_CALL_ENTITY_METHOD,
        proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT,
        # ENTITY-ADDRESSED, ORDER-SENSITIVE control shares the RPC
        # class ON PURPOSE: a higher class would let these OVERTAKE
        # the same entity's queued calls in the priority pump.
        # Migration acks jumping queued pings snapshot the migrate
        # data BEFORE those pings apply — in-flight RPCs silently
        # lost (tests/test_cross_game_migration.py caught it live);
        # a disconnect jumping the client's own queued calls fails
        # their own-client authorization (a deposit!). FIFO-with-RPCs
        # keeps the per-entity order the single-queue pump had; only
        # PROCESS-level control (handshakes, readiness, freeze,
        # kvreg) outranks RPCs.
        proto.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE,
        proto.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK,
        proto.MT_MIGRATE_REQUEST, proto.MT_MIGRATE_REQUEST_ACK,
        proto.MT_REAL_MIGRATE, proto.MT_CANCEL_MIGRATE,
        proto.MT_NOTIFY_CLIENT_DISCONNECTED,
        proto.MT_NOTIFY_GATE_DISCONNECTED,
        proto.MT_CALL_NIL_SPACES,
        proto.MT_CALL_FILTERED_CLIENTS,
        proto.MT_SET_CLIENT_FILTER_PROP,
        # the per-tick client event bundle carries create/destroy/attr
        # records — dropping one desyncs the client's world PERMANENTLY
        # (unlike position sync, nothing re-sends it)
        proto.MT_CLIENT_EVENTS_BATCH,
        proto.MT_CREATE_ENTITY_ON_CLIENT,
        proto.MT_DESTROY_ENTITY_ON_CLIENT,
        proto.MT_CALL_ENTITY_METHOD_ON_CLIENT,
    ):
        m[mt] = CLASS_RPC
    for mt in (
        proto.MT_SYNC_POSITION_YAW_ON_CLIENTS,
        proto.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT,
        proto.MT_NOTIFY_ATTR_DEL_ON_CLIENT,
        proto.MT_UPDATE_POSITION_ON_CLIENT,
        proto.MT_UPDATE_YAW_ON_CLIENT,
    ):
        m[mt] = CLASS_SYNC
    for mt in (
        # client-origin position streams: the client re-sends at 10 Hz,
        # so a dropped batch self-heals within one sync interval
        proto.MT_SYNC_POSITION_YAW_FROM_CLIENT,
        proto.MT_CLIENT_SYNC_POSITION_YAW,
    ):
        m[mt] = CLASS_EVENTS
    m[proto.MT_HEARTBEAT] = CLASS_NOISE
    return m


_class_map: dict[int, int] | None = None


def classify(msgtype: int) -> int:
    """Traffic class for a wire msgtype. Unknown types classify as
    ``CLASS_RPC`` — never shed — so a future msgtype fails safe."""
    global _class_map
    m = _class_map
    if m is None:
        m = _class_map = _build_class_map()
    return m.get(msgtype, CLASS_RPC)


# shed counters, cached per (class, stage): the hot drop paths pay one
# dict hit + one locked increment (the dispatcher route-counter idiom)
_shed_counters: dict[tuple[int, str], metrics.Counter] = {}


def shed_counter(cls: int, stage: str) -> metrics.Counter:
    c = _shed_counters.get((cls, stage))
    if c is None:
        c = _shed_counters[(cls, stage)] = metrics.counter(
            "shed_total",
            help="packets shed by traffic class and pipeline stage",
            **{"class": CLASS_NAMES[cls], "stage": stage},
        )
    return c


def shed_snapshot() -> dict[str, float]:
    """Current ``shed_total`` readings keyed ``<class>/<stage>``."""
    return {
        f"{CLASS_NAMES[cls]}/{stage}": c.value
        for (cls, stage), c in sorted(_shed_counters.items())
    }


# =======================================================================
# governor
# =======================================================================
class OverloadGovernor:
    """The per-process overload state machine.

    ``observe()`` is called once per evaluation interval (the game's
    tick, the gate's flush loop) with *measured* signals. One
    observation scores 0 (calm), 1 (pressured) or ``severe_boost``
    (severely pressured) points; ``up_ticks`` consecutive pressured
    observations escalate one rung, ``down_ticks`` consecutive calm
    observations de-escalate one rung. A mixed observation (neither
    calm nor pressured — the hysteresis band) resets *both* runs, so
    the ladder holds its rung instead of flapping.

    Everything is a pure function of the observation sequence — no
    wall clock, no RNG — so equal signal streams replay identical
    transition logs (asserted by tests/test_overload.py).
    """

    def __init__(
        self,
        name: str,
        *,
        up_ticks: int = consts.OVERLOAD_UP_TICKS,
        down_ticks: int = consts.OVERLOAD_DOWN_TICKS,
        latency_ratio: float = consts.OVERLOAD_LATENCY_RATIO,
        backlog_enter: float = consts.OVERLOAD_BACKLOG_ENTER,
        queue_frac_enter: float = 0.5,
        severe_boost: int = 4,
        on_transition: Callable[[int, int, str], None] | None = None,
    ):
        self.name = name
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.latency_ratio = float(latency_ratio)
        self.backlog_enter = float(backlog_enter)
        self.queue_frac_enter = float(queue_frac_enter)
        self.severe_boost = max(1, int(severe_boost))
        self.on_transition = on_transition
        self.state = NORMAL
        self.obs_count = 0
        self._up_score = 0
        self._down_run = 0
        # (obs index, from, to, reason) — deterministic transition log
        self.transitions: list[tuple[int, int, int, str]] = []
        self._m_state = metrics.gauge(
            "overload_state",
            help="overload ladder rung: 0=NORMAL 1=DEGRADED "
                 "2=SHEDDING 3=REJECTING",
            process=name,
        )
        self._m_trans: dict[tuple[int, int], metrics.Counter] = {}
        self._m_state.set(NORMAL)

    # -- classification of one observation ------------------------------
    def _pressure(self, latency_ratio: float, backlog_ticks: float,
                  queue_frac: float, pend_frac: float) -> int:
        """0 = calm, 1 = pressured, severe_boost = severely pressured."""
        severe = (
            latency_ratio >= 2.0 * self.latency_ratio
            or backlog_ticks >= 4.0 * self.backlog_enter
            or queue_frac >= 0.9
            or pend_frac >= 0.9
        )
        if severe:
            return self.severe_boost
        pressured = (
            latency_ratio >= self.latency_ratio
            or backlog_ticks >= self.backlog_enter
            or queue_frac >= self.queue_frac_enter
            or pend_frac >= self.queue_frac_enter
        )
        if pressured:
            return 1
        # calm needs headroom BELOW the enter thresholds (hysteresis
        # band): between calm and pressured the ladder holds its rung
        calm = (
            latency_ratio < 0.6 * self.latency_ratio
            and backlog_ticks < 0.5 * self.backlog_enter
            and queue_frac < 0.5 * self.queue_frac_enter
            and pend_frac < 0.5 * self.queue_frac_enter
        )
        return 0 if calm else -1  # -1 = hysteresis band

    def observe(self, latency_ratio: float, backlog_ticks: float = 0.0,
                queue_frac: float = 0.0, pend_frac: float = 0.0) -> int:
        """Feed one evaluation's signals; returns the (possibly new)
        state."""
        n = self.obs_count
        self.obs_count = n + 1
        p = self._pressure(latency_ratio, backlog_ticks, queue_frac,
                           pend_frac)
        if p > 0:
            self._up_score += p
            self._down_run = 0
            if self._up_score >= self.up_ticks and self.state < REJECTING:
                self._transition(
                    n, self.state + 1,
                    f"pressure {self._up_score}/{self.up_ticks} "
                    f"(lat={latency_ratio:.2f}x backlog={backlog_ticks:.1f}"
                    f" q={queue_frac:.2f} pend={pend_frac:.2f})",
                )
                self._up_score = 0
        elif p == 0:
            self._down_run += 1
            self._up_score = 0
            if self._down_run >= self.down_ticks and self.state > NORMAL:
                self._transition(
                    n, self.state - 1,
                    f"calm {self._down_run}/{self.down_ticks}",
                )
                self._down_run = 0
        else:  # hysteresis band: hold the rung, reset both runs
            self._up_score = 0
            self._down_run = 0
        return self.state

    def _transition(self, obs: int, to: int, reason: str) -> None:
        frm = self.state
        self.state = to
        self.transitions.append((obs, frm, to, reason))
        self._m_state.set(to)
        c = self._m_trans.get((frm, to))
        if c is None:
            c = self._m_trans[(frm, to)] = metrics.counter(
                "overload_transitions_total",
                help="overload ladder transitions",
                process=self.name,
                **{"from": STATE_NAMES[frm], "to": STATE_NAMES[to]},
            )
        c.inc()
        logger.warning(
            "%s: overload %s -> %s at obs %d (%s)",
            self.name, STATE_NAMES[frm], STATE_NAMES[to], obs, reason,
        )
        # stamp the span ring so /trace shows the transition instant
        # alongside the tick spans and fault instants
        from goworld_tpu_torch.utils import tracing

        tracing.recorder.record(
            f"overload:{STATE_NAMES[frm]}->{STATE_NAMES[to]}",
            f"overload:{self.name}", tracing.new_trace(), None,
            time.time() * 1e6, 0.0, {"obs": obs, "reason": reason},
        )
        if self.on_transition is not None:
            self.on_transition(frm, to, reason)

    # -- queries ---------------------------------------------------------
    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    def shed_floor(self) -> int:
        """Cheapest class shed at ingress in the current state
        (``N_CLASSES`` = shed nothing)."""
        return _SHED_FLOOR[self.state]

    def should_shed(self, cls: int) -> bool:
        return cls >= _SHED_FLOOR[self.state]

    def log_lines(self) -> list[str]:
        """Deterministic transition log: one line per transition. Equal
        observation streams produce byte-identical logs."""
        return [
            f"#{obs} {STATE_NAMES[frm]}->{STATE_NAMES[to]} {reason}"
            for obs, frm, to, reason in self.transitions
        ]

    def snapshot(self) -> dict[str, Any]:
        return {
            "state": self.state_name,
            "observations": self.obs_count,
            "up_score": self._up_score,
            "down_run": self._down_run,
            "transitions": self.log_lines(),
        }


# =======================================================================
# bounded priority queues (game ingress)
# =======================================================================
class ClassQueues:
    """Per-class bounded FIFO queues drained in priority order.

    The network thread appends, the logic thread drains —
    ``deque.append`` / ``popleft`` are GIL-atomic, so no lock is needed
    on the hot path (the idiom the old single ``queue.Queue`` relied on
    too). Overflow drops the *incoming* packet of the overflowing class
    (bounds are per class, so a sync flood can never evict an RPC) and
    counts it in ``shed_total{class,stage}``.
    """

    def __init__(self, bounds: dict[int, int] | None = None,
                 stage: str = "game_queue"):
        b = {
            CLASS_CRITICAL: consts.MAX_PENDING_PACKETS_PER_GAME,
            CLASS_RPC: consts.MAX_PENDING_PACKETS_PER_GAME,
            CLASS_SYNC: consts.OVERLOAD_QUEUE_CAP_SYNC,
            CLASS_EVENTS: consts.OVERLOAD_QUEUE_CAP_EVENTS,
            CLASS_NOISE: consts.OVERLOAD_QUEUE_CAP_NOISE,
        }
        if bounds:
            b.update(bounds)
        self.bounds = b
        self.stage = stage
        self._qs: tuple[deque, ...] = tuple(
            deque() for _ in range(N_CLASSES)
        )

    def offer(self, cls: int, item: Any) -> bool:
        """Enqueue; False (and a counted drop) when the class is full."""
        q = self._qs[cls]
        if len(q) >= self.bounds[cls]:
            shed_counter(cls, self.stage).inc()
            return False
        q.append(item)
        return True

    def drain(self) -> "list[Any]":
        """Pop everything, highest priority class first (within a
        class, FIFO)."""
        out: list[Any] = []
        for q in self._qs:
            while True:
                try:
                    out.append(q.popleft())
                except IndexError:
                    break
        return out

    def pop(self) -> Any:
        """Pop one item from the highest-priority non-empty class;
        raises IndexError when empty."""
        for q in self._qs:
            try:
                return q.popleft()
            except IndexError:
                continue
        raise IndexError("all class queues empty")

    def qsize(self) -> int:
        return sum(len(q) for q in self._qs)

    def depth_frac(self) -> float:
        """Worst per-class fullness fraction across the BOUNDED classes
        (the unbounded-ish critical/rpc classes are excluded — their
        bound exists only as an OOM backstop)."""
        worst = 0.0
        for cls in (CLASS_SYNC, CLASS_EVENTS, CLASS_NOISE):
            bound = self.bounds[cls]
            if bound > 0:
                worst = max(worst, len(self._qs[cls]) / bound)
        return worst


# =======================================================================
# token bucket (gate admission)
# =======================================================================
class TokenBucket:
    """Classic token bucket; ``rate`` tokens/s refill up to ``burst``.
    ``clock`` is injectable for deterministic tests. ``rate <= 0``
    disables (always allows)."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(1.0, rate))
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()

    def allow(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._t) * self.rate
        )
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


# =======================================================================
# circuit breaker (kvdb / storage)
# =======================================================================
class CircuitBreaker:
    """Failure-budget breaker: ``failure_threshold`` consecutive
    failures open it; while open, ``allow()`` fails fast until
    ``reset_timeout`` elapses, then ONE half-open probe is let through
    — its success closes the breaker, its failure re-opens (and
    re-arms the timeout). Thread-safe (the kvdb worker and storage
    thread race the logic thread's snapshot reads)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str, *, failure_threshold: int = 5,
                 reset_timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0
        self._m_state = metrics.gauge(
            "circuit_state",
            help="circuit breaker: 0=closed 1=open 0.5=half-open",
            breaker=name,
        )
        self._m_opened = metrics.counter(
            "circuit_open_total",
            help="times the breaker opened", breaker=name,
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May an operation proceed right now? While open, exactly one
        caller per reset window gets the half-open probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at >= self.reset_timeout:
                    self._state = self.HALF_OPEN
                    self._probing = True
                    self._probe_started = now
                    self._m_state.set(0.5)
                    return True
                return False
            # HALF_OPEN: one probe in flight holds everyone else — but
            # a probe that never reported back (caller crashed without
            # record_*) frees the slot after another reset window, so
            # an unsettled probe can never pin the breaker forever
            if not self._probing \
                    or now - self._probe_started >= self.reset_timeout:
                self._probing = True
                self._probe_started = now
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                logger.info("circuit %s closed (probe succeeded)",
                            self.name)
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False
            self._m_state.set(0.0)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == self.HALF_OPEN \
                    or (self._state == self.CLOSED
                        and self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._m_state.set(1.0)
                self._m_opened.inc()
                logger.error(
                    "circuit %s OPEN after %d failures (fail-fast for "
                    "%.1fs)", self.name, self._failures,
                    self.reset_timeout,
                )

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "failures": self._failures,
            }


class CircuitOpenError(ConnectionError):
    """Raised (or passed to callbacks) when an op is rejected fast
    because its backend's circuit breaker is open. Subclasses
    ConnectionError so existing error paths treat it like any backend
    failure — minus the stall."""


# =======================================================================
# process-wide registry (debug-http /overload)
# =======================================================================
_governors: dict[str, OverloadGovernor] = {}
_breakers: dict[str, CircuitBreaker] = {}


def register(gov: OverloadGovernor) -> OverloadGovernor:
    _governors[gov.name] = gov
    return gov


def unregister(name: str) -> None:
    _governors.pop(name, None)


def register_breaker(br: CircuitBreaker) -> CircuitBreaker:
    _breakers[br.name] = br
    return br


def snapshot() -> dict[str, Any]:
    """debug-http ``/overload`` payload."""
    return {
        "governors": {n: g.snapshot() for n, g in _governors.items()},
        "breakers": {n: b.snapshot() for n, b in _breakers.items()},
        "shed": shed_snapshot(),
        "classes": dict(zip(CLASS_NAMES, range(N_CLASSES))),
    }
