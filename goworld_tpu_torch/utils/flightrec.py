"""Incident flight recorder: bounded per-tick frame ring + triggered
snapshot bundles for post-mortems.

The observability planes so far answer "what is the process doing NOW"
(/metrics, /costs, /workload) and "what did this request do" (/trace)
— but when a live p99 blows past the tick budget at 3am, the question
is "what was happening in the ticks AROUND the breach". This module
keeps a bounded ring of per-tick correlated frames (tick latency vs
budget, overload-ladder stage, AOI oracle gauges, workload-signature
marks, resolved kernel config) and, on a trigger, freezes the ring
tail into an incident bundle served at debug-http ``/incidents`` and
scraped by ``cli.py status`` / ``tools/scrape_metrics.py``.

Triggers (the grammar — docs/OBSERVABILITY.md):

* ``slo_breach`` — the frame's measured ``tick_ms`` exceeded its
  ``budget_ms`` (the process's own tick budget, 1000/tick_hz);
* ``overload_transition`` — the governor ladder changed stage
  (detail carries ``<from>><to>``);
* ``over_cap_after_quiet`` — the AOI ``over_cap`` oracle gauge fired
  after at least ``quiet_ticks`` silent frames (a density anomaly,
  not steady-state saturation — steady overflow alarms elsewhere);
* ``signature_change`` — the live workload signature's class string
  changed (the autotuning governor's input; recorded so a post-mortem
  can correlate a breach with a workload shift);
* ``governor_swap`` — the autotune governor committed a kernel-config
  swap or regret revert this tick (``goworld_tpu/autotune``); the
  frame carries ``from->to (reason)`` and the incident context freezes
  the full decision state (policy log, regret numbers, signature);
* ``sync_age_breach`` — the end-to-end sync-age p99 of a window
  exceeded its delivery target (``sync_age_p99_ms`` >
  ``sync_age_target_ms``; gate frames, utils/syncage.py) — a client
  saw stale positions even if every device tick made its budget; the
  frame carries the per-hop breakdown (``sync_age_hops``) so the
  bundle says WHICH hop ate the budget;
* ``residency_regression`` — the serve loop's windowed host-bubble p99
  exceeded its budget (``residency_bubble_p99_ms`` >
  ``residency_bubble_budget_ms``; game frames, utils/residency.py) —
  frame time the device sat idle with no host work to show for it,
  the regression ROADMAP item 5's resident-world runtime exists to
  prevent;
* ``audit_violation`` — the correctness audit plane recorded a
  violation (``audit_violation`` frame key; game frames,
  utils/audit.py): a lost/duplicated EntityID, a sampled interest set
  diverging from the brute-force oracle, a slot/client mirror or
  ``interested_by`` edge out of sync, or a SnapshotChain CRC failure —
  the detail names the EntityID and the incident context freezes the
  ledger event tail + cohort diff;
* ``standby_promoted`` — a hot standby won its kvreg-arbitrated
  promotion claim and took over a dead primary
  (``goworld_tpu/replication/``; the ``standby_promoted`` frame key
  names game/epoch/frame-seq/tick): the bundle freezes the
  promotion-side context, pairing with the primary's bundle frozen at
  its crash;
* ``rebalance_action`` — the self-healing rebalance plane took a
  topology action this tick (``goworld_tpu/rebalance/``; the
  ``rebalance`` frame key): a bounded entity-cohort handoff started,
  completed, or aborted — the detail names the target game, cohort
  size and (on abort) the cause, so a post-mortem can line the move
  up against the overload stages that triggered it.

Every trigger kind is deduped with a per-kind cooldown so one bad
minute yields a handful of bundles, not thousands. Determinism: the
recorder is a pure function of the (frame, clock) stream — equal
streams yield byte-identical incident lists (the clock is injectable;
tests replay it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from goworld_tpu_torch.utils import log, metrics

logger = log.get("flightrec")

__all__ = [
    "FlightRecorder", "register", "unregister", "get", "snapshot_all",
    "set_workload_provider", "workload_snapshot", "reset",
    "DEFAULT_RING", "DEFAULT_COOLDOWN_SECS",
]

DEFAULT_RING = 512
DEFAULT_COOLDOWN_SECS = 30.0
DEFAULT_SNAPSHOT_FRAMES = 64
DEFAULT_QUIET_TICKS = 16
DEFAULT_MAX_INCIDENTS = 32


class FlightRecorder:
    """Bounded ring of per-tick frames + trigger/dedup/snapshot logic.

    ``record(frame)`` is called once per tick from the logic thread
    with a plain dict; any other thread may ``snapshot()`` (the
    ``/incidents`` handler). ``context_fn`` (optional) is called ONLY
    at incident-freeze time and its dict is attached to the bundle —
    the hook for expensive correlation data (last trace ids, the full
    resolved kernel config) that must not be paid per tick."""

    def __init__(self, ring: int = DEFAULT_RING,
                 cooldown_secs: float = DEFAULT_COOLDOWN_SECS,
                 snapshot_frames: int = DEFAULT_SNAPSHOT_FRAMES,
                 quiet_ticks: int = DEFAULT_QUIET_TICKS,
                 max_incidents: int = DEFAULT_MAX_INCIDENTS,
                 clock: Callable[[], float] = time.monotonic,
                 context_fn: Callable[[], dict] | None = None):
        if ring < 1:
            raise ValueError(f"ring must be >= 1 (got {ring})")
        self.ring = int(ring)
        self.cooldown_secs = float(cooldown_secs)
        self.snapshot_frames = min(int(snapshot_frames), self.ring)
        self.quiet_ticks = int(quiet_ticks)
        self.clock = clock
        self.context_fn = context_fn
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=self.ring)
        self._incidents: deque = deque(maxlen=int(max_incidents))
        self._last_fire: dict[str, float] = {}   # kind -> clock()
        self._fired: dict[str, int] = {}         # kind -> total fires
        self._suppressed: dict[str, int] = {}    # kind -> cooldown hits
        self._frames_total = 0
        self._prev_stage: str | None = None
        self._prev_sig: str | None = None
        self._quiet_run = 0  # consecutive frames with over_cap == 0
        self._m_incidents = metrics.counter(
            "flightrec_incidents_total",
            help="flight-recorder incident bundles frozen")

    # -- per-tick feed --------------------------------------------------
    def record(self, frame: dict) -> list[dict]:
        """Append one tick's frame, evaluate triggers, freeze incident
        bundles past dedup/cooldown. Returns the NEW incidents (empty
        on a quiet tick). Expected frame keys (all optional —
        triggers only evaluate what is present): ``tick``,
        ``tick_ms``, ``budget_ms``, ``stage``, ``over_cap``,
        ``over_k``, ``signature``."""
        fired: list[tuple[str, str]] = []
        with self._lock:
            tick_ms = frame.get("tick_ms")
            budget = frame.get("budget_ms")
            if tick_ms is not None and budget is not None \
                    and tick_ms > budget:
                fired.append(
                    ("slo_breach", f"{tick_ms:g} ms > {budget:g} ms"))
            stage = frame.get("stage")
            if stage is not None:
                if self._prev_stage is not None \
                        and stage != self._prev_stage:
                    fired.append(("overload_transition",
                                  f"{self._prev_stage}>{stage}"))
                self._prev_stage = stage
            over_cap = frame.get("over_cap")
            if over_cap is not None:
                if over_cap > 0:
                    if self._quiet_run >= self.quiet_ticks:
                        fired.append((
                            "over_cap_after_quiet",
                            f"over_cap={over_cap} after "
                            f"{self._quiet_run} quiet ticks"))
                    self._quiet_run = 0
                else:
                    self._quiet_run += 1
            sig = frame.get("signature")
            if sig is not None:
                if self._prev_sig is not None and sig != self._prev_sig:
                    fired.append(("signature_change",
                                  f"{self._prev_sig}>{sig}"))
                self._prev_sig = sig
            sa_p99 = frame.get("sync_age_p99_ms")
            sa_target = frame.get("sync_age_target_ms")
            if sa_p99 == "inf":
                # the JSON-safe non-finite convention (syncage.ptiles):
                # mass past the last bucket is the strongest breach
                sa_p99 = float("inf")
            if sa_p99 is not None and sa_target is not None \
                    and sa_p99 > sa_target:
                fired.append((
                    "sync_age_breach",
                    f"e2e p99 {sa_p99:g} ms > {sa_target:g} ms"))
            rb_p99 = frame.get("residency_bubble_p99_ms")
            rb_budget = frame.get("residency_bubble_budget_ms")
            if rb_p99 == "inf":
                rb_p99 = float("inf")
            if rb_p99 is not None and rb_budget is not None \
                    and rb_p99 > rb_budget:
                # the serve loop's host bubble regressed past its
                # budget: frame time the device sat idle for no reason
                # (utils/residency.py; game frames)
                fired.append((
                    "residency_regression",
                    f"bubble p99 {rb_p99:g} ms > {rb_budget:g} ms"))
            gov = frame.get("governor")
            if gov is not None:
                # the autotune governor committed a kernel-config swap
                # this tick (goworld_tpu/autotune); context_fn freezes
                # the decision context into the bundle
                fired.append(("governor_swap", str(gov)))
            av = frame.get("audit_violation")
            if av is not None:
                # the correctness audit plane recorded a violation
                # (utils/audit.py: lost/duplicated entity, oracle
                # mismatch, mirror divergence, snapshot CRC);
                # context_fn freezes the ledger tail + cohort diff
                fired.append(("audit_violation", str(av)))
            sbp = frame.get("standby_promoted")
            if sbp is not None:
                # a standby won its promotion claim and took over a
                # dead primary (goworld_tpu/replication/): the frame
                # names game/epoch/seq/tick; the bundle freezes the
                # promotion-side context (the primary's ring froze at
                # its crash — both sides of the failover keep bundles)
                fired.append(("standby_promoted", str(sbp)))
            rba = frame.get("rebalance")
            if rba is not None:
                # the rebalance plane took a topology action this tick
                # (goworld_tpu/rebalance/): a handoff started,
                # completed or aborted; the detail carries the action
                # note (target, cohort, cause) and the bundle freezes
                # the decision context around the move
                fired.append(("rebalance_action", str(rba)))
            self._frames.append(dict(frame))
            self._frames_total += 1
            new = [self._freeze(kind, detail, frame)
                   for kind, detail in fired]
            return [i for i in new if i is not None]

    def _freeze(self, kind: str, detail: str,
                frame: dict) -> dict | None:
        """Dedup/cooldown gate + bundle freeze (lock held)."""
        self._fired[kind] = self._fired.get(kind, 0) + 1
        now = self.clock()
        last = self._last_fire.get(kind)
        if last is not None and now - last < self.cooldown_secs:
            self._suppressed[kind] = self._suppressed.get(kind, 0) + 1
            return None
        self._last_fire[kind] = now
        bundle: dict[str, Any] = {
            "trigger": kind,
            "detail": detail,
            "tick": frame.get("tick"),
            "at_mono": now,
            "wall_time": time.time(),
            # the ring tail, newest last — the "what was happening
            # around it" payload
            "frames": [dict(f) for f in
                       list(self._frames)[-self.snapshot_frames:]],
        }
        if self.context_fn is not None:
            try:
                bundle["context"] = self.context_fn()
            except Exception as exc:  # context must never kill a tick
                bundle["context"] = {"error": str(exc)[:200]}
        self._incidents.append(bundle)
        self._m_incidents.inc()
        logger.warning("flight recorder incident: %s (%s) at tick %s",
                       kind, detail, frame.get("tick"))
        return bundle

    # -- observation ----------------------------------------------------
    def incidents(self) -> list[dict]:
        with self._lock:
            return [dict(i) for i in self._incidents]

    def snapshot(self, frames: bool = False) -> dict:
        """The ``/incidents`` payload for this recorder. Incident
        bundles always carry their frozen frame tails; the LIVE ring is
        included only on request (``frames=True`` / ``?frames=1``)."""
        with self._lock:
            out: dict[str, Any] = {
                "ring": self.ring,
                "frames_recorded": self._frames_total,
                "cooldown_secs": self.cooldown_secs,
                "incident_count": len(self._incidents),
                "fired": dict(self._fired),
                "suppressed": dict(self._suppressed),
                "incidents": [dict(i) for i in self._incidents],
            }
            if frames:
                out["live_frames"] = [dict(f) for f in self._frames]
            return out


# =======================================================================
# process-local registry (served by debug_http /incidents + /workload)
# =======================================================================
_reg_lock = threading.Lock()
_recorders: dict[str, FlightRecorder] = {}
_workload_provider: Callable[[], dict | None] | None = None


def register(name: str, rec: FlightRecorder) -> FlightRecorder:
    with _reg_lock:
        _recorders[name] = rec
    return rec


def unregister(name: str) -> None:
    with _reg_lock:
        _recorders.pop(name, None)


def get(name: str) -> FlightRecorder | None:
    with _reg_lock:
        return _recorders.get(name)


def snapshot_all(frames: bool = False) -> dict:
    """``/incidents``: every registered recorder's snapshot."""
    with _reg_lock:
        recs = list(_recorders.items())
    return {name: rec.snapshot(frames=frames) for name, rec in recs}


def set_workload_provider(fn: Callable[[], dict | None] | None) -> None:
    """Install the live workload-signature provider (the GameServer
    registers a weakref-backed closure; latest wins, like the devprof
    provider convention)."""
    global _workload_provider
    with _reg_lock:
        _workload_provider = fn


def workload_snapshot() -> dict:
    """``/workload``: the live signature, or an honest absence."""
    with _reg_lock:
        fn = _workload_provider
    if fn is None:
        return {"error": "no live workload provider in this process"}
    try:
        sig = fn()
    except Exception as exc:  # a provider must never 500 the endpoint
        return {"error": str(exc)[:200]}
    if not sig:
        return {"error": "no telemetry samples yet"}
    return sig


def reset() -> None:
    """Drop all registered state (tests)."""
    global _workload_provider
    with _reg_lock:
        _recorders.clear()
        _workload_provider = None
