"""Standby-side replication, the port's copy of
``goworld_tpu/replication/standby.py`` (host only; the frames it applies
reach the device through the World's staged pose writes): apply frames
into a LIVE world, account lag, serve ``/standby``.

Apply model: a frame resolves (frames.StreamDecoder) to the v1 freeze
shape — spaces + entities with dequantized pose — and is reconciled
INCREMENTALLY into the standby's world, the same 3-pass ordering
restore_world uses (nil space, spaces, entities) but diffed against
the live population instead of requiring an empty world:

* a keyframe (or delta) entity missing locally is created exactly the
  way restore pass 3 creates it (attach, quiet attr load, enter
  space, timers, OnRestored);
* an existing entity gets a quiet attr reload and its pose staged via
  ``World.stage_pose`` — the deltas' sparse rows land as the SAME
  vectorized pos-scatter the restore path uses, flushed into the
  device SoA on the first tick the world runs (which, for a standby,
  is the promotion tick — the restore_world contract);
* entities/spaces absent from the frame are destroyed QUIETLY (no
  persistence writes — the primary owns storage until promotion).

After every applied frame the EntityLedger is re-anchored via
``resync`` so the audit plane's conservation identity holds on the
standby too — a promotion can prove zero lost/duplicated EntityIDs by
name (utils/audit.py conservation_verdict), not by hope.

Honesty bounds (documented in docs/ROBUSTNESS.md): timers restore at
entity-create only (a standby does not re-anchor timer deadlines per
frame), and OnDestroy hooks do fire for mirror-destroyed entities.

The :class:`StandbyTracker` is the ``/standby`` payload: applied
seq/tick, stream bytes, reject counts by reason, last-keyframe age,
and a sync-age-style staleness verdict (lag in ticks vs a budget) —
plus the promotion hook the supervisor drives.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

from goworld_tpu_torch.replication.frames import StreamDecoder, TornStreamError
from goworld_tpu_torch.utils import log, metrics

logger = log.get("replication")

DEFAULT_LAG_BUDGET_TICKS = 16


def _quiet_destroy(world, e) -> None:
    """Destroy a mirror entity without persistence writes: the primary
    owns storage until promotion (a standby double-writing entity saves
    would race the primary's)."""
    st, world.storage = world.storage, None
    try:
        world.destroy_entity(e)
    finally:
        world.storage = st


class StandbyApplier:
    """Applies a replication stream into one live world. Single-threaded
    (the standby game's logic thread)."""

    def __init__(self, world, primary_gid: int,
                 tracker: "StandbyTracker | None" = None):
        self.world = world
        self.primary_gid = int(primary_gid)
        self.tracker = tracker
        self.decoder = StreamDecoder()
        self._moving: dict[str, bool] = {}  # eid -> last staged flag

    def apply(self, blob: bytes) -> dict:
        """Apply one wire frame. Returns ``{"ok": True, "kind", "tick",
        "seq"}`` or ``{"ok": False, "reason", "needs_keyframe": True}``
        — a rejected frame changes NOTHING in the world."""
        t0 = time.perf_counter()
        try:
            kind, tick, data, planes, eids = self.decoder.feed(blob)
        except TornStreamError as exc:
            if self.tracker is not None:
                self.tracker.note_reject(exc.reason)
            logger.warning(
                "standby of game%d: frame rejected (%s); awaiting "
                "keyframe", self.primary_gid, exc)
            return {"ok": False, "reason": exc.reason,
                    "needs_keyframe": True}
        self._reconcile(data)
        w = self.world
        if w.audit is not None:
            w.audit.ledger.resync(
                {e.id: e.type_name for e in w.entities.values()
                 if not e.destroyed},
                tick)
        if self.tracker is not None:
            self.tracker.note_applied(
                kind, tick, self.decoder.applied_seq, len(blob),
                apply_ms=(time.perf_counter() - t0) * 1e3)
        return {"ok": True, "kind": kind, "tick": tick,
                "seq": self.decoder.applied_seq}

    # -- world reconciliation -------------------------------------------
    def _reconcile(self, data: dict) -> None:
        from goworld_tpu_torch.entity.entity import GameClient
        from goworld_tpu_torch.entity.space import Space
        from goworld_tpu_torch.freeze import _load_attrs_quiet

        w = self.world
        nil = w.nil_space or w.create_nil_space()
        _load_attrs_quiet(nil, data["nil_space"].get("attrs", {}))

        seen: set[str] = {nil.id}
        for sd in data["spaces"]:
            seen.add(sd["id"])
            sp = w.entities.get(sd["id"])
            if sp is None:
                desc = w.registry.get(sd["type"])
                sp = desc.cls()
                sp._type_desc = desc
                w._attach(sp, sd["id"])
                if sd.get("mega"):
                    raise RuntimeError(
                        "standby replication does not support "
                        "megaspace worlds")
                if sd.get("use_aoi", True):
                    try:
                        shard = w._shard_space.index(None)
                    except ValueError:
                        raise RuntimeError(
                            f"standby: no free shard for replicated "
                            f"space {sd['id']}") from None
                    w._shard_space[shard] = sp.id
                    sp.shard = shard
                w.entities[sp.id] = sp
                w.spaces[sp.id] = sp
                _load_attrs_quiet(sp, sd.get("attrs", {}))
                for tid in w.timers.restore(sd.get("timers", [])):
                    sp.timer_ids.add(tid)
                sp.OnRestored()
            else:
                _load_attrs_quiet(sp, sd.get("attrs", {}))

        for ed in data["entities"]:
            seen.add(ed["id"])
            e = w.entities.get(ed["id"])
            target = w.spaces.get(ed.get("space_id") or "") \
                or w.nil_space
            if e is None:
                desc = w.registry.get(ed["type"])
                e = desc.cls()
                e._type_desc = desc
                w._attach(e, ed["id"])
                w.entities[e.id] = e
                _load_attrs_quiet(e, ed.get("attrs", {}))
                if ed.get("client"):
                    e.client = GameClient(ed["client"][0],
                                          ed["client"][1], w, owner=e)
                w._enter_space_local(
                    e, target, tuple(ed["pos"]),
                    moving=bool(ed.get("moving")))
                w.stage_pose(e, ed["pos"], float(ed.get("yaw", 0.0)))
                for tid in w.timers.restore(ed.get("timers", [])):
                    e.timer_ids.add(tid)
                self._moving[e.id] = bool(ed.get("moving"))
                e.OnRestored()
                continue
            _load_attrs_quiet(e, ed.get("attrs", {}))
            cl = ed.get("client")
            cur = [e.client.gate_id, e.client.client_id] \
                if e.client is not None else None
            if cl != cur:
                e.client = GameClient(cl[0], cl[1], w, owner=e) \
                    if cl else None
            if e.space is not target and target is not None:
                w._move_space_host(e, target, tuple(ed["pos"]))
            moving = bool(ed.get("moving"))
            stage_moving: "bool | None" = None
            if self._moving.get(e.id) != moving:
                self._moving[e.id] = moving
                stage_moving = moving
            w.stage_pose(e, ed["pos"], float(ed.get("yaw", 0.0)),
                         moving=stage_moving)

        gone = [e for eid, e in list(w.entities.items())
                if eid not in seen and e is not nil
                and not isinstance(e, Space) and not e.destroyed]
        gone += [sp for sid, sp in list(w.spaces.items())
                 if sid not in seen and not sp.destroyed]
        for e in gone:
            self._moving.pop(e.id, None)
            _quiet_destroy(w, e)

        if w.client_sink is None:
            # mirror-side client binds/destroys would otherwise pile up
            # in the sink-less fallback buffer forever (a standby never
            # flushes outputs until promotion)
            w.client_messages.clear()


class StandbyTracker:
    """Replication-lag accounting + the promotion hook for one standby;
    its :meth:`snapshot` is the ``/standby`` payload. Clock injectable
    (the flightrec determinism convention)."""

    def __init__(self, standby_gid: int, primary_gid: int, *,
                 tick_hz: float = 60.0,
                 lag_budget_ticks: int = DEFAULT_LAG_BUDGET_TICKS,
                 clock: Callable[[], float] = time.monotonic):
        self.standby_gid = int(standby_gid)
        self.primary_gid = int(primary_gid)
        self.tick_hz = float(tick_hz)
        self.lag_budget_ticks = int(lag_budget_ticks)
        self.clock = clock
        self._lock = threading.Lock()
        self.frames = 0
        self.bytes = 0
        self.applied_seq = -1
        self.applied_tick = -1
        self.first_tick = -1
        self.last_kind: str | None = None
        self.last_frame_at: float | None = None
        self.last_key_at: float | None = None
        self.last_key_tick = -1
        self.apply_ms_last = 0.0
        self.rejects: dict[str, int] = {}
        self.promoted_epoch: int | None = None
        self.promoted_at_tick: int | None = None
        # installed by the standby GameServer; called with the claim
        # epoch by request_promotion (the supervisor's HTTP poke)
        self.on_promote: "Callable[[int], dict] | None" = None
        self._m_applied = metrics.counter(
            "replication_frames_applied_total",
            help="replication frames applied into the standby world",
            game=str(self.standby_gid))
        self._m_rejected = metrics.counter(
            "replication_frames_rejected_total",
            help="replication frames rejected whole (torn stream)",
            game=str(self.standby_gid))

    def note_applied(self, kind: str, tick: int, seq: int,
                     nbytes: int, apply_ms: float = 0.0) -> None:
        with self._lock:
            self.frames += 1
            self.bytes += int(nbytes)
            self.applied_seq = int(seq)
            self.applied_tick = int(tick)
            if self.first_tick < 0:
                self.first_tick = int(tick)
            self.last_kind = kind
            self.last_frame_at = self.clock()
            self.apply_ms_last = float(apply_ms)
            if kind == "key":
                self.last_key_at = self.last_frame_at
                self.last_key_tick = int(tick)
        self._m_applied.inc()

    def note_reject(self, reason: str) -> None:
        with self._lock:
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
        self._m_rejected.inc()

    def note_promoted(self, epoch: int, at_tick: int) -> None:
        with self._lock:
            self.promoted_epoch = int(epoch)
            self.promoted_at_tick = int(at_tick)

    def lag_ticks(self) -> float | None:
        """Staleness of the mirror, sync-age style: wall time since the
        last applied frame, expressed in primary ticks. None before the
        first frame."""
        with self._lock:
            if self.last_frame_at is None:
                return None
            return (self.clock() - self.last_frame_at) * self.tick_hz

    def snapshot(self) -> dict:
        lag = self.lag_ticks()
        with self._lock:
            span = max(1, self.applied_tick - self.first_tick + 1) \
                if self.first_tick >= 0 else 1
            out: dict[str, Any] = {
                "role": ("promoted" if self.promoted_epoch is not None
                         else "standby"),
                "standby_game": self.standby_gid,
                "primary_game": self.primary_gid,
                "frames": self.frames,
                "bytes": self.bytes,
                "bytes_per_tick": round(self.bytes / span, 1),
                "applied_seq": self.applied_seq,
                "applied_tick": self.applied_tick,
                "last_kind": self.last_kind,
                "last_keyframe_tick": self.last_key_tick,
                "last_keyframe_age_s": (
                    round(self.clock() - self.last_key_at, 3)
                    if self.last_key_at is not None else None),
                "apply_ms_last": round(self.apply_ms_last, 3),
                "rejects": dict(self.rejects),
                "lag_budget_ticks": self.lag_budget_ticks,
                "promoted_epoch": self.promoted_epoch,
                "promoted_at_tick": self.promoted_at_tick,
            }
        out["lag_ticks"] = round(lag, 2) if lag is not None else None
        # the staleness verdict (sync-age convention: measured vs
        # target, an explicit pass bool; absent before the first frame)
        if lag is not None:
            out["pass"] = bool(lag <= self.lag_budget_ticks)
        return out


# =======================================================================
# process-local registry (served by debug_http /standby). Weak values:
# the tracker belongs to its GameServer (the syncage convention).
# =======================================================================
_reg_lock = threading.Lock()
_trackers: "weakref.WeakValueDictionary[str, StandbyTracker]" = \
    weakref.WeakValueDictionary()


def register(name: str, tracker: StandbyTracker) -> StandbyTracker:
    with _reg_lock:
        _trackers[name] = tracker
    return tracker


def unregister(name: str) -> None:
    with _reg_lock:
        _trackers.pop(name, None)


def snapshot_all() -> dict:
    """``/standby``: every registered tracker's snapshot, or an honest
    absence (primaries and non-replicating processes serve the endpoint
    but track nothing — the aggregator skips them silently)."""
    with _reg_lock:
        trackers = dict(_trackers)
    if not trackers:
        return {"error": "no standby tracker in this process"}
    return {name: t.snapshot() for name, t in sorted(trackers.items())}


def request_promotion(epoch: int | None = None) -> dict:
    """The supervisor's poke (``/standby?promote=1[&epoch=E]``): drive
    the registered tracker's promotion hook. With no explicit epoch the
    hook derives one (last observed promotion round + 1)."""
    with _reg_lock:
        trackers = dict(_trackers)
    hooks = [(name, t) for name, t in sorted(trackers.items())
             if t.on_promote is not None]
    if not hooks:
        return {"error": "no promotable standby in this process"}
    name, t = hooks[0]
    try:
        out = t.on_promote(epoch if epoch is None else int(epoch))
    except Exception as exc:  # the hook must never 500 the endpoint
        logger.exception("promotion hook failed")
        return {"error": f"promotion hook failed: {exc}"[:300]}
    return {"standby": name, **(out or {})}


def reset() -> None:
    """Drop registered trackers (tests)."""
    with _reg_lock:
        _trackers.clear()
