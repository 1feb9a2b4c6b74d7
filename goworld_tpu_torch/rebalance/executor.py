"""Bounded entity-cohort handoff executor, the port's copy of
``goworld_tpu/rebalance/executor.py``.

One :class:`HandoffExecutor` per game drives a committed rebalance
action through the production migration machinery: deterministic
space-affine cohort choice, rate-limited to ``batch`` entities per
pump window (so the migration path never becomes its own overload
source), admission to the donor space paused mid-move, and a clean
abort — a target crash or timeout mid-batch restores every unacked
entity live on the source through the ledger's out-record/seq
machinery (``restore_from_migration`` on the source is the accepted
self-round-trip; the out-record retires and conservation stays green).

Two transports share the same bookkeeping:

- **detach transport** (in-process harnesses, chaos_soak, tests): the
  executor itself runs ``get_migrate_data`` + ``remove_for_migration``
  per entity and hands the payload to ``send(eid, data)``; the
  transport calls :meth:`ack` when the receiver has restored the
  entity. Unacked payloads are held for the abort restore.
- **wire transport** (``detach=False``; GameServer): ``send(eid, e)``
  only *initiates* the production QUERY_SPACE → MIGRATE_REQUEST →
  REAL_MIGRATE sequence; the protocol handlers do the removal, the
  per-tick :meth:`wire_poll` observes completion, and an entity whose
  migration never started is simply still live on the source.

Every terminal transition stamps an action note (the
``rebalance_action`` flight-recorder trigger input) and bumps
``rebalance_moves_total{from,to,reason}`` /
``rebalance_aborts_total{cause}``.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

from goworld_tpu_torch.utils import log, metrics

logger = log.get("rebalance")

__all__ = ["HandoffExecutor"]


class HandoffExecutor:
    """Drives one bounded cohort handoff at a time for one world."""

    def __init__(self, world, game_id: int | None = None,
                 batch: int = 64):
        if batch < 1:
            raise ValueError(f"rebalance_batch must be >= 1, got "
                             f"{batch!r}")
        self.world = world
        self.game_id = int(game_id if game_id is not None
                           else getattr(world, "game_id", 0))
        self.batch = int(batch)
        self._job: dict | None = None
        self._action_note: str | None = None
        self._last_result: dict | None = None
        self.moves_total: dict[tuple[str, str, str], int] = {}
        self.aborts_total: dict[str, int] = {}
        self.handoffs = 0
        self.completed = 0
        self.aborted = 0

    # -- cohort planning -----------------------------------------------
    def plan_cohort(self, batch: int | None = None
                    ) -> tuple[str | None, list[str]]:
        """Deterministic space-affine donor cohort: the most populated
        non-nil space's entities in sorted-eid order, capped at
        ``batch``. Space affinity keeps the moved cohort's AOI
        neighborhood together on the receiver — the move sheds load
        without shredding interest sets."""
        want = int(batch or self.batch)
        best_sid, best_n = None, 0
        nil = getattr(self.world, "nil_space", None)
        nil_id = getattr(nil, "id", None)
        for sid, sp in sorted(self.world.spaces.items()):
            if sid == nil_id:
                continue
            n = len(getattr(sp, "members", ()) or ())
            if n > best_n:
                best_sid, best_n = sid, n
        if best_sid is None:
            return None, []
        sp = self.world.spaces[best_sid]
        eids = sorted(
            eid for eid in sp.members
            if (e := self.world.entities.get(eid)) is not None
            and not getattr(e, "destroyed", False))
        return best_sid, eids[:want]

    # -- lifecycle -----------------------------------------------------
    @property
    def busy(self) -> bool:
        return self._job is not None

    def start(self, target: int, reason: str,
              send: Callable[..., Any], batch: int | None = None,
              rate: int | None = None, detach: bool = True,
              timeout_windows: int = 8) -> int:
        """Begin a handoff of up to ``batch`` entities to game
        ``target``. Returns the cohort size (0 = nothing to move; no
        job is opened). Raises if a handoff is already in flight —
        the controller commits at most one move per window and the
        executor refuses to interleave."""
        if self._job is not None:
            raise RuntimeError(
                f"game{self.game_id}: handoff already in flight "
                f"(to game{self._job['target']})")
        space_id, eids = self.plan_cohort(batch)
        if not eids:
            return 0
        pause = getattr(self.world, "pause_admission", None)
        if pause is not None:
            pause(space_id, True)
        self._job = {
            "target": int(target),
            "reason": str(reason),
            "space_id": space_id,
            "queue": deque(eids),
            "unacked": {},          # eid -> migrate data (detach mode)
            "initiated": set(),     # eids kicked on the wire path
            "send": send,
            "detach": bool(detach),
            "rate": int(rate or batch or self.batch),
            "sent": 0,
            "acked": 0,
            "windows": 0,
            "idle_windows": 0,
            "timeout_windows": int(timeout_windows),
        }
        self.handoffs += 1
        self._note(
            f"start to=game{target} batch={len(eids)} "
            f"space={space_id} reason={reason}")
        return len(eids)

    def pump(self) -> int:
        """One rate-limited send window. Returns entities sent this
        window. Detach mode removes each entity from the source at ITS
        OWN send tick (``out_tick`` defaults to the world's current
        tick) — the per-record stamp the burst-aware conservation
        verdict ages from."""
        job = self._job
        if job is None:
            return 0
        job["windows"] += 1
        sent = 0
        progressed = False
        while job["queue"] and sent < job["rate"]:
            eid = job["queue"].popleft()
            e = self.world.entities.get(eid)
            if e is None or getattr(e, "destroyed", False):
                continue  # died while queued: nothing to move
            try:
                if job["detach"]:
                    data = self.world.get_migrate_data(e)
                    data["space_id"] = job["space_id"]
                    data["pos"] = list(e.position)
                    self.world.remove_for_migration(
                        e, target=job["target"])
                    job["unacked"][eid] = data
                    job["send"](eid, data)
                else:
                    job["send"](eid, e)
                    job["initiated"].add(eid)
            except Exception:
                logger.exception(
                    "game%d: handoff send failed for %s",
                    self.game_id, eid)
                self.abort("send_failed")
                return sent
            job["sent"] += 1
            sent += 1
            progressed = True
        if progressed:
            job["idle_windows"] = 0
        if not job["queue"] and not job["unacked"] \
                and not job["initiated"]:
            self._finish()
        elif not progressed:
            job["idle_windows"] += 1
            if job["idle_windows"] > job["timeout_windows"]:
                # the target stopped acking mid-batch: roll back
                self.abort("timeout")
        return sent

    def ack(self, eid: str) -> None:
        """The receiver restored ``eid``: retire it from the unacked
        set and count the move."""
        job = self._job
        if job is None:
            return
        if job["unacked"].pop(eid, None) is None \
                and eid not in job["initiated"]:
            return
        job["initiated"].discard(eid)
        job["acked"] += 1
        job["idle_windows"] = 0
        self._count_move(job)
        if not job["queue"] and not job["unacked"] \
                and not job["initiated"]:
            self._finish()

    def wire_poll(self, migrating_out: dict) -> None:
        """Wire-mode completion scan (GameServer per-tick): an
        initiated entity that has left both the world and the pending
        migrate table completed; one still live with no pending
        migrate was cancelled by the protocol (space vanished, ack
        timeout) and is simply still OURS — count it back into the
        queue's tail once, the production no-loss semantics."""
        job = self._job
        if job is None or job["detach"]:
            return
        for eid in sorted(job["initiated"]):
            if eid in migrating_out:
                continue  # still in protocol flight
            if eid not in self.world.entities:
                self.ack(eid)
            else:
                # protocol abandoned the move; entity stayed live
                job["initiated"].discard(eid)
                job["idle_windows"] += 1
        if job is self._job and job["idle_windows"] \
                > job["timeout_windows"]:
            self.abort("timeout")

    def abort(self, cause: str) -> int:
        """Roll the in-flight batch back: every unacked entity is
        restored LIVE on the source world (the ledger accepts the
        self-round-trip and retires the out-record, so the
        conservation verdict stays green), admission resumes, and the
        abort is counted by cause. Returns entities restored."""
        job, self._job = self._job, None
        if job is None:
            return 0
        restored = 0
        space = self.world.spaces.get(job["space_id"])
        for eid, data in sorted(job["unacked"].items()):
            try:
                self.world.restore_from_migration(data, space=space)
                restored += 1
            except Exception:
                logger.exception(
                    "game%d: abort restore failed for %s",
                    self.game_id, eid)
        self.aborted += 1
        self._last_result = {"kind": "abort", "cause": cause,
                             "target": job["target"],
                             "restored": restored,
                             "moved": job["acked"]}
        self.aborts_total[cause] = self.aborts_total.get(cause, 0) + 1
        metrics.counter(
            "rebalance_aborts_total",
            help="rebalance handoffs rolled back, by cause",
            cause=cause, game=f"game{self.game_id}").inc()
        self._resume(job)
        self._note(
            f"abort to=game{job['target']} cause={cause} "
            f"restored={restored} acked={job['acked']}")
        logger.warning(
            "game%d: handoff to game%d aborted (%s): %d restored, "
            "%d already acked", self.game_id, job["target"], cause,
            restored, job["acked"])
        return restored

    def _finish(self) -> None:
        job, self._job = self._job, None
        if job is None:
            return
        self.completed += 1
        self._last_result = {"kind": "done", "cause": "",
                             "target": job["target"],
                             "restored": 0, "moved": job["acked"]}
        self._resume(job)
        self._note(
            f"done to=game{job['target']} moved={job['acked']} "
            f"windows={job['windows']} reason={job['reason']}")
        logger.info(
            "game%d: handoff to game%d complete: %d entities over %d "
            "windows (%s)", self.game_id, job["target"], job["acked"],
            job["windows"], job["reason"])

    def _resume(self, job: dict) -> None:
        pause = getattr(self.world, "pause_admission", None)
        if pause is not None:
            pause(job["space_id"], False)

    def _count_move(self, job: dict) -> None:
        key = (f"game{self.game_id}", f"game{job['target']}",
               job["reason"])
        self.moves_total[key] = self.moves_total.get(key, 0) + 1
        metrics.counter(
            "rebalance_moves_total",
            help="entities moved by rebalance handoffs",
            **{"from": key[0], "to": key[1],
               "reason": job["reason"]}).inc()

    # -- flight-recorder hand-off --------------------------------------
    def _note(self, action: str) -> None:
        self._action_note = action

    def take_action_note(self) -> str | None:
        """Pop the freshest terminal action note — the per-tick
        flight-recorder frame key (each action fires the
        ``rebalance_action`` trigger at most once)."""
        note, self._action_note = self._action_note, None
        return note

    def take_result(self) -> dict | None:
        """Pop the last terminal job outcome (``{"kind": "done" |
        "abort", ...}``) — the controller feeds it back into the
        policy's decision stream exactly once."""
        res, self._last_result = self._last_result, None
        return res

    # -- reading -------------------------------------------------------
    def snapshot(self) -> dict:
        job = self._job
        return {
            "game": f"game{self.game_id}",
            "busy": job is not None,
            "job": {
                "target": f"game{job['target']}",
                "space_id": job["space_id"],
                "queued": len(job["queue"]),
                "unacked": len(job["unacked"]) + len(job["initiated"]),
                "sent": job["sent"],
                "acked": job["acked"],
                "windows": job["windows"],
                "reason": job["reason"],
            } if job else None,
            "handoffs": self.handoffs,
            "completed": self.completed,
            "aborted": self.aborted,
            "moves_total": {
                f"{f}->{t}:{r}": n
                for (f, t, r), n in sorted(self.moves_total.items())
            },
            "aborts_total": dict(sorted(self.aborts_total.items())),
        }
