"""Deployment rebalance decision policy, the port's copy of
``goworld_tpu/rebalance/policy.py``.

Pure decision core of the self-healing deployment plane: one
:class:`RebalancePolicy` instance watches the per-window observation
stream (every game's overload stage, entity occupancy and kvreg
presence) and decides when a sustained-DEGRADED game should hand a
bounded entity cohort to an underloaded peer. The policy is a pure
function of the observation stream — no clocks, no randomness, no
ambient state — and every window is recorded in a
:class:`~goworld_tpu_torch.replication.promote.DecisionLog`, so the exact
decision sequence replays byte-for-byte from the recorded inputs
(the governor/promotion convention; see :func:`RebalancePolicy.replay`).

Decision grammar (docs/ROBUSTNESS.md "Elastic rebalancing"):

- ``observe``  — one per window: the canonical observation (stage,
  entities, presence per game, JSON with sorted keys).
- ``plan``     — a donor held DEGRADED-or-worse for ``hold_windows``
  consecutive windows and a fit target exists; the move is staged for
  ONE window before committing (the cancellation point).
- ``cancel``   — the staged move died before commit: the donor
  recovered during planning (``donor_recovered``) or the target lost
  its headroom / presence (``target_unfit``).
- ``commit``   — the staged move survived one window: the action is
  emitted and the (donor, target) pair enters cooldown.
- ``cooldown`` / ``no_target`` — a wanted move was suppressed.
- ``result``   — executor feedback (done / abort); an abort re-arms
  the pair cooldown so a crashing target is not hammered.

Hysteresis: the hold-run requirement IS the up-hysteresis (one noisy
window resets the run), the one-window plan→commit gap cancels moves
whose cause evaporated, and the per-pair cooldown (sorted pair, so it
suppresses the reverse move too) prevents ping-pong when load
alternates between two games.
"""
from __future__ import annotations

import json
from typing import Any, Mapping

from goworld_tpu_torch.replication.promote import DecisionLog
from goworld_tpu_torch.utils.overload import state_rank

__all__ = ["RebalancePolicy", "canonical_observation"]

# a game is a rebalance DONOR candidate while at or above this overload
# rank (DEGRADED); a game is a TARGET candidate only at NORMAL
HOT_RANK = 1


def canonical_observation(games: Mapping[str, Mapping[str, Any]]) -> dict:
    """Normalize a raw per-game observation mapping into the canonical
    shape the policy consumes and the DecisionLog records: sorted game
    names, each reduced to ``{stage, entities, present}``. Unknown
    stages rank as NORMAL (a scrape gap must never synthesize load)."""
    return {
        str(name): {
            "stage": str(g.get("stage", "NORMAL")),
            "entities": int(g.get("entities", 0)),
            "present": bool(g.get("present", True)),
        }
        for name, g in sorted(games.items())
    }


class RebalancePolicy:
    """Pure, replayable rebalance decision state machine.

    ``observe()`` once per observation window with the per-game
    observation mapping; it returns an action dict
    ``{"frm", "to", "batch", "reason", "window"}`` on the window a
    staged move commits, else ``None``. ``feedback()`` reports the
    executor outcome back into the decision stream (it is part of the
    replayed input)."""

    def __init__(self, hold_windows: int = 3, batch: int = 64,
                 cooldown_windows: int = 10,
                 log: DecisionLog | None = None):
        # loud validation, the GridSpec convention
        if hold_windows < 1:
            raise ValueError(
                f"rebalance_hold_windows must be >= 1, got "
                f"{hold_windows!r}")
        if batch < 1:
            raise ValueError(
                f"rebalance_batch must be >= 1, got {batch!r}")
        if cooldown_windows < 1:
            raise ValueError(
                f"rebalance cooldown must be >= 1 window, got "
                f"{cooldown_windows!r}")
        self.hold_windows = int(hold_windows)
        self.batch = int(batch)
        self.cooldown_windows = int(cooldown_windows)
        self.log = log if log is not None else DecisionLog()
        self.window = 0
        self._run: dict[str, int] = {}      # game -> consecutive hot
        self._cooldown: dict[tuple[str, str], int] = {}  # pair -> until
        self._pending: dict | None = None   # staged move awaiting commit
        self.planned = 0
        self.committed = 0
        self.cancelled = 0

    # -- the per-window decision ---------------------------------------
    def observe(self, games: Mapping[str, Mapping[str, Any]]
                ) -> dict | None:
        canon = canonical_observation(games)
        self.window += 1
        self.log.note(
            "observe", window=self.window,
            games=json.dumps(canon, sort_keys=True,
                             separators=(",", ":")))
        for name, g in canon.items():
            hot = g["present"] and state_rank(g["stage"]) >= HOT_RANK
            self._run[name] = self._run.get(name, 0) + 1 if hot else 0
        # drop runs for games that vanished from the observation set
        for name in [n for n in self._run if n not in canon]:
            del self._run[name]

        if self._pending is not None:
            return self._judge_pending(canon)
        self._stage_plan(canon)
        return None

    def _judge_pending(self, canon: dict) -> dict | None:
        p, self._pending = self._pending, None
        frm, to = p["frm"], p["to"]
        if self._run.get(frm, 0) == 0:
            # the donor cooled off while the move was staged: the
            # cause evaporated, so the move must too
            self.cancelled += 1
            self.log.note("cancel", cause="donor_recovered",
                          frm=frm, to=to, window=self.window)
            return None
        tgt = canon.get(to)
        if (tgt is None or not tgt["present"]
                or state_rank(tgt["stage"]) >= HOT_RANK
                or tgt["entities"] + self.batch
                > canon[frm]["entities"]):
            self.cancelled += 1
            self.log.note("cancel", cause="target_unfit",
                          frm=frm, to=to, window=self.window)
            return None
        self.committed += 1
        self._cooldown[_pair(frm, to)] = (
            self.window + self.cooldown_windows)
        self.log.note("commit", frm=frm, to=to, batch=p["batch"],
                      reason=p["reason"], window=self.window)
        return {"frm": frm, "to": to, "batch": p["batch"],
                "reason": p["reason"], "window": self.window}

    def _stage_plan(self, canon: dict) -> None:
        donors = [n for n, r in sorted(self._run.items())
                  if r >= self.hold_windows and n in canon]
        if not donors:
            return
        # deterministic donor choice: longest-suffering, then most
        # loaded, then name
        frm = max(donors, key=lambda n: (self._run[n],
                                         canon[n]["entities"], n))
        fits = [
            n for n, g in canon.items()
            if n != frm and g["present"]
            and state_rank(g["stage"]) < HOT_RANK
            # headroom: the move must strictly shrink the imbalance,
            # or two near-equal games would trade the same cohort
            and g["entities"] + self.batch <= canon[frm]["entities"]
        ]
        if not fits:
            self.log.note("no_target", frm=frm, window=self.window)
            return
        to = min(fits, key=lambda n: (canon[n]["entities"], n))
        until = self._cooldown.get(_pair(frm, to), 0)
        if self.window < until:
            self.log.note("cooldown", frm=frm, to=to, until=until,
                          window=self.window)
            return
        self._pending = {
            "frm": frm, "to": to, "batch": self.batch,
            "reason": f"sustained_{canon[frm]['stage']}",
            "window": self.window,
        }
        self.planned += 1
        self.log.note("plan", frm=frm, to=to, batch=self.batch,
                      reason=self._pending["reason"],
                      window=self.window)

    # -- executor feedback (part of the replayed input stream) ---------
    def feedback(self, kind: str, **fields) -> None:
        """Report the executor outcome (``done`` / ``abort``) back into
        the decision stream. An abort re-arms the pair cooldown — the
        policy must not immediately re-plan a move whose target just
        died mid-handoff."""
        self.log.note("result", kind=str(kind), window=self.window,
                      **fields)
        if kind == "abort" and "frm" in fields and "to" in fields:
            self._cooldown[_pair(str(fields["frm"]),
                                 str(fields["to"]))] = (
                self.window + self.cooldown_windows)

    # -- replay (byte-identical determinism proof) ---------------------
    @classmethod
    def replay(cls, inputs, *, hold_windows: int, batch: int,
               cooldown_windows: int) -> bytes:
        """Re-run a fresh policy over the recorded input events
        (``DecisionLog.inputs``) and return its log bytes. Equal to
        the original ``log.dump()`` iff the policy is a pure function
        of its observation stream."""
        p = cls(hold_windows=hold_windows, batch=batch,
                cooldown_windows=cooldown_windows)
        for event, fields in inputs:
            if event == "observe":
                p.observe(json.loads(fields["games"]))
            elif event == "result":
                f = dict(fields)
                kind = f.pop("kind")
                f.pop("window", None)
                p.feedback(kind, **f)
            # plan/commit/cancel/cooldown/no_target are OUTPUTS: the
            # replayed policy must re-derive them
        return p.log.dump()

    # -- reading -------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "window": self.window,
            "hold_windows": self.hold_windows,
            "batch": self.batch,
            "cooldown_windows": self.cooldown_windows,
            "runs": {n: r for n, r in sorted(self._run.items()) if r},
            "pending": dict(self._pending) if self._pending else None,
            "cooldowns": {
                "|".join(pair): until
                for pair, until in sorted(self._cooldown.items())
                if until > self.window
            },
            "planned": self.planned,
            "committed": self.committed,
            "cancelled": self.cancelled,
            "log_lines": list(self.log.lines[-32:]),
        }


def _pair(a: str, b: str) -> tuple[str, str]:
    # sorted pair: the cooldown suppresses the REVERSE move too, or
    # alternating load would ping-pong the same cohort back
    return (a, b) if a <= b else (b, a)
