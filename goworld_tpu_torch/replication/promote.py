"""Promotion protocol, the port's copy of
``goworld_tpu/replication/promote.py`` (host only): kvreg-arbitrated
single-winner claim + the byte-replayable decision log.

Split-brain model: the dispatcher's kvreg is FIRST-WRITER-WINS
(net/dispatcher.py ``_h_kvreg``: a later non-force register gets the
existing value broadcast back). That alone arbitrates two live
standbys racing for the same promotion — exactly one claim value is
broadcast to everyone. What it cannot do alone is refuse a REPLAYED
stale claim (a delayed/duplicated packet from an earlier promotion
round, or a zombie primary re-asserting itself): if the stale claim
lands FIRST, first-writer-wins would crown it. The epoch guard closes
both orders:

* every claim value carries the promotion EPOCH (one per promotion
  round of that primary, strictly increasing) and the claimant's
  applied frame seq;
* stale-claim-second: the registered winner's epoch >= the replay's
  epoch, so :func:`adjudicate` returns ``lost`` — refused;
* stale-claim-first: the fresh claimant sees a registered winner with
  a LOWER epoch than its own — ``stale_winner`` — and re-registers
  with ``force=True``, which is legitimate exactly and only then (a
  zombie cannot manufacture a higher epoch: epochs come from the
  supervisor's monotonic promotion count, and honest nodes ignore
  winners below the live epoch).

Every arbitration step appends to a :class:`DecisionLog` whose lines
are a pure function of the inputs — replaying the recorded inputs
through fresh logic reproduces the log byte-for-byte (the
chaos/faults plane's seeded-replay convention, utils/faults.py).
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "claim_key", "claim_value", "parse_claim", "adjudicate",
    "DecisionLog", "replay_decisions",
]


def claim_key(primary_gid: int) -> str:
    """The kvreg key a promotion of ``game{primary_gid}`` is decided
    under (one key per primary — all claimants collide on it, which is
    the point)."""
    return f"promote/game{int(primary_gid)}"


def claim_value(standby_gid: int, epoch: int, frame_seq: int) -> str:
    """A claim: who, which promotion round, how caught-up."""
    return f"game{int(standby_gid)}:e{int(epoch)}:s{int(frame_seq)}"


def parse_claim(val: str) -> dict | None:
    """``{"gid", "epoch", "seq"}`` or None for a malformed value (a
    foreign key collision is adjudicated as a loss, never a crash)."""
    try:
        gid_s, e_s, s_s = val.split(":")
        if not (gid_s.startswith("game") and e_s.startswith("e")
                and s_s.startswith("s")):
            return None
        return {"gid": int(gid_s[4:]), "epoch": int(e_s[1:]),
                "seq": int(s_s[1:])}
    except (ValueError, AttributeError):
        return None


def adjudicate(winner_val: str, my_val: str) -> str:
    """Judge the kvreg broadcast for a claim this node registered.

    ``winner_val`` is the value the dispatcher broadcast for the claim
    key (first-writer-wins: ours if we won, the earlier writer's if
    not). Returns:

    * ``"won"``          — our claim is the registered winner: promote.
    * ``"lost"``         — a claim with epoch >= ours won: stand down
      (covers the replayed-stale-claim-second order — the live winner's
      epoch is never below a replay's).
    * ``"stale_winner"`` — the registered winner's epoch is BELOW ours:
      a replayed stale claim (or zombie) landed first; re-register with
      force=True and adjudicate the next broadcast.
    """
    if winner_val == my_val:
        return "won"
    w, m = parse_claim(winner_val), parse_claim(my_val)
    if m is None:
        return "lost"
    if w is None or w["epoch"] < m["epoch"]:
        return "stale_winner"
    return "lost"


class DecisionLog:
    """Canonical promotion decision log. Lines are pure functions of
    the noted (event, fields) inputs — no clocks, no pids — so
    :func:`replay_decisions` over the recorded inputs reproduces the
    log byte-for-byte."""

    def __init__(self):
        self.lines: list[str] = []
        self.inputs: list[tuple[str, dict]] = []

    def note(self, event: str, **fields: Any) -> str:
        self.inputs.append((event, dict(fields)))
        line = event + "".join(
            f" {k}={fields[k]}" for k in sorted(fields))
        self.lines.append(line)
        return line

    def dump(self) -> bytes:
        return ("\n".join(self.lines) + "\n").encode() \
            if self.lines else b""


def replay_decisions(inputs: list[tuple[str, dict]]) -> bytes:
    """Feed recorded decision inputs through a fresh log; byte-equality
    with the original dump is the replayability check the failover
    soak asserts."""
    log = DecisionLog()
    for event, fields in inputs:
        log.note(event, **fields)
    return log.dump()
