"""Deployment rebalance controller, the port's copy of
``goworld_tpu/rebalance/controller.py``.

Glues the pure :class:`~goworld_tpu_torch.rebalance.policy.RebalancePolicy`
to per-game :class:`~goworld_tpu_torch.rebalance.executor.HandoffExecutor`
agents: one ``step()`` per observation window feeds the policy the
deployment observation and, when a move commits, opens the handoff on
the donor's executor through a caller-supplied transport. The
controller itself holds no decision state — killing and rebuilding it
over the same observation stream reproduces the same actions (the
policy's DecisionLog is the proof).

Observations come from wherever the caller lives:

- in-process (tests, ``chaos_soak --scenario rebalance``): built
  straight off the worlds' governors and censuses;
- deployment (cli / obs tooling): scraped off each game's debug-http
  ``/overload`` + ``/audit`` planes via :func:`scraped_observation`,
  with kvreg/process presence as the ``present`` bit.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

from goworld_tpu_torch.rebalance.executor import HandoffExecutor
from goworld_tpu_torch.rebalance.policy import RebalancePolicy
from goworld_tpu_torch.utils import log

logger = log.get("rebalance")

__all__ = ["RebalanceController", "scraped_observation"]


def scraped_observation(name: str, overload_snap: Mapping | None,
                        audit_snap: Mapping | None,
                        present: bool = True) -> dict:
    """One game's observation row from its scraped debug-http planes:
    the worst governor state on the process (``/overload``) and the
    ledger's live entity count (``/audit``). A game whose planes did
    not answer is observed ``present=False`` — absent, never hot."""
    stage = "NORMAL"
    if isinstance(overload_snap, Mapping):
        from goworld_tpu_torch.utils.overload import state_rank
        govs = overload_snap.get("governors") or {}
        worst = "NORMAL"
        for g in govs.values():
            st = str((g or {}).get("state", "NORMAL"))
            if state_rank(st) > state_rank(worst):
                worst = st
        stage = worst
    entities = 0
    if isinstance(audit_snap, Mapping):
        entities = int(audit_snap.get("entities", 0))
    return {"name": name, "stage": stage, "entities": entities,
            "present": bool(present)}


class RebalanceController:
    """One deployment's rebalance loop.

    ``agents`` maps game name (``"game1"``) to its executor;
    ``transport`` is called with the committed action and must return
    a ``send`` callable for :meth:`HandoffExecutor.start` (in-process
    harnesses restore into the receiver world and ack; GameServer
    binds the wire path)."""

    def __init__(self, policy: RebalancePolicy,
                 agents: Mapping[str, HandoffExecutor] | None = None,
                 transport: Callable[[dict], Callable] | None = None,
                 rate: int | None = None,
                 timeout_windows: int = 8):
        self.policy = policy
        self.agents: dict[str, HandoffExecutor] = dict(agents or {})
        self.transport = transport
        # per-pump-window send rate (None = whole batch in one window)
        # and the idle-window budget before a stalled handoff aborts —
        # the controller's step() cadence IS the executor's window
        self.rate = rate
        self.timeout_windows = int(timeout_windows)
        self.actions: list[dict] = []

    def step(self, observation: Mapping[str, Mapping[str, Any]]
             ) -> dict | None:
        """One observation window: feed the policy; open the handoff
        on the donor's agent when a move commits. Also pumps every
        busy agent one rate-limited window (the controller's window IS
        the executor's send window)."""
        action = self.policy.observe(observation)
        if action is not None:
            self.actions.append(dict(action))
            self._execute(action)
        for name in sorted(self.agents):
            agent = self.agents[name]
            if agent.busy:
                agent.pump()
            res = agent.take_result()
            if res is not None:
                # terminal this window: the outcome joins the decision
                # stream (an abort re-arms the pair cooldown)
                if res["kind"] == "abort":
                    self.policy.feedback(
                        "abort", cause=res["cause"], frm=name,
                        to=f"game{res['target']}",
                        restored=res["restored"])
                else:
                    self.policy.feedback(
                        "done", frm=name, to=f"game{res['target']}",
                        moved=res["moved"])
        return action

    def _execute(self, action: dict) -> None:
        agent = self.agents.get(action["frm"])
        if agent is None:
            logger.warning("rebalance: no agent for donor %s",
                           action["frm"])
            self.policy.feedback("abort", cause="no_agent",
                                 frm=action["frm"], to=action["to"])
            return
        if agent.busy:
            self.policy.feedback("abort", cause="donor_busy",
                                 frm=action["frm"], to=action["to"])
            return
        send = self.transport(action) if self.transport else None
        if send is None:
            logger.warning("rebalance: no transport %s -> %s",
                           action["frm"], action["to"])
            self.policy.feedback("abort", cause="no_transport",
                                 frm=action["frm"], to=action["to"])
            return
        target_id = _game_num(action["to"])
        n = agent.start(target_id, action["reason"], send,
                        batch=action["batch"], rate=self.rate,
                        timeout_windows=self.timeout_windows)
        if n == 0:
            self.policy.feedback("abort", cause="empty_cohort",
                                 frm=action["frm"], to=action["to"])

    def snapshot(self) -> dict:
        return {
            "policy": self.policy.snapshot(),
            "agents": {n: a.snapshot()
                       for n, a in sorted(self.agents.items())},
            "actions": [dict(a) for a in self.actions[-16:]],
        }


def _game_num(name: str) -> int:
    """``"game3"`` -> 3 (tolerates a bare int string)."""
    digits = "".join(ch for ch in str(name) if ch.isdigit())
    return int(digits) if digits else 0
