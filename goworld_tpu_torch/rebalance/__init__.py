"""Self-healing deployment rebalance plane, the port's copy of
``goworld_tpu/rebalance/`` (host only).

A game that holds DEGRADED-or-worse for ``rebalance_hold_windows``
observation windows while a peer has headroom hands a bounded,
space-affine entity cohort to the underloaded game through the
production migration protocol — rate-limited, admission-paused on the
donor space, and rolled back cleanly if the target dies mid-batch
(every unacked entity stays live on the source; the audit ledger's
out-record/seq machinery keeps the deployment conservation verdict
green through the whole move).

Package layout:

- ``policy.py``     — :class:`RebalancePolicy`, the pure replayable
  decision core (hold-run hysteresis, plan→commit cancellation point,
  per-pair cooldown, byte-replayable DecisionLog).
- ``executor.py``   — :class:`HandoffExecutor`, one per game: cohort
  planning, rate-limited sends, ack/abort bookkeeping, metrics and
  the ``rebalance_action`` flight-recorder note.
- ``controller.py`` — :class:`RebalanceController`, the deployment
  loop gluing policy to executors over a pluggable transport.

This module also keeps the process-wide registry the debug-http
``/rebalance`` endpoint serves: every game process registers its
executor agent; a process hosting the controller registers that too.
"""
from __future__ import annotations

from typing import Any

from goworld_tpu_torch.rebalance.controller import (  # noqa: F401
    RebalanceController, scraped_observation)
from goworld_tpu_torch.rebalance.executor import HandoffExecutor  # noqa: F401
from goworld_tpu_torch.rebalance.policy import (  # noqa: F401
    RebalancePolicy, canonical_observation)

__all__ = [
    "RebalancePolicy", "HandoffExecutor", "RebalanceController",
    "canonical_observation", "scraped_observation",
    "register", "unregister", "get", "set_controller",
    "set_handoff_hook", "request_handoff", "snapshot", "reset",
]

# =======================================================================
# process-wide registry (debug-http /rebalance)
# =======================================================================
_agents: dict[str, HandoffExecutor] = {}
_controller: RebalanceController | None = None
# the game process's manual-drain hook (``/rebalance?handoff=N``):
# GameServer binds it to a logic-thread-posted handoff start
_handoff_hook = None


def register(name: str, agent: HandoffExecutor) -> HandoffExecutor:
    _agents[name] = agent
    return agent


def unregister(name: str) -> None:
    _agents.pop(name, None)


def get(name: str) -> HandoffExecutor | None:
    return _agents.get(name)


def set_controller(ctl: RebalanceController | None) -> None:
    global _controller
    _controller = ctl


def set_handoff_hook(fn) -> None:
    """Bind the process's ``/rebalance?handoff=`` action. ``fn`` takes
    ``(target_game_id, batch_or_None)`` and returns a JSON-able
    status; GameServer posts the actual start onto the logic thread
    (the debug-http thread must never touch the world)."""
    global _handoff_hook
    _handoff_hook = fn


def request_handoff(target: int, batch: int | None = None) -> dict:
    """The ``/rebalance?handoff=GAMEID`` poke (debug-http thread)."""
    if _handoff_hook is None:
        return {"error": "no rebalance handoff agent on this process"}
    try:
        return _handoff_hook(int(target), batch)
    except Exception as exc:  # surfaced to the operator, never raised
        return {"error": f"{type(exc).__name__}: {exc}"}


def snapshot() -> dict[str, Any]:
    """debug-http ``/rebalance`` payload."""
    out: dict[str, Any] = {
        "agents": {n: a.snapshot()
                   for n, a in sorted(_agents.items())},
    }
    if _controller is not None:
        out["controller"] = _controller.snapshot()
    return out


def reset() -> None:
    """Test isolation hook (the flightrec convention)."""
    global _controller, _handoff_hook
    _agents.clear()
    _controller = None
    _handoff_hook = None
