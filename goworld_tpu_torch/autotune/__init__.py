"""Online kernel autotuning, the port of ``goworld_tpu/autotune/``.

* :mod:`goworld_tpu_torch.autotune.policy` — the decisions: a pure
  function of the workload-signature stream picks a kernel-config
  candidate with hysteresis and a deterministic transition log.
* :mod:`goworld_tpu_torch.autotune.warmset` — candidate steps built and
  run once off the tick thread, so a swap never builds or first-launches
  a kernel mid-serving.
* :mod:`goworld_tpu_torch.autotune.governor` — the
  :class:`KernelGovernor` that wires both to a live
  :class:`~goworld_tpu_torch.entity.manager.World`: per-window
  decisions, warm-gated commits through ``World.apply_tick_config``,
  the post-swap regret guard, and the process registry.
"""

from goworld_tpu_torch.autotune.governor import (
    KernelGovernor,
    register,
    reset,
    snapshot,
    unregister,
)
from goworld_tpu_torch.autotune.policy import (
    DEFAULT_CANDIDATES,
    GovernorPolicy,
    candidate_overrides,
    classify_signature,
    parse_table,
    seed_table,
)
from goworld_tpu_torch.autotune.warmset import (
    WarmSet,
    candidate_config,
    carry_state,
)

__all__ = [
    "DEFAULT_CANDIDATES", "GovernorPolicy", "candidate_overrides",
    "classify_signature", "parse_table", "seed_table",
    "WarmSet", "candidate_config", "carry_state",
    "KernelGovernor", "register", "unregister", "snapshot", "reset",
]
