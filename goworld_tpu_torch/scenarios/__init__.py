"""Scenario worlds, the port of ``goworld_tpu/scenarios``.

* :mod:`goworld_tpu_torch.scenarios.spec`: the ScenarioSpec registry (a
  copy of the JAX package's, which imports no JAX).
* :mod:`goworld_tpu_torch.scenarios.behaviors`: the per-entity behavior
  members, each computed over all rows and selected by the
  ``behavior_id`` lane.
* :mod:`goworld_tpu_torch.scenarios.runner`: drives a World through a
  spec and gates its interest sets against a brute-force oracle.
"""

from goworld_tpu_torch.scenarios.spec import (  # noqa: F401
    BEHAVIORS,
    LEGACY_BEHAVIORS,
    SCENARIOS,
    ScenarioSpec,
    bench_workloads,
    get_scenario,
    resolve_bench_behavior,
    scenario_names,
)
