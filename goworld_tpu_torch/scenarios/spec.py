"""ScenarioSpec, the adversarial-workload registry: a copy of the JAX
package's ``goworld_tpu/scenarios/spec.py`` (which imports no JAX), kept
here so the port imports nothing of that package.

A :class:`ScenarioSpec` names one point of the workload space: a
behavior mix (a heterogeneous population stepped by
:mod:`goworld_tpu_torch.scenarios.behaviors`), a per-entity watch-radius
distribution, a phase schedule (battle-royale shrink, a moving hotspot
attractor, a rotating flock wind) and a host-side respawn churn rate.
The registry and the derived helpers are the JAX package's, value for
value, so both packages draw the same lanes from the same seed.
"""

from __future__ import annotations

import dataclasses

# Mix-member behaviors (scenarios/behaviors.py builds one velocity field
# per member). The first three are the homogeneous behaviors of
# core/step.py compute_velocity, also available as members of a mix.
BEHAVIORS = (
    "random_walk",  # the CI workload's motion (models/random_walk.py)
    "mlp",          # bf16 MLP policy (models/npc_policy.py; needs policy)
    "btree",        # Monster-AI behavior tree (models/behavior_tree.py)
    "hotspot",      # crowd toward a moving attractor (cap-overflow worst
                    # case: cell_cap / aoi_k / Verlet thrash)
    "shrink",       # battle-royale boundary shrink (sustained migration
                    # + density growth per the phase schedule)
    "flock",        # correlated slow motion (the skin's best case)
    "teleport",     # random-walk + teleport churn (breaks the skin's
                    # displacement bound; with churn_rate, stresses slot
                    # reuse + pipeline_decode host-side)
)

# The homogeneous bench workloads (cfg.behavior values).
LEGACY_BEHAVIORS = ("random_walk", "mlp", "btree")

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One adversarial workload (frozen and hashable, like GridSpec).

    ``mix`` is the behavior population: ``((name, fraction), ...)`` with
    fractions summing to 1; entities are assigned a dense per-entity
    behavior lane (``SpaceState.behavior_id`` indexes mix order) and the
    whole population steps in one pass: every member's velocity over
    all rows, each row taking its own member's.

    ``radius_mix`` is the per-entity ``watch_radius`` distribution
    ``((radius, fraction), ...)`` (inf = the space's uniform radius;
    reference EntityTypeDesc.aoiDistance semantics — ops/aoi.py
    ``grid_neighbors`` watch_radius).
    """

    name: str
    mix: tuple = (("random_walk", 1.0),)
    radius_mix: tuple = ((_INF, 1.0),)
    # hotspot: the attractor loops an ellipse inset by ``margin`` of the
    # world extent once every ``attractor_period`` ticks; jitter is a
    # random velocity component as a fraction of npc_speed (0 = pure
    # radial convergence — the provably monotone overflow workload the
    # regression tests pin).
    attractor_period: int = 1800
    attractor_margin: float = 0.25
    hotspot_jitter: float = 0.25
    # shrink: the safe-zone radius interpolates from the half-extent to
    # ``shrink_min_frac`` of it over ``shrink_over`` ticks (then holds).
    # Outside entities migrate inward at full speed; inside entities
    # wander at reduced speed.
    shrink_over: int = 600
    shrink_min_frac: float = 0.08
    # flock: velocity blends a slowly rotating global wind direction
    # (period ``flock_wind_period`` ticks) with cohesion along the mean
    # neighbor offset; speed is ``flock_speed_frac * npc_speed`` so
    # per-tick displacement stays far under skin/2 (the reuse best case).
    flock_coherence: float = 0.5
    flock_wind_period: int = 2400
    flock_speed_frac: float = 0.35
    # teleport: per entity per tick, jump to a uniform random world
    # position with this probability (displacement >> skin/2: must trip
    # the in-graph rebuild cond on exactly that tick).
    teleport_prob: float = 0.01
    # host-side respawn churn (scenarios/runner.py): this fraction of
    # the live population is destroyed and recreated every tick —
    # exercising slot reuse, the one-tick free-slot quarantine and
    # pipeline_decode. Device-only runs (bench scans) ignore it.
    churn_rate: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("ScenarioSpec.name must be non-empty")
        if not self.mix:
            raise ValueError("ScenarioSpec.mix must name >= 1 behavior")
        for m in self.mix:
            if not (isinstance(m, tuple) and len(m) == 2):
                raise ValueError(
                    f"mix entries are (behavior, fraction), got {m!r}"
                )
            b, f = m
            if b not in BEHAVIORS:
                # a typo'd member would otherwise silently have no
                # kernel to dispatch to (GridSpec.__post_init__ style)
                raise ValueError(
                    f"mix behavior must be one of {'|'.join(BEHAVIORS)}, "
                    f"got {b!r}"
                )
            if not (0.0 < f <= 1.0):
                raise ValueError(
                    f"mix fraction for {b!r} must be in (0, 1], got {f!r}"
                )
        tot = sum(f for _, f in self.mix)
        if abs(tot - 1.0) > 1e-6:
            raise ValueError(
                f"mix fractions must sum to 1, got {tot!r} "
                f"({self.mix!r})"
            )
        if not self.radius_mix:
            raise ValueError("radius_mix must name >= 1 radius class")
        for m in self.radius_mix:
            if not (isinstance(m, tuple) and len(m) == 2):
                raise ValueError(
                    f"radius_mix entries are (radius, fraction), got {m!r}"
                )
            r, f = m
            if not (r > 0.0):
                raise ValueError(
                    "radius_mix radii must be > 0 (0 would exclude the "
                    f"class from AOI entirely), got {r!r}"
                )
            if not (0.0 < f <= 1.0):
                raise ValueError(
                    f"radius_mix fraction must be in (0, 1], got {f!r}"
                )
        rtot = sum(f for _, f in self.radius_mix)
        if abs(rtot - 1.0) > 1e-6:
            raise ValueError(
                f"radius_mix fractions must sum to 1, got {rtot!r}"
            )
        if not (0.0 <= self.teleport_prob <= 1.0):
            raise ValueError(
                f"teleport_prob must be in [0, 1], got {self.teleport_prob!r}"
            )
        if not (0.0 <= self.churn_rate < 1.0):
            raise ValueError(
                f"churn_rate must be in [0, 1), got {self.churn_rate!r}"
            )
        for fld in ("attractor_period", "shrink_over", "flock_wind_period"):
            if getattr(self, fld) < 1:
                raise ValueError(f"{fld} must be >= 1 tick")
        if not (0.0 < self.shrink_min_frac < 1.0):
            raise ValueError(
                f"shrink_min_frac must be in (0, 1), "
                f"got {self.shrink_min_frac!r}"
            )
        if not (0.0 <= self.attractor_margin <= 0.5):
            raise ValueError(
                f"attractor_margin must be in [0, 0.5], "
                f"got {self.attractor_margin!r}"
            )

    # -- derived ---------------------------------------------------------
    @property
    def behavior_names(self) -> tuple:
        return tuple(b for b, _ in self.mix)

    @property
    def needs_policy(self) -> bool:
        """True when the mix includes the MLP member (the caller must
        pass an MLPPolicy into the tick, like cfg.behavior == 'mlp')."""
        return "mlp" in self.behavior_names

    @property
    def needs_features(self) -> bool:
        """True when any mix member reads neighbor features (mean
        offset / client lanes) — the megaspace step uses this to keep
        computing its summary features for the next tick."""
        return any(b in ("flock", "btree", "mlp")
                   for b in self.behavior_names)

    @property
    def uniform_radius(self) -> bool:
        return self.radius_mix == ((_INF, 1.0),)


def _largest_remainder(fracs, n: int):
    """Exact-N proportional allocation (so a 1.0 fraction is ALL slots
    and tiny fractions still land at small test N)."""
    raw = [f * n for f in fracs]
    counts = [int(x) for x in raw]
    rem = n - sum(counts)
    order = sorted(range(len(raw)), key=lambda i: raw[i] - counts[i],
                   reverse=True)
    for i in range(rem):
        counts[order[i % len(order)]] += 1
    return counts


def assign_behavior_ids(spec: ScenarioSpec, n: int, seed: int = 0):
    """i32[n] dense mix-order behavior lanes, deterministically shuffled
    (slot order must not correlate with behavior — spawn order is slot
    order in bench worlds). numpy, host-side: runs once at state init."""
    import numpy as np

    counts = _largest_remainder([f for _, f in spec.mix], n)
    ids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    rng = np.random.default_rng(0x5CE0 ^ seed)
    return rng.permutation(ids)


def assign_watch_radii(spec: ScenarioSpec, n: int, seed: int = 0):
    """f32[n] per-entity watch radii drawn from ``radius_mix`` (inf =
    space default; reference EntityTypeDesc.aoiDistance)."""
    import numpy as np

    counts = _largest_remainder([f for _, f in spec.radius_mix], n)
    radii = np.concatenate([
        np.full(c, r, np.float32)
        for (r, _), c in zip(spec.radius_mix, counts)
    ])
    rng = np.random.default_rng(0x4Ad1 ^ seed)
    return rng.permutation(radii)


# ======================================================================
# registry
# ======================================================================

SCENARIOS: dict = {}


def _register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {spec.name!r}")
    SCENARIOS[spec.name] = spec
    return spec


# The named worst/best cases ROADMAP item 3 calls for. hotspot and
# shrink are the bench-stamped worst cases (cap overflow / sustained
# migration); flock is the skin's best case; teleport is the rebuild-
# cond + slot-reuse stress; mixed_radius exercises the per-entity
# watch_radius lanes; mixed proves the single-switch heterogeneous trace.
_register(ScenarioSpec(name="hotspot", mix=(("hotspot", 1.0),)))
_register(ScenarioSpec(name="shrink", mix=(("shrink", 1.0),)))
_register(ScenarioSpec(name="flock", mix=(("flock", 1.0),)))
_register(ScenarioSpec(
    name="teleport",
    mix=(("teleport", 1.0),),
    teleport_prob=0.01,
    churn_rate=0.01,
))
_register(ScenarioSpec(
    name="mixed_radius",
    # snipers (wide view) vs melee (short view) over plain motion
    mix=(("random_walk", 1.0),),
    radius_mix=((12.0, 0.4), (30.0, 0.4), (_INF, 0.2)),
))
_register(ScenarioSpec(
    name="mixed",
    # >= 3 behaviors in ONE world
    mix=(("hotspot", 0.25), ("flock", 0.35), ("teleport", 0.15),
         ("random_walk", 0.25)),
    radius_mix=((25.0, 0.5), (_INF, 0.5)),
    teleport_prob=0.02,
))


def scenario_names() -> tuple:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: "
            f"{'|'.join(SCENARIOS)}"
        ) from None


# ======================================================================
# bench workload resolution
# ======================================================================

def bench_workloads() -> tuple:
    """Every value BENCH_BEHAVIOR accepts: the legacy homogeneous
    behaviors plus every registered scenario (new scenarios are
    bench-selectable for free)."""
    return LEGACY_BEHAVIORS + scenario_names()


def resolve_bench_behavior(name: str):
    """Map a BENCH_BEHAVIOR value to ``(cfg_behavior, scenario_or_None)``.

    Raises ValueError with the ONE canonical message when the name is in
    neither the legacy set nor the scenario registry."""
    if name in LEGACY_BEHAVIORS:
        return name, None
    if name in SCENARIOS:
        return "random_walk", SCENARIOS[name]
    raise ValueError(
        f"BENCH_BEHAVIOR must be one of {'|'.join(bench_workloads())} "
        f"(legacy behaviors + the scenario registry, "
        f"goworld_tpu/scenarios/spec.py), got {name!r}"
    )
