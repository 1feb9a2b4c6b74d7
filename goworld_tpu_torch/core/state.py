"""Fixed-capacity SoA entity state for one Space, the port of
``goworld_tpu/core/state.py``.

The whole population is a dataclass of tensors with a static capacity
and the JAX package's lane names and types; entity identity on the
device is (slot, generation). Every lane is int32 / float32 / bool as in
JAX (which runs with 64-bit mode off), except three carried differently:

* ``attr_dirty`` is the JAX uint32 bitmask held as the same bits in an
  int32 lane (torch's uint32 lacks the shifts and masks it needs);
* ``rng`` is the threefry key, int64 ``[2]`` holding its two uint32
  words (see :mod:`goworld_tpu_torch.ops.prng`);
* under precision=q16 the Verlet cache's packed ``cand`` words are the
  JAX uint32 words as int32 bits.

Under precision=q16 the carried ``vel`` lane is bfloat16, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.aoi import (
    _ID_BITS,
    ROADMAP_HINT,
    GridSpec,
    VerletCache,
    init_verlet_cache,
)
from goworld_tpu_torch.ops.aoi import check_ported as check_grid_ported
from goworld_tpu_torch.scenarios.spec import (
    assign_behavior_ids,
    assign_watch_radii,
)
from goworld_tpu_torch.utils import consts


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static per-Space configuration, the JAX package's ``WorldConfig``
    field for field. ``scenario`` is a
    :class:`goworld_tpu_torch.scenarios.spec.ScenarioSpec` (a behavior
    mix over a per-entity ``behavior_id`` lane) or None."""

    capacity: int = consts.DEFAULT_CAPACITY
    attr_width: int = 8
    grid: GridSpec = GridSpec(radius=50.0)
    dt: float = 1.0 / consts.TICK_HZ
    npc_speed: float = 5.0
    turn_prob: float = 0.05
    behavior: str = "random_walk"
    enter_cap: int = consts.DEFAULT_EVENT_CAP
    leave_cap: int = consts.DEFAULT_EVENT_CAP
    sync_cap: int = consts.DEFAULT_SYNC_CAP
    attr_sync_cap: int = consts.DEFAULT_EVENT_CAP
    adaptive_extract: bool = True
    input_cap: int = consts.DEFAULT_INPUT_CAP
    scenario: Any = None
    delta_rows_cap: int = 0  # <= 0 means "capacity"

    def __post_init__(self):
        if self.behavior not in ("random_walk", "mlp", "btree"):
            raise ValueError(
                f"behavior must be random_walk|mlp|btree, "
                f"got {self.behavior!r}"
            )

    @property
    def delta_rows_cap_eff(self) -> int:
        """``delta_rows_cap`` resolved: <= 0 tracks ``capacity``."""
        return self.delta_rows_cap if self.delta_rows_cap > 0 \
            else self.capacity

    @property
    def bounds_min(self) -> tuple[float, float, float]:
        g = self.grid
        return (g.origin_x, -1e9, g.origin_z)

    @property
    def bounds_max(self) -> tuple[float, float, float]:
        g = self.grid
        return (g.origin_x + g.extent_x, 1e9, g.origin_z + g.extent_z)


def has_behaviors(cfg: WorldConfig) -> bool:
    """True when the config runs more than the random walk: the btree or
    mlp behavior, or a scenario mix."""
    return cfg.behavior != "random_walk" or cfg.scenario is not None


def check_ported(cfg: WorldConfig) -> None:
    """Raise ``NotImplementedError`` for a config this port does not run
    yet (see ROADMAP.md Queue A); it never substitutes another path."""
    if cfg.grid.precision != "off" and (
            cfg.behavior == "mlp" or (cfg.scenario is not None
                                      and cfg.scenario.needs_policy)):
        raise NotImplementedError(
            f"precision='q16' with the mlp policy {ROADMAP_HINT}")
    check_grid_ported(cfg.grid)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card
    present raises: the entry points never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "goworld_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class SpaceState:
    """One Space's population as SoA tensors on one device."""

    pos: torch.Tensor          # f32[N, 3]
    yaw: torch.Tensor          # f32[N]
    vel: torch.Tensor          # f32[N, 3]
    alive: torch.Tensor        # bool[N]
    npc_moving: torch.Tensor   # bool[N]
    has_client: torch.Tensor   # bool[N]
    client_gate: torch.Tensor  # i32[N]   owning gate id (-1 none)
    type_id: torch.Tensor      # i32[N]
    gen: torch.Tensor          # i32[N]   slot generation
    hot_attrs: torch.Tensor    # f32[N, A]
    attr_dirty: torch.Tensor   # i32[N]   bitmask over attr columns
    nbr: torch.Tensor          # i32[N, k] sorted AOI neighbors (sentinel N)
    nbr_cnt: torch.Tensor      # i32[N]
    nbr_client_cnt: torch.Tensor  # i32[N]
    nbr_mean_off: torch.Tensor    # f32[N, 3]
    aoi_radius: torch.Tensor   # f32[N] 0 = no AOI, +inf = space radius
    dirty: torch.Tensor        # bool[N]  moved this tick
    rng: torch.Tensor          # int64[2] threefry key words
    tick: torch.Tensor         # i32 0-d
    # the Verlet AOI cache; None when the grid has no skin (or n >= 2^21,
    # where the tick keeps the stateless sweep)
    aoi_cache: VerletCache | None = None
    # i32[N] per-entity scenario behavior (an index into
    # cfg.scenario.mix); None without a scenario. It belongs to the slot:
    # a respawn keeps it
    behavior_id: torch.Tensor | None = None

    def replace(self, **changes) -> "SpaceState":
        return dataclasses.replace(self, **changes)

    def apply(self, fn) -> "SpaceState":
        """The state with ``fn`` applied to every tensor lane (the
        cache's lanes included)."""
        return SpaceState(**{f.name: map_lane(getattr(self, f.name), fn)
                             for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.pos.device


def map_lane(value, fn):
    """``fn`` applied to one lane of a state or outputs dataclass: a
    tensor, the Verlet cache (each of its lanes) or None."""
    if value is None:
        return None
    if isinstance(value, VerletCache):
        return value.apply(fn)
    return fn(value)


def create_state(cfg: WorldConfig, seed: int = 0,
                 device="cuda") -> SpaceState:
    """An empty Space of ``cfg.capacity`` slots on ``device`` (the card
    unless the caller asks for the CPU). With a skin it carries an
    invalid Verlet cache (the first tick rebuilds); under precision=q16
    its velocity lane is bfloat16."""
    check_ported(cfg)
    dev = resolve_device(device)
    n, a, k = cfg.capacity, cfg.attr_width, cfg.grid.k
    i32, f32 = torch.int32, torch.float32
    vel_dtype = torch.bfloat16 if cfg.grid.precision != "off" else f32
    scn = cfg.scenario
    if scn is not None:
        # the mix and the watch radii, drawn on the host once
        behavior_id = torch.from_numpy(
            assign_behavior_ids(scn, n, seed)).to(dev)
        aoi_radius = torch.from_numpy(
            assign_watch_radii(scn, n, seed)).to(dev)
    else:
        behavior_id = None
        aoi_radius = torch.full((n,), float("inf"), dtype=f32, device=dev)
    return SpaceState(
        pos=torch.zeros((n, 3), dtype=f32, device=dev),
        yaw=torch.zeros(n, dtype=f32, device=dev),
        vel=torch.zeros((n, 3), dtype=vel_dtype, device=dev),
        alive=torch.zeros(n, dtype=torch.bool, device=dev),
        npc_moving=torch.zeros(n, dtype=torch.bool, device=dev),
        has_client=torch.zeros(n, dtype=torch.bool, device=dev),
        client_gate=torch.full((n,), -1, dtype=i32, device=dev),
        type_id=torch.zeros(n, dtype=i32, device=dev),
        gen=torch.zeros(n, dtype=i32, device=dev),
        hot_attrs=torch.zeros((n, a), dtype=f32, device=dev),
        attr_dirty=torch.zeros(n, dtype=i32, device=dev),
        nbr=torch.full((n, k), n, dtype=i32, device=dev),
        nbr_cnt=torch.zeros(n, dtype=i32, device=dev),
        nbr_client_cnt=torch.zeros(n, dtype=i32, device=dev),
        nbr_mean_off=torch.zeros((n, 3), dtype=f32, device=dev),
        aoi_radius=aoi_radius,
        dirty=torch.zeros(n, dtype=torch.bool, device=dev),
        rng=prng.prng_key(seed, dev),
        tick=torch.zeros((), dtype=i32, device=dev),
        aoi_cache=(init_verlet_cache(cfg.grid, n, dev)
                   if cfg.grid.skin > 0.0 and n < (1 << _ID_BITS)
                   else None),
        behavior_id=behavior_id,
    )


def spawn(
    state: SpaceState,
    slot: int,
    *,
    pos,
    yaw: float = 0.0,
    type_id: int = 0,
    npc_moving: bool = False,
    has_client: bool = False,
    client_gate: int = -1,
    hot_attrs=None,
    aoi_radius: float = float("inf"),
) -> SpaceState:
    """Host-side spawn into a free slot (not on the hot path). Returns a
    new state; the lanes of ``state`` are not modified.

    Free-list contract, as in the JAX package: do not reuse a slot in
    the tick it was despawned, so that the previous occupant's leave
    events fire on the next interest diff."""
    dev = state.device
    f32 = torch.float32

    def put(lane, value, dtype=None):
        out = lane.clone()
        out[slot] = torch.as_tensor(value, dtype=dtype or lane.dtype,
                                    device=dev)
        return out

    if hot_attrs is None:
        hot_attrs = torch.zeros(state.hot_attrs.shape[1], dtype=f32)
    gen = state.gen.clone()
    gen[slot] += 1
    return state.replace(
        pos=put(state.pos, pos, f32),
        yaw=put(state.yaw, yaw),
        vel=put(state.vel, 0.0),
        alive=put(state.alive, True),
        npc_moving=put(state.npc_moving, npc_moving),
        has_client=put(state.has_client, has_client),
        client_gate=put(state.client_gate, client_gate),
        type_id=put(state.type_id, type_id),
        aoi_radius=put(state.aoi_radius, aoi_radius),
        gen=gen,
        dirty=put(state.dirty, True),
        hot_attrs=put(state.hot_attrs, hot_attrs, f32),
        attr_dirty=put(state.attr_dirty, 0),
    )


def despawn(state: SpaceState, slot: int) -> SpaceState:
    """Host-side destroy; returns a new state."""
    def put(lane, value):
        out = lane.clone()
        out[slot] = value
        return out

    return state.replace(
        alive=put(state.alive, False),
        has_client=put(state.has_client, False),
        client_gate=put(state.client_gate, -1),
        npc_moving=put(state.npc_moving, False),
        dirty=put(state.dirty, False),
        attr_dirty=put(state.attr_dirty, 0),
    )
