"""The per-Space tick, the port of ``goworld_tpu/core/step.py``:

apply client inputs -> run behaviors -> integrate movement -> AOI sweep
-> interest deltas -> sync and attr record collection.

All inputs and outputs are fixed-capacity tensors on one device, and the
tick never waits on the host: counts stay 0-d device tensors (true
demand, which may exceed their caps) for the host to read when it wants
them.

Several Spaces tick in one call when every lane of the state and inputs
carries a leading ``[S]`` axis (``parallel.mesh.create_multi_state``):
the port of the JAX World's ``jax.vmap(tick_body)``. Each stage runs once
on the ``[S, ...]`` tensors, each kernel launches once for all Spaces,
and every output is ``[S, ...]`` with each Space's own caps; nothing
loops over Spaces. The skin is not run there (the JAX package clears it
for its vmapped step). The behaviors see the S Spaces' rows in a row
(:func:`flat_spaces`): one policy launch for all ``S * N`` rows, each
Space drawing from its own key.

The behavior and integrate stages flush subnormals as XLA's CPU runtime
does, with explicit ops that run on every device
(:func:`goworld_tpu_torch.ops.xla_order.ftz`); the CPU tick also runs
under :func:`goworld_tpu_torch.utils.fpenv.flushed` for the ops they do
not reach.
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import (
    SpaceState,
    WorldConfig,
    resolve_device,
)
from goworld_tpu_torch.models.behavior_tree import (
    btree_velocity,
    features_from_neighbors,
    features_from_summary,
)
from goworld_tpu_torch.models.npc_policy import (
    build_obs,
    build_obs_from_features,
    policy_accel,
)
from goworld_tpu_torch.models.random_walk import random_walk_step
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.aoi import (
    grid_neighbors_flags,
    grid_neighbors_verlet,
    quantize_positions,
)
from goworld_tpu_torch.ops.batch import space_base
from goworld_tpu_torch.ops.delta import interest_pairs
from goworld_tpu_torch.ops.integrate import apply_pos_inputs, integrate
from goworld_tpu_torch.ops.sync import collect_attr_deltas, collect_sync
from goworld_tpu_torch.ops.xla_order import ftz
from goworld_tpu_torch.scenarios.behaviors import (
    capped_step,
    scenario_velocity,
)
from goworld_tpu_torch.utils.fpenv import flushed


@dataclasses.dataclass(frozen=True)
class TickInputs:
    """Per-tick host->device batch of client position syncs."""

    pos_sync_idx: torch.Tensor   # i32[IC] target slots (last record wins)
    pos_sync_vals: torch.Tensor  # f32[IC, 4] x, y, z, yaw
    pos_sync_n: torch.Tensor     # i32 0-d

    @staticmethod
    def empty(cfg: WorldConfig, device="cuda") -> "TickInputs":
        dev = resolve_device(device)
        ic = cfg.input_cap
        return TickInputs(
            pos_sync_idx=torch.zeros(ic, dtype=torch.int32, device=dev),
            pos_sync_vals=torch.zeros((ic, 4), dtype=torch.float32,
                                      device=dev),
            pos_sync_n=torch.zeros((), dtype=torch.int32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class TickOutputs:
    """Per-tick device->host batch. Counts are true demand and may
    exceed their caps; the host watches them for overflow."""

    enter_w: torch.Tensor    # i32[EC] watcher slots
    enter_j: torch.Tensor    # i32[EC] entered-neighbor slots
    enter_n: torch.Tensor    # i32
    leave_w: torch.Tensor
    leave_j: torch.Tensor
    leave_n: torch.Tensor
    delta_rows_n: torch.Tensor  # i32 rows whose AOI list changed
    sync_w: torch.Tensor     # i32[SC] watcher slots (has_client only)
    sync_j: torch.Tensor     # i32[SC] subject slots
    sync_vals: torch.Tensor  # f32[SC, 4]
    sync_n: torch.Tensor
    attr_e: torch.Tensor     # i32[AC] entity slots
    attr_i: torch.Tensor     # i32[AC] attr column
    attr_v: torch.Tensor     # f32[AC]
    attr_n: torch.Tensor
    alive_count: torch.Tensor  # i32
    # AOI-cap overflow gauges; both zero <=> this tick's sweep was exact
    aoi_demand_max: torch.Tensor
    aoi_over_k_rows: torch.Tensor
    aoi_cell_max: torch.Tensor
    aoi_over_cap_cells: torch.Tensor
    # Verlet skin telemetry: aoi_rebuilt i32 0/1 (1 every tick without a
    # skin: the whole sweep ran); aoi_skin_slack f32 skin/2 minus the max
    # displacement since the last rebuild (0.0 without a skin)
    aoi_rebuilt: torch.Tensor
    aoi_skin_slack: torch.Tensor


def compute_velocity(cfg: WorldConfig, key, pos, yaw, state: SpaceState,
                     policy, world_extent: tuple[float, float],
                     nbr=None, nbr_cnt=None):
    """Per-entity velocity update for ``cfg.behavior`` (shared by the
    single-Space tick and the megaspace's tiles). ``nbr``/``nbr_cnt``
    are one Space's slot neighbor lists for the btree features and the
    mlp observation; None in the megaspace, whose gid lists cannot
    gather positions: the features then come from the summary lanes the
    previous tick's sweep left (``nbr_mean_off``, ``nbr_client_cnt``).

    Returns ``(vel, fused)``: ``fused`` (bool[N], or None for every
    row) marks the rows whose ``pos + vel * dt`` the jitted reference
    contracts into one fused multiply-add (:func:`contracted_rows`).
    The float lanes are read flushed (:func:`ops.xla_order.ftz`); the
    random walk's select keeps the carried velocity's bits."""
    if cfg.behavior == "btree":
        if nbr is None:
            feats = features_from_summary(
                state.nbr_cnt, state.nbr_client_cnt,
                ftz(state.nbr_mean_off))
        else:
            feats = features_from_neighbors(ftz(pos), state.has_client,
                                            nbr, nbr_cnt)
        return btree_velocity(key, feats, state.vel, state.npc_moving,
                              cfg.npc_speed, cfg.turn_prob)
    if cfg.behavior == "mlp":
        if policy is None:
            raise ValueError("behavior='mlp' needs an MLPPolicy")
        pos, vel = ftz(pos), ftz(state.vel)
        if nbr is None:
            obs = build_obs_from_features(
                pos, vel, yaw, state.nbr_cnt, ftz(state.nbr_mean_off),
                cfg.grid.k, world_extent)
        else:
            obs = build_obs(pos, vel, yaw, nbr, nbr_cnt, world_extent)
        vel = capped_step(vel, policy_accel(policy, obs), cfg.dt,
                          cfg.npc_speed)
        return torch.where(state.npc_moving[:, None], vel, 0.0), None
    return random_walk_step(key, state.vel, state.npc_moving,
                            cfg.npc_speed, cfg.turn_prob), None


# The one member of a scenario whose integrate step the reference
# contracts on every row, and the one that contracts the rows keeping
# their carried velocity; every other member, and every mix of several
# members, rounds vel * dt before the add (ROADMAP.md Queue C4)
_CONTRACT_ALL = ("hotspot", "flock", "mlp")


def contracted_rows(cfg: WorldConfig, vel, state: SpaceState, fused):
    """The rows whose ``pos + vel * dt`` the jitted reference contracts
    into one fused multiply-add (None: every row, False: no row). XLA's CPU backend
    contracts a multiply into the add only where LLVM's loop unswitching
    leaves the two in one block with the ``moving`` select folded away,
    so the rows follow the integrate fusion's form, read off its object
    code: ``fused`` from :func:`compute_velocity` without a scenario;
    under a scenario every row for a hotspot, flock or mlp population,
    the rows that kept their carried velocity for a random walk, and no
    row for a shrink, teleport or btree population or a mix of several
    members (its step is a select chain, or a vectorized loop). Under
    precision q16 the btree's loop, reading the bfloat16 carry, keeps
    the moving select beside every add: no row."""
    if cfg.scenario is None:
        if cfg.behavior == "btree" and cfg.grid.precision != "off":
            return False
        return fused
    names = cfg.scenario.behavior_names
    if len(names) == 1 and names[0] in _CONTRACT_ALL:
        return None
    if names == ("random_walk",):
        return ~(vel != state.vel).any(dim=-1)
    return False


def flat_spaces(state: SpaceState, pos, yaw):
    """The behavior stage's view of S Spaces' lanes ``[S, N, ...]``: one
    population of ``S * N`` rows, Space s's row i at ``s * N + i``, its
    neighbor ids moved into its own rows (the sentinel N becomes ``S *
    N``). Returns ``(state, pos, yaw)`` with the lanes the behaviors
    read flattened (``tick`` stays ``[S]``)."""
    s, n = pos.shape[:2]

    def flat(t):
        return None if t is None else t.reshape(s * n, *t.shape[2:])

    base = space_base((s,), n, pos.device)[..., None]
    nbr = torch.where(state.nbr == n, s * n, state.nbr + base)
    fields = ("vel", "alive", "npc_moving", "has_client", "nbr_cnt",
              "nbr_client_cnt", "nbr_mean_off", "behavior_id")
    return (state.replace(nbr=flat(nbr), **{f: flat(getattr(state, f))
                                           for f in fields}),
            flat(pos), flat(yaw))


def tick_body(cfg: WorldConfig, state: SpaceState, inputs: TickInputs,
              policy=None) -> tuple[SpaceState, TickOutputs]:
    """One tick of one Space, or of S Spaces at once when every lane
    carries a leading ``[S]`` axis. Returns a new state and the outputs;
    the lanes of ``state`` are not modified. See :func:`make_tick`."""
    n = cfg.capacity
    if state.pos.shape[-2:] != (n, 3) or state.pos.dim() > 3:
        raise ValueError(f"pos: expected [{n}, 3] or [S, {n}, 3], got "
                         f"{tuple(state.pos.shape)}")
    if state.pos.dim() == 3 and cfg.grid.skin > 0.0:
        raise ValueError(
            "the Verlet skin runs on one Space's lanes: a batched step "
            "runs without it (make the stacked state and the tick with "
            "skin=0, as the World does at n_spaces > 1)")
    # precision=q16: positions integrate in float32, but everything AOI
    # sees (the sweep, the Verlet cache, sync records) is the snapped
    # lattice view, and the carried velocity lane is bfloat16 (read
    # promoted here, stored rounded to nearest even below)
    prec = cfg.grid.precision != "off"
    vel_dtype = state.vel.dtype
    if prec:
        state = state.replace(vel=state.vel.to(torch.float32))

    # 1. client inputs (scatter)
    pos, yaw, touched = apply_pos_inputs(
        state.pos, state.yaw,
        inputs.pos_sync_idx, inputs.pos_sync_vals, inputs.pos_sync_n,
    )

    # 2. behaviors (one key a Space). A scenario steps its mix through
    # one pass over the behavior lane. Several Spaces' rows go through
    # as one population (flat_spaces)
    keys = prng.split(state.rng)
    rng, k_behave = keys[..., 0, :], keys[..., 1, :]
    tele = fused = None
    b_state, b_pos, b_yaw = flat_spaces(state, pos, yaw) \
        if pos.dim() == 3 else (state, pos, yaw)
    if cfg.scenario is not None:
        vel, tele_pos, tele = scenario_velocity(cfg, k_behave, b_pos,
                                                b_yaw, b_state, policy)
        tele_pos, tele = tele_pos.reshape(pos.shape), \
            tele.reshape(pos.shape[:-1])
    else:
        vel, fused = compute_velocity(
            cfg, k_behave, b_pos, b_yaw, b_state, policy,
            (cfg.grid.extent_x, cfg.grid.extent_z),
            nbr=b_state.nbr, nbr_cnt=b_state.nbr_cnt)
        if fused is not None:
            fused = fused.reshape(pos.shape[:-1])
    vel = vel.reshape(pos.shape)

    # 3. integrate + world clamp, pos + vel*dt contracted on the rows
    # the reference contracts
    fused = contracted_rows(cfg, vel, state, fused)
    out = integrate(pos, vel, state.npc_moving, cfg.dt, cfg.bounds_min,
                    cfg.bounds_max, fused=fused,
                    rounded=prec and fused is not False)
    pos, moved = out[:2]
    if tele is not None:
        # teleports override the integrated position before the sweep,
        # so the Verlet gate sees the whole jump on this tick
        pos = torch.where(tele[..., None], tele_pos, pos)
        moved = moved | tele
    if prec:
        # "moved" on the lattice: motion under a lattice step is clean.
        # XLA recomputes the integrate inside each fusion that snaps it
        # (the sweep's lattice, the sync records, the moved test), where
        # the moving select sits between vel * dt and the add, so there
        # no row is contracted; only the stored position keeps the rows
        # contracted_rows names
        # (pos itself where no row is)
        ppos = pos
        if len(out) == 3:
            ppos = out[2]
            if tele is not None:
                ppos = torch.where(tele[..., None], tele_pos, ppos)
        apos = quantize_positions(cfg.grid, ppos)
        aprev = quantize_positions(cfg.grid, state.pos)
        moved = (apos != aprev).any(dim=-1)
    else:
        apos = pos
    # state.dirty carries host-set pending force-syncs (spawn), consumed
    # here and cleared below
    dirty = (moved | touched | state.dirty) & state.alive

    # 4. AOI sweep; the dirty and has_client bits ride the packed words.
    # With a skin, the carried cache is reused while it holds
    flag_bits = dirty.to(torch.int32) \
        | (state.has_client.to(torch.int32) << 1)
    dev = pos.device
    if cfg.grid.skin > 0.0 and state.aoi_cache is not None:
        (nbr, nbr_cnt, nbr_fl, aoi_stats, aoi_cache, aoi_rebuilt,
         aoi_slack) = grid_neighbors_verlet(
            cfg.grid, apos, state.alive, state.aoi_cache,
            watch_radius=state.aoi_radius, flag_bits=flag_bits,
            with_stats=True,
        )
    else:
        nbr, nbr_cnt, nbr_fl, aoi_stats = grid_neighbors_flags(
            cfg.grid, apos, state.alive, watch_radius=state.aoi_radius,
            flag_bits=flag_bits, with_stats=True,
        )
        aoi_cache = state.aoi_cache
        lead = state.tick.shape
        aoi_rebuilt = torch.ones(lead, dtype=torch.int32, device=dev)
        aoi_slack = torch.zeros(lead, dtype=torch.float32, device=dev)

    # 5. interest deltas -> bounded enter/leave pair lists
    (enter_w, enter_j, enter_n, leave_w, leave_j, leave_n,
     delta_rows_n) = interest_pairs(
        state.nbr, nbr, n, cfg.enter_cap, cfg.leave_cap,
        min(cfg.delta_rows_cap_eff, n), adaptive=cfg.adaptive_extract,
    )

    # 6. position sync records (the snapped positions under q16), then
    # hot-attr deltas
    sync_w, sync_j, sync_vals, sync_n = collect_sync(
        nbr, dirty, state.has_client, apos, yaw, cfg.sync_cap,
        nbr_dirty=(nbr_fl & 1).bool(), adaptive=cfg.adaptive_extract,
    )
    attr_e, attr_i, attr_v, attr_n = collect_attr_deltas(
        state.hot_attrs, state.attr_dirty, cfg.attr_sync_cap,
        adaptive=cfg.adaptive_extract,
    )

    new_state = state.replace(
        pos=pos,
        yaw=yaw,
        vel=vel.to(vel_dtype),
        nbr=nbr,
        nbr_cnt=nbr_cnt,
        nbr_client_cnt=((nbr_fl >> 1) & 1).sum(dim=-1, dtype=torch.int32),
        dirty=torch.zeros_like(state.dirty),
        attr_dirty=torch.zeros_like(state.attr_dirty),
        rng=rng,
        tick=state.tick + 1,
        aoi_cache=aoi_cache,
    )
    outputs = TickOutputs(
        enter_w=enter_w, enter_j=enter_j, enter_n=enter_n,
        leave_w=leave_w, leave_j=leave_j, leave_n=leave_n,
        delta_rows_n=delta_rows_n,
        sync_w=sync_w, sync_j=sync_j, sync_vals=sync_vals, sync_n=sync_n,
        attr_e=attr_e, attr_i=attr_i, attr_v=attr_v, attr_n=attr_n,
        alive_count=state.alive.sum(-1, dtype=torch.int32),
        aoi_demand_max=aoi_stats[0], aoi_over_k_rows=aoi_stats[1],
        aoi_cell_max=aoi_stats[2], aoi_over_cap_cells=aoi_stats[3],
        aoi_rebuilt=aoi_rebuilt, aoi_skin_slack=aoi_slack,
    )
    return new_state, outputs


def make_tick(cfg: WorldConfig, device="cuda"):
    """Build the tick function for a WorldConfig on ``device`` (the card
    unless the caller asks for the CPU).

    Returns ``tick(state, inputs, policy=None) -> (state, outputs)``;
    ``policy`` is an ``MLPPolicy`` (``models.npc_policy``) when
    ``cfg.behavior == 'mlp'`` or the scenario's mix has the mlp member.
    The tick takes one Space's lanes or S Spaces' stacked ``[S, ...]``
    lanes (with ``skin=0``), and its outputs have the same leading axis.
    """
    dev = resolve_device(device)

    def tick(state: SpaceState, inputs: TickInputs, policy=None):
        if state.device.type != dev.type:
            raise ValueError(
                f"state lives on {state.device}, the tick on {dev}")
        with flushed(dev):
            return tick_body(cfg, state, inputs, policy)

    return tick
