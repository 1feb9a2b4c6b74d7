"""The multi-space tick, the port of ``goworld_tpu/parallel/step.py``.

Each shard runs the single-Space tick on its own lanes, then all shards
exchange migrating entities (JAX's ``all_to_all``) and reduce the
global alive count (JAX's ``psum``): the compiled equivalent of the
reference's game processes plus the dispatcher hop between them.

Every shard lives on one card (:mod:`goworld_tpu_torch.parallel.mesh`),
in the JAX layout: a leading ``[n_dev]`` axis on every lane. Without a
skin the shards tick as one batched ``[n_dev, ...]`` step
(:func:`goworld_tpu_torch.core.step.tick_body`: one sweep launch and one
sort launch for all shards); with a skin each shard keeps its own
Verlet cache and rebuild gate, and the shards tick one after another.
The all_to_all is a transpose of the stacked send buffers, as in the
megaspace, and the psum a sum.

Host contract per tick:
  inputs: per-shard TickInputs (client pos syncs routed by the host to
  the owning shard) + per-slot migration requests (target shard, host
  tag), the staged form of ``EnterSpace`` (``Entity.go:956-973``).
  outputs: per-shard TickOutputs + arrival records (tag -> new slot)
  the host uses to re-point EntityID -> (space, slot), where the
  reference's dispatcher rewrites its entityDispatchInfos table
  (``DispatcherService.go:877-891``).
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import (
    SpaceState,
    WorldConfig,
    resolve_device,
)
from goworld_tpu_torch.core.step import TickInputs, TickOutputs, tick_body
from goworld_tpu_torch.parallel import migrate as mig
from goworld_tpu_torch.parallel.mesh import stack_states, tile_view
from goworld_tpu_torch.utils.fpenv import flushed


@dataclasses.dataclass(frozen=True)
class MultiTickInputs:
    base: TickInputs              # lanes [n_dev, ...]
    migrate_target: torch.Tensor  # i32[n_dev, N]: dest shard or -1
    migrate_tag: torch.Tensor     # i32[n_dev, N]: host tag for remapping

    @staticmethod
    def empty(cfg: WorldConfig, n_dev: int,
              device="cuda") -> "MultiTickInputs":
        dev = resolve_device(device)
        one = TickInputs.empty(cfg, device=dev)
        base = TickInputs(**{
            f.name: getattr(one, f.name).expand(
                (n_dev,) + getattr(one, f.name).shape).contiguous()
            for f in dataclasses.fields(TickInputs)
        })
        return MultiTickInputs(
            base=base,
            migrate_target=torch.full((n_dev, cfg.capacity), -1,
                                      dtype=torch.int32, device=dev),
            migrate_tag=torch.full((n_dev, cfg.capacity), -1,
                                   dtype=torch.int32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class MultiTickOutputs:
    base: TickOutputs             # lanes [n_dev, ...]
    arr_tag: torch.Tensor         # i32[n_dev, n_dev*cap]
    arr_slot: torch.Tensor        # i32[n_dev, n_dev*cap]
    arr_n: torch.Tensor           # i32[n_dev]
    migrate_dropped: torch.Tensor  # i32[n_dev] arrivals lost to full shards
    migrate_demand: torch.Tensor  # i32[n_dev, n_dev] true per-dest emigrants
    global_alive: torch.Tensor    # i32[n_dev] (the same on every shard)


def _needs_policy(cfg: WorldConfig) -> bool:
    return cfg.behavior == "mlp" or (
        cfg.scenario is not None and cfg.scenario.needs_policy)


def batched_shards(cfg: WorldConfig) -> bool:
    """Whether the shards tick as one batched step. The skin keeps a
    cache and a rebuild gate a shard, so a skin ticks them one after
    another. So do policy dots over 50 rows or fewer a shard: the
    batched step sums the policy's dots over all ``n_dev * N`` rows in
    one dot, and XLA's CPU order for the reference's ``N`` rows a shard
    is the same only past 50 rows
    (:func:`goworld_tpu_torch.ops.xla_order.dot_lanes`)."""
    if cfg.grid.skin > 0.0:
        return False
    return not _needs_policy(cfg) or cfg.capacity > 50


def _stack_outputs(outs) -> TickOutputs:
    return TickOutputs(**{
        f.name: None if getattr(outs[0], f.name) is None
        else torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(TickOutputs)
    })


def multi_tick_body(cfg: WorldConfig, n_dev: int, migrate_cap: int,
                    state: SpaceState, inputs: MultiTickInputs,
                    policy=None):
    """One multi-space tick over stacked shards. Returns a new state
    and the outputs; the lanes of ``state`` are not modified. See
    :func:`make_multi_tick`."""
    n = cfg.capacity
    if batched_shards(cfg):
        state, outs = tick_body(cfg, state, inputs.base, policy)
        shards = [tile_view(state, d) for d in range(n_dev)]
    else:
        shards, per = [], []
        for d in range(n_dev):
            st, out = tick_body(
                cfg, tile_view(state, d),
                TickInputs(**{f.name: getattr(inputs.base, f.name)[d]
                              for f in dataclasses.fields(TickInputs)}),
                policy)
            shards.append(st)
            per.append(out)
        outs = _stack_outputs(per)

    # migration: pack -> all_to_all (a transpose) -> insert
    departed, sends = [], []
    for d in range(n_dev):
        fbuf, ibuf, gone, demand = mig.pack_emigrants(
            shards[d], inputs.migrate_target[d], inputs.migrate_tag[d],
            n_dev, migrate_cap)
        shards[d] = mig.despawn_departed(shards[d], gone)
        departed.append(gone)
        sends.append((fbuf, ibuf, demand))
    recv_f = torch.stack([s[0] for s in sends]).transpose(0, 1)
    recv_i = torch.stack([s[1] for s in sends]).transpose(0, 1)
    arrivals = []
    for d in range(n_dev):
        shards[d], *arr = mig.insert_arrivals(
            shards[d], recv_f[d], recv_i[d], nbr_sentinel=n,
            quarantine=departed[d])
        arrivals.append(arr)

    new_state = stack_states(shards)
    # the psum: every shard reads the mesh's total
    global_alive = new_state.alive.sum(dtype=torch.int32).repeat(n_dev)
    outputs = MultiTickOutputs(
        base=outs,
        arr_tag=torch.stack([a[0] for a in arrivals]),
        arr_slot=torch.stack([a[1] for a in arrivals]),
        arr_n=torch.stack([a[2] for a in arrivals]),
        migrate_dropped=torch.stack([a[3] for a in arrivals]),
        migrate_demand=torch.stack([s[2] for s in sends]),
        global_alive=global_alive,
    )
    return new_state, outputs


def make_multi_tick(cfg: WorldConfig, mesh, migrate_cap: int = 256):
    """Build the multi-space step over ``mesh``
    (:func:`goworld_tpu_torch.parallel.mesh.make_mesh`), on the mesh's
    card.

    Returns ``step(states, inputs, policy=None) -> (states, outputs)``
    where every lane carries a leading [n_dev] axis. The step returns
    new tensors (the JAX package's ``donate`` has no counterpart here;
    the World copies the new carry into the old one's storage)."""
    n_dev = mesh.devices.size
    dev = mesh.device

    def step(state: SpaceState, inputs: MultiTickInputs, policy=None):
        if state.device.type != dev.type:
            raise ValueError(
                f"state lives on {state.device}, the step on {dev}")
        if state.pos.dim() != 3 or state.pos.shape[0] != n_dev:
            raise ValueError(
                f"expected a stacked state of {n_dev} shards, got pos "
                f"{tuple(state.pos.shape)}")
        with flushed(dev):
            return multi_tick_body(cfg, n_dev, migrate_cap, state,
                                   inputs, policy)

    return step
