"""Stacked per-shard state and the mesh, the port of
``goworld_tpu/parallel/mesh.py``.

The JAX package lays a sharded Space out as one ``SpaceState`` whose
every lane carries a leading ``[n_dev]`` axis, sharded over the mesh's
``"space"`` axis. This port keeps that layout, on one device: lane
``[d]`` of a contiguous stacked tensor is itself contiguous, so the
single-Space ops and kernels take a tile's view as it is.

A mesh (:func:`make_mesh`) names how many shards a World or a step runs
and the card they live on: every shard lives on that one card, so
``make_mesh(8)`` on a host with one card builds the 8-shard path, as
the JAX package builds it on its 8 simulated CPU devices. Shards on
several cards raise ``NotImplementedError`` naming ROADMAP.md.
``shard_map`` has no counterpart: the steps batch the shards or loop
over them (:mod:`goworld_tpu_torch.parallel.step`).

A mesh over several controller processes
(:func:`goworld_tpu_torch.parallel.multihost.global_mesh`) records which
process owns each shard, in process order as ``jax.devices()`` lists
them: rank ``r`` of the group owns shards ``[r * n_local, (r + 1) *
n_local)``, and a state on it holds this rank's shards only (lanes
``[n_local, ...]``, :func:`create_multi_state` with ``shards``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goworld_tpu_torch.core.state import (
    SpaceState,
    WorldConfig,
    create_state,
    resolve_device,
)
from goworld_tpu_torch.ops.aoi import ROADMAP_HINT, VerletCache

SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The port's counterpart of a one-axis ``jax.sharding.Mesh``:
    ``devices`` holds each shard's device (``devices.size`` is the
    shard count, as the World reads it), every one of them ``device``;
    ``process_ids`` the rank owning each shard and ``group`` the
    controller group (:class:`~goworld_tpu_torch.parallel.multihost.
    Group`; None on one controller)."""

    devices: np.ndarray
    device: torch.device
    axis_names: tuple[str, ...] = (SPACE_AXIS,)
    process_ids: np.ndarray | None = None
    group: object = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_controller(self) -> bool:
        return self.group is not None and self.group.size > 1

    @property
    def local_shards(self) -> range:
        """This process's shards (every shard on one controller)."""
        if not self.multi_controller:
            return range(self.size)
        mine = np.flatnonzero(self.process_ids == self.group.rank)
        return range(int(mine[0]), int(mine[-1]) + 1)


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None, group=None) -> Mesh:
    """A mesh of ``n_devices`` shards on ``device`` (the card unless the
    caller asks for the CPU; raises without a card). ``devices`` may
    name the cards: one card (every shard on it) is taken, several
    raise ``NotImplementedError``. ``n_devices`` None means one shard a
    named device, else one shard. ``group`` (a controller group of more
    than one process) spreads the shards over its ranks in process
    order; ``n_devices`` must divide among them."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        cards = list(dict.fromkeys(devices))
        if len(cards) > 1:
            raise NotImplementedError(
                f"a mesh over several cards (devices={cards}) "
                f"{ROADMAP_HINT} item 6")
        device = cards[0]
        if n_devices is None:
            n_devices = len(devices)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh({n_devices}): need at least 1 shard")
    dev = resolve_device(device)
    shards = np.empty(n, dtype=object)
    shards[:] = [dev] * n
    if group is None or group.size == 1:
        return Mesh(devices=shards, device=dev)
    if n % group.size:
        raise ValueError(f"{n} shards do not divide among {group.size} "
                         "controller processes")
    return Mesh(devices=shards, device=dev, group=group,
                process_ids=np.repeat(np.arange(group.size),
                                      n // group.size))


def _stack(values):
    if values[0] is None:
        return None
    if isinstance(values[0], VerletCache):
        return VerletCache(**{
            f.name: torch.stack([getattr(v, f.name) for v in values])
            for f in dataclasses.fields(VerletCache)})
    return torch.stack(values)


def stack_states(states) -> SpaceState:
    """One ``SpaceState`` whose lanes stack ``states`` on a new leading
    axis."""
    return SpaceState(**{
        f.name: _stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(SpaceState)
    })


def tile_view(state: SpaceState, d: int) -> SpaceState:
    """Tile ``d`` of a stacked state: views, no copies."""
    return state.apply(lambda t: t[d])


def create_multi_state(cfg: WorldConfig, n_dev: int, seed: int = 0,
                       device="cuda", shards=None) -> SpaceState:
    """Stacked state: every lane gains a leading [n_dev] axis; tile d is
    ``create_state`` with seed ``seed * n_dev + d``, as in the JAX
    package. ``shards`` (a range of tile indices) stacks those tiles
    only: a controller's part of a global state."""
    return stack_states([create_state(cfg, seed=seed * n_dev + d,
                                      device=device)
                         for d in (range(n_dev) if shards is None
                                   else shards)])


def shard_state(state: SpaceState, mesh: Mesh) -> SpaceState:
    """Place a stacked state on the mesh: every lane on the mesh's card,
    its leading axis one row a shard. On several controllers a global
    state (``mesh.size`` shards) is cut to this rank's shards; a state
    of this rank's shards is taken as it is."""
    local = mesh.local_shards
    n = state.pos.shape[0] if state.pos.dim() == 3 else -1
    if n == mesh.size and len(local) != mesh.size:
        state = state.apply(lambda t: t[local.start:local.stop])
    elif n != len(local):
        raise ValueError(
            f"expected a stacked state of {mesh.size} shards, got pos "
            f"{tuple(state.pos.shape)}")
    return state.apply(lambda t: t.to(mesh.device))
