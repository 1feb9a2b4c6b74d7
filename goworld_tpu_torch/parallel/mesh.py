"""Stacked per-tile state, the port of ``goworld_tpu/parallel/mesh.py``.

The JAX package lays a sharded Space out as one ``SpaceState`` whose
every lane carries a leading ``[n_dev]`` axis, sharded over the mesh's
``"space"`` axis. This port keeps that layout, on one device: lane
``[d]`` of a contiguous stacked tensor is itself contiguous, so the
single-Space ops and kernels take a tile's view as it is. ``Mesh``,
``shard_map`` and ``shard_state`` have no counterpart on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import SpaceState, WorldConfig, create_state
from goworld_tpu_torch.ops.aoi import VerletCache


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
                       device="cuda") -> SpaceState:
    """Stacked state: every lane gains a leading [n_dev] axis; tile d is
    ``create_state`` with seed ``seed * n_dev + d``, as in the JAX
    package."""
    return stack_states([create_state(cfg, seed=seed * n_dev + d,
                                      device=device)
                         for d in range(n_dev)])
