"""Movement integration and client position-sync application, the port
of ``goworld_tpu/ops/integrate.py``."""

from __future__ import annotations

import torch


def apply_pos_inputs(
    pos: torch.Tensor,
    yaw: torch.Tensor,
    idx: torch.Tensor,
    vals: torch.Tensor,
    n_inputs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter client position syncs into the SoA.

    Args:
      pos: f32[N,3]; yaw: f32[N].
      idx: int32[IC] target slots (entries >= n_inputs, < 0 or >= N are
        dropped, never clamped onto an unrelated slot).
      vals: f32[IC,4] (x, y, z, yaw).
      n_inputs: int32 0-d tensor, number of valid records.

    Returns (pos, yaw, touched bool[N]).

    The valid slots of one batch must be unique. The JAX package's
    scatter keeps the last of duplicate writes on the CPU, while a CUDA
    ``index_put_`` writes duplicates in no fixed order; the host batches
    at most one record per entity per tick.
    """
    n = pos.shape[0]
    ic = idx.shape[0]
    dev = pos.device
    valid = (
        (torch.arange(ic, dtype=torch.int32, device=dev) < n_inputs)
        & (idx >= 0) & (idx < n)
    )
    # dropped records land in an extra dump row, sliced off below
    safe = torch.where(valid, idx, n).long()
    pos2 = torch.cat([pos, pos.new_zeros(1, 3)])
    pos2[safe] = vals[:, :3]
    yaw2 = torch.cat([yaw, yaw.new_zeros(1)])
    yaw2[safe] = vals[:, 3]
    touched = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    touched[safe] = valid
    return pos2[:n], yaw2[:n], touched[:n]


def integrate(
    pos: torch.Tensor,
    vel: torch.Tensor,
    moving: torch.Tensor,
    dt: float,
    bounds_min: tuple[float, float, float],
    bounds_max: tuple[float, float, float],
) -> tuple[torch.Tensor, torch.Tensor]:
    """pos += vel*dt for moving entities, clamped to world bounds.

    Returns (new_pos, moved bool[N]). Python scalars enter the float32
    ops as float32, as JAX's weakly typed constants do, and cost no
    host-to-device copy."""
    step = torch.where(moving[:, None], vel * dt, 0.0)
    new_pos = pos + step
    new_pos = torch.stack(
        [new_pos[:, i].clamp(bounds_min[i], bounds_max[i])
         for i in range(3)], dim=1)
    moved = ((new_pos - pos).abs() > 1e-7).any(dim=1)
    return new_pos, moved
