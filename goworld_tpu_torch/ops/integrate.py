"""Movement integration and client position-sync application, the port
of ``goworld_tpu/ops/integrate.py``."""

from __future__ import annotations

import numpy as np
import torch

from goworld_tpu_torch.ops.batch import space_base
from goworld_tpu_torch.ops.xla_order import (
    ftz,
    mul32,
    round_ftz,
    round_odd_sum,
)


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

    Every argument may carry a leading Space axis (``pos [S, N, 3]``,
    ``idx [S, IC]``, ``n_inputs [S]``): each Space takes its own
    records, as S separate calls would.

    Returns (pos, yaw, touched bool[N]).

    A slot named by several valid records takes the last of them, as
    the JAX package's scatter does on the CPU. A CUDA ``index_put_``
    writes duplicate indices in no fixed order, so the last record of
    each slot is found first (the highest record index, by an ``amax``
    scatter on the flat index ``s * N + slot``) and only those records
    are written: every slot then gets at most one write.
    """
    n = pos.shape[-2]
    lead = idx.shape[:-1]
    ic = idx.shape[-1]
    dev = pos.device
    rows = yaw.numel()  # N, or S * N
    rec = torch.arange(ic, dtype=torch.int32, device=dev)
    valid = (rec < n_inputs[..., None]) & (idx >= 0) & (idx < n)
    flat = idx + space_base(lead, n, dev) if lead else idx
    # dropped records land in an extra dump row, sliced off below
    safe = torch.where(valid, flat, rows).long()
    last = torch.full((rows + 1,), -1, dtype=torch.int32, device=dev)
    last.scatter_reduce_(0, safe.reshape(-1),
                         torch.where(valid, rec, -1).reshape(-1), "amax")
    won = valid & (last[safe] == rec)
    tgt = torch.where(won, safe, rows)
    pos2 = torch.cat([pos.reshape(rows, 3), pos.new_zeros(1, 3)])
    pos2[tgt] = vals[..., :3]
    yaw2 = torch.cat([yaw.reshape(rows), yaw.new_zeros(1)])
    yaw2[tgt] = vals[..., 3]
    return (pos2[:rows].reshape(pos.shape), yaw2[:rows].reshape(yaw.shape),
            (last[:rows] >= 0).reshape(yaw.shape))


def integrate(
    pos: torch.Tensor,
    vel: torch.Tensor,
    moving: torch.Tensor,
    dt: float,
    bounds_min: tuple[float, float, float],
    bounds_max: tuple[float, float, float],
    fused: torch.Tensor | bool | None = None,
    rounded: bool = False,
):
    """pos += vel*dt for moving entities, clamped to world bounds (one
    Space ``[N, 3]`` or several ``[S, N, 3]``).

    Returns (new_pos, moved bool[N]). The jitted JAX tick contracts
    ``pos + vel*dt`` into one fused multiply-add: the float32 nearest
    the exact ``pos + vel * float32(dt)``. That is computed here in
    float64, where the float32 product is exact, and rounded once (the
    sum rounded to odd, then to float32), so the CPU and the card give
    the JAX bits. Python scalars enter the float32 ops as float32, as
    JAX's weakly typed constants do, and cost no host-to-device
    copy. Subnormal positions and velocities read as zeros, and a
    subnormal result is flushed, as XLA's CPU runtime does
    (:func:`ops.xla_order.ftz`).

    ``fused`` (bool[N]; None for every row, False for none) marks the
    rows the reference contracts; elsewhere the product is rounded to
    float32 before the add. A tick whose behavior fuses its velocity
    select into the integration (the btree and the scenario mixes)
    contracts only the rows that kept their carried velocity
    (``core/step.py``). ``rounded`` also returns, third, the clamped
    positions with no row contracted (the q16 tick's AOI view)."""
    dt32 = float(np.float32(dt))
    pos_d, vel_d = ftz(pos), ftz(vel)
    plain = None
    if fused is not None or rounded:
        plain = ftz(pos_d + torch.where(moving[..., None],
                                        mul32(vel_d, dt32), 0.0))
    if fused is False:
        new_pos = plain
    else:
        step = torch.where(moving[..., None], vel_d.double() * dt32, 0.0)
        new_pos = round_ftz(round_odd_sum(pos_d.double(), step))
        if fused is not None:
            new_pos = torch.where(fused[..., None], new_pos, plain)

    def clamp(p):
        return torch.stack([p[..., i].clamp(bounds_min[i], bounds_max[i])
                            for i in range(3)], dim=-1)

    new_pos = clamp(new_pos)
    moved = ((new_pos - pos).abs() > 1e-7).any(dim=-1)
    if not rounded:
        return new_pos, moved
    return new_pos, moved, clamp(plain)
