"""Random-walk movement model, the port of
``goworld_tpu/models/random_walk.py``: every tick each moving entity
keeps its heading and, with ``turn_prob``, picks a fresh uniform one;
speed is constant. The random bits are the JAX package's (threefry),
so both sides turn the same entities by the same angle."""

from __future__ import annotations

import math

import torch

from goworld_tpu_torch.ops import prng


def random_walk_step(
    key: torch.Tensor,
    vel: torch.Tensor,
    moving: torch.Tensor,
    speed: float,
    turn_prob: float,
) -> torch.Tensor:
    """Return updated velocities f32[N,3] (y velocity stays 0)."""
    n = vel.shape[0]
    k_turn, k_head = prng.split(key)
    turn = prng.uniform(k_turn, (n,)) < turn_prob
    heading = prng.uniform(k_head, (n,), 0.0, 2.0 * math.pi)
    new_vel = torch.stack(
        [torch.cos(heading) * speed, torch.zeros_like(heading),
         torch.sin(heading) * speed],
        dim=1,
    )
    still = vel.abs().sum(dim=1) < 1e-6
    pick_new = (turn | still) & moving
    return torch.where(pick_new[:, None], new_vel, vel)
