"""Threefry-2x32 in plain torch ops, bit-identical to ``jax.random``.

The JAX package's tick splits its carried key every tick and the
random-walk behavior draws two uniforms from it, so a port that is to
agree with it tick for tick needs the same bits. This module copies the
threefry2x32 hash and the ``PRNGKey`` / ``split`` / ``uniform`` recipes
of jax in its ``jax_threefry_partitionable=True`` mode (the default of
the jax this repo pins).

A key is an int64 tensor ``[2]`` holding the two uint32 words, or
``[S, 2]``: one key a Space, each split and drawn from on its own, as
the JAX package's vmapped step does. All
arithmetic runs in int64 masked to 32 bits, because torch's uint32
tensors lack most arithmetic. Everything here is ordinary tensor ops on
the key's device; nothing is a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from goworld_tpu_torch.ops.xla_order import round_odd_sum

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key
    ``(k1, k2)`` (0-d or broadcastable int64 tensors of uint32 values).
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is
    taken as a 32-bit integer, so the key is ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _counter_bits(key: torch.Tensor, size: int):
    """Hash the 64-bit iota ``0..size-1`` (high word 0 below 2^32) under
    each key of ``key [..., 2]``: two ``[..., size]`` words."""
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each key of ``key [..., 2]``:
    int64 ``[..., num, 2]``."""
    b0, b1 = _counter_bits(key, num)
    return torch.stack([b0, b1], dim=-1)


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` of each key of ``key
    [..., 2]``, as int64 values ``[..., *shape]``."""
    size = 1
    for d in shape:
        size *= int(d)
    b0, b1 = _counter_bits(key, size)
    return (b0 ^ b1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` of
    each key of ``key [..., 2]``.

    XLA contracts ``floats * (maxval - minval) + minval`` into one fused
    multiply-add. Torch has no float32 FMA op, so the product is taken
    exactly in float64 (24-bit by 24-bit mantissas fit its 53 bits) and
    the sum rounded once (to odd in float64, then to float32). With
    ``minval == 0`` this is the plain float32 product exactly."""
    bits = random_bits32(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    prod = floats.double() * span
    out = round_odd_sum(prod, torch.full_like(prod, lo)).float()
    return torch.clamp_min(out, lo)
