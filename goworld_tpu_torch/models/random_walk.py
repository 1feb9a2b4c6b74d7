"""Random-walk movement model, the port of
``goworld_tpu/models/random_walk.py``: every tick each moving entity
keeps its heading and, with ``turn_prob``, picks a fresh uniform one;
speed is constant. The random bits are the JAX package's (threefry),
so both sides turn the same entities by the same angle, and the
heading's cosine and sine are the JAX package's bits too
(:func:`cos_sin`)."""

from __future__ import annotations

import math

import torch

from goworld_tpu_torch.ops import prng

# XLA's CPU backend lowers float32 cos and sin to calls of the C
# library's cosf and sinf. glibc's (sysdeps/ieee754/flt-32/s_sinf.c,
# s_cosf.c, sincosf.h) work in double: a reduction by pi/2 and two short
# polynomials, rounded to float once. Its constants:
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")   # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p0")         # pi/2
# pi/2 split into 26 high bits and the rest (Veltkamp), so that n * pi/2
# is p + err exactly for the quadrant n (p rounded, err its error)
_HPI_HI = 134217729.0 * _HPI - (134217729.0 * _HPI - _HPI)
_HPI_LO = _HPI - _HPI_HI
_C = tuple(float.fromhex(h) for h in (               # cosine polynomial
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (               # sine polynomial
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def cos_sin(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos(h), sin(h))`` with the bits of the JAX package's
    ``jnp.cos``/``jnp.sin`` on the CPU, for finite ``0 <= h < 120``.

    glibc's routine in separate float64 torch ops, which round every
    step and never contract, so the CPU and the card agree. glibc runs
    it with fused multiply-adds where the CPU has them. The reduction's
    ``x - n * pi/2`` cancels, so its single rounding is emulated
    exactly (``n * pi/2`` as a rounded product and its exact error,
    then two exact-or-final subtractions). The polynomials' multiply-
    adds move a double by an ulp at most; the float32 result is the
    same for every heading ``random_walk_step`` can draw (all 2^23 of
    them) and for 2^22 floats in [0, 100) (``tests/test_torch_ops.py``).
    Below 2^-12 glibc returns 1 and ``h`` outright; the polynomials
    round to the same floats there.
    """
    x = h.double()
    # quadrant: round(x * 2/pi), by a scaled truncation as glibc does
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.double()
    p = nd * _HPI
    err = (nd * _HPI_HI - p) + nd * _HPI_LO   # p + err == n * pi/2
    # x - p is exact (x is within a factor 2 of p, or n == 0), so r is
    # x - n * pi/2 rounded once, as glibc's fused multiply-add gives it
    r = (x - p) - err                  # |r| <= pi/4
    r2 = r * r
    r3 = r * r2
    sin_p = (r + r3 * _S[0]) + (r3 * r2) * (_S[1] + r2 * _S[2])
    r4 = r2 * r2
    cos_p = ((_C[0] + r2 * _C[1]) + r4 * _C[2]) \
        + (r4 * r2) * (_C[3] + r2 * _C[4])
    odd = (n & 1) == 1
    neg_sin = (n & 2) != 0              # sin < 0 in quadrants 2 and 3
    neg_cos = ((n + 1) & 2) != 0        # cos < 0 in quadrants 1 and 2
    s = torch.where(odd, cos_p, sin_p)
    c = torch.where(odd, sin_p, cos_p)
    s = torch.where(neg_sin, -s, s)
    c = torch.where(neg_cos, -c, c)
    return c.to(torch.float32), s.to(torch.float32)


def random_walk_step(
    key: torch.Tensor,
    vel: torch.Tensor,
    moving: torch.Tensor,
    speed: float,
    turn_prob: float,
    with_pick: bool = False,
):
    """Return updated velocities f32[N,3] (y velocity stays 0). With a
    leading Space axis (``key [S, 2]``, ``vel [S, N, 3]``, ``moving [S,
    N]``) each Space draws from its own key: the bits of S separate
    calls. ``with_pick`` also returns the rows that drew a new heading
    (a turn, or a standing row; moving rows only)."""
    n = vel.shape[-2]
    keys = prng.split(key)
    k_turn, k_head = keys[..., 0, :], keys[..., 1, :]
    turn = prng.uniform(k_turn, (n,)) < turn_prob
    heading = prng.uniform(k_head, (n,), 0.0, 2.0 * math.pi)
    cos_h, sin_h = cos_sin(heading)
    new_vel = torch.stack(
        [cos_h * speed, torch.zeros_like(heading), sin_h * speed], dim=-1)
    still = vel.abs().sum(dim=-1) < 1e-6
    pick_new = (turn | still) & moving
    out = torch.where(pick_new[..., None], new_vel, vel)
    return (out, pick_new) if with_pick else out
