"""The float orders of the JAX package's jitted CPU code, in torch ops.

The port's bit rule holds the card's float lanes to the CPU port's and
both to the JAX package's. XLA's CPU backend fixes each float result by
an order of operations that its source does not state. The orders here
were read off the compiled programs (their HLO and LLVM IR) and held
against them bit for bit (``tests/test_torch_behaviors.py``):

* :func:`ftz`, :func:`round_ftz`, :func:`mul32`, :func:`div32`: XLA's
  CPU runtime runs under flush-to-zero and denormals-are-zero, and a
  TPU's float units keep no subnormals; CUDA keeps them. So the
  behavior and integrate stages flush explicitly, on every device: a
  subnormal float32 input reads as a zero of its sign (:func:`ftz` on
  each lane read from the state), and a result whose magnitude, rounded
  to 24 bits with an unbounded exponent, is below 2^-126 becomes a
  zero of its sign (x86 detects tininess after rounding). A sum or
  difference of float32 values at or above 2^-126 is exact when it is
  that small, so :func:`ftz` after the float32 op flushes it; a product
  or quotient is taken in float64 (exact, or rounded harmlessly twice)
  and rounded by :func:`round_ftz`, which tests the float64 value
  against the tininess threshold before the cast.
* :func:`fma32`: LLVM contracts ``a * b + c`` into one fused
  multiply-add.
* :func:`mul_recip`: XLA rewrites a divide by a constant into a
  multiply by its float32 reciprocal.
* :func:`sqrt32`: XLA's float32 square root is correctly rounded.
* :func:`rsqrt_x86`: its reciprocal square root is not: the CPU's
  table estimate and two Newton steps.
* :func:`dot_f32`: a float32 dot ``[N, K] x [K, M]`` sums its products
  in k order when the output is wide (M >= 64) or has one row, and
  otherwise (mostly) in 4 (M <= 16) or 2 (M 17-63) interleaved partial
  sums (k mod L) added pairwise, with the ``K mod L`` last terms summed
  apart and added last (:func:`dot_lanes`, which says where it was
  measured).
* :func:`sum_k`: a reduce over the neighbor axis ``[N, k, 3] -> [N,
  3]``. Above k 32 XLA splits the axis into windows of 32 (the axis
  padded by ``pad // 2`` zeros in front), sums each window in order and
  the window sums in order. Up to 32 the reduce is fused into its
  consumer's loop and LLVM picks the order: in k order when the fusion
  has several outputs or k <= 16, else (a fusion whose one output is
  the sum) in 8 interleaved partial sums (k mod 8) added as halves
  (lane i with lane i + 4, then i + 2, then i + 1) for k 18, 19 and
  24-32, and for k 20-23 as four 4-lane groups of the first 16 terms
  added last to first, halved, then a 4-lane epilogue over terms 16-19
  that starts from that sum in its lane 0, halved, and the rest in
  order. At k 17 the mean offset's own fusion sums in k order and the
  observation's in 8 lanes. The caller says which fusion it mirrors
  (``vectorized``, ``lanes_from``: the least k summed in 8 lanes).

Every function takes CPU or CUDA tensors and runs the same ops on both,
so the card gives the CPU's bits. Their float inputs are flushed
(:func:`ftz`) by the caller; their results are flushed here.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch


# vrsqrtps's estimate on the reference's CPU (an Intel Xeon with
# AVX-512): int32[2, 1024], the result bits at exponent field 128 (row
# 0) and 127 (row 1) for each value of the top 10 mantissa bits, the
# only input bits besides the exponent that move it (read by running
# the instruction on every exponent parity and mantissa)
_VRSQRTPS = Path(__file__).with_name("vrsqrtps_table.npy")


# the smallest normal float32
TINY = 2.0 ** -126
# a float64 value rounds to a float32 below 2^-126, with an unbounded
# exponent, exactly when its magnitude is below this midpoint of
# 2^-126 - 2^-150 and 2^-126 (the tie rounds to 2^-126, the even one)
_TINY_AFTER = 2.0 ** -126 - 2.0 ** -151


def ftz(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with each subnormal replaced by a zero of its sign
    (inf and normal values kept, a NaN kept a NaN: its payload is the
    device's, as after any float op on the card): denormals-are-zero on
    an input, flush-to-zero on a result that is exact when tiny (a sum,
    or a product of bf16 values)."""
    return x * (x.abs() >= TINY)


def round_ftz(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` rounded to float32 as x86 rounds under
    flush-to-zero: a zero of its sign where the rounded magnitude would
    fall below 2^-126 (tininess after rounding), else the nearest
    float32."""
    return (v * (v.abs() >= _TINY_AFTER)).to(torch.float32)


def round_odd_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in float64 rounded to odd: the rounded sum, moved one
    ulp toward the exact sum when it was inexact and its last bit is
    even. Rounding that to float32 gives the float32 nearest the exact
    sum (53 >= 24 + 2 bits), so two roundings act as one."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)   # exact: s + err == a + b
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, torch.inf).copysign(err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def _f64(x) -> torch.Tensor | float:
    return x.double() if torch.is_tensor(x) else as_f32(x)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """float32 ``a * b`` under flush-to-zero: the product is exact in
    float64. ``b`` may be a Python number, taken as float32."""
    return round_ftz(a.double() * _f64(b))


def div32(a, b) -> torch.Tensor:
    """float32 ``a / b`` (either may be a Python number, not both) under
    flush-to-zero: a quotient rounded to float64 and then to float32 is
    the correctly rounded float32 one (53 >= 2 * 24 + 2 bits), and a
    quotient is never within a float64 ulp of the tininess threshold
    unless it equals it."""
    return round_ftz(_f64(a) / _f64(b))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add, under
    flush-to-zero: the product is exact in float64, the sum rounded to
    odd there (which keeps the tininess test exact) and then to float32.
    ``b`` and ``c`` may be Python numbers, taken as float32 as JAX's
    weak typing takes them."""
    p = a.double() * _f64(b)
    cc = c.double() if torch.is_tensor(c) \
        else torch.full_like(p, as_f32(c))
    return round_ftz(round_odd_sum(p, cc))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. torch's float32 ``sqrt``
    on the CPU is not (it differs from XLA's in about 1 of 160 values);
    the float64 root rounded to float32 is, on either device."""
    return torch.sqrt(x.double()).to(torch.float32)


@functools.cache
def _rsqrt_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.load(_VRSQRTPS)).reshape(-1).to(device)


def rsqrt_table(device) -> torch.Tensor:
    """int32[2048]: the estimate table of :func:`rsqrt_x86`, loaded onto
    ``device`` at its first use and kept."""
    return _rsqrt_table(torch.device(device))


def rsqrt_x86(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``rsqrt`` of positive ``x`` (its
    ``add_rsqrt_fusion``): the estimate of ``vrsqrtps`` (a lookup of the
    CPU's table by exponent parity and top 10 mantissa bits, the
    exponent halved) refined by two Newton steps ``y + (-y/2) * (x*y*y -
    1)``, each as the machine code has it: ``x*y`` and ``-y/2`` rounded,
    then two fused multiply-adds. +inf gives the estimate, 0."""
    bits = x.view(torch.int32)
    e = (bits >> 23) & 0xFF
    par = e & 1
    t = rsqrt_table(x.device)[par * 1024 + ((bits >> 13) & 0x3FF)]
    y = (t - (((e - 128 + par) >> 1) << 23)).view(torch.float32)
    for _ in range(2):
        y = fma32(y * -0.5, fma32(x * y, y, -1.0), y)
    return torch.where(torch.isinf(x), 0.0, y)


def mul_recip(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA computes it: a multiply by
    the float32 reciprocal ``1 / float32(c)`` (under flush-to-zero for
    a tensor ``x``)."""
    r = float(np.float32(1.0) / np.float32(c))
    return mul32(x, r) if torch.is_tensor(x) else x * r


def as_f32(v) -> float:
    """A Python number rounded to the nearest float32."""
    return float(np.float32(v))


def dot_lanes(rows: int, depth: int, cols: int) -> int:
    """Interleaved partial sums of XLA's CPU float32 dot ``[rows, depth]
    x [depth, cols]`` (1: k order). Measured at every row count from 1
    to 79 and at 96-4096 on the policy's shapes at hidden 16 and 128
    (depth 10, 16, 128; cols 3, 16, 128): 1 row always in k order; 2 or
    3 rows in k order but for a 16 x 16 weight (4 partial sums); the
    observation layer (depth 10) in k order up to 50 rows (measured for
    cols 9-16, 20, 24, 32, 40, 48). Under the World's vmap over S
    Spaces (read off the optimized HLO of ``_make_local_tick(cfg,
    n_spaces=S)`` at S = 2, 3 and 8, 512 rows a Space, hidden 16 and
    128) the policy's dots are one dot over all ``S * 512`` rows
    (``f32[S*512, K]``), so ``rows`` is ``S * N`` there; a mix member's
    dots stay batched one-row matvecs (batch dims ``[S, N]``), summed in
    k order. Other hidden sizes keep orders not measured here
    (ROADMAP.md Queue C4); the policy refuses them
    (:func:`goworld_tpu_torch.ops.mlp.layer_lanes`)."""
    if rows == 1 or cols >= 64:
        return 1
    if rows < 4:
        return 4 if depth % 4 == 0 and 16 <= cols < 32 else 1
    if depth == 10 and cols > 8 and rows <= 50:
        return 1
    return 2 if cols >= 32 else 4


def _least_nonzero(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return torch.where(a > 0, a, torch.inf).amin().double()


def dot_f32(x: torch.Tensor, w: torch.Tensor, lanes: int) -> torch.Tensor:
    """``x [N, K] @ w [K, M]`` of bf16 values (flushed) in float32 in
    XLA's order with ``lanes`` partial sums (:func:`dot_lanes`), under
    flush-to-zero: each product (exact: a bfloat16 by bfloat16 product
    has 16 significant bits) and each sum flushed on its own. Where every
    nonzero product is at least 2^-103 the flushes are skipped: such a
    product is a multiple of 2^-118, so is every partial sum, and none
    is subnormal (one host read of two minima, a third of the ops)."""
    n, kk = x.shape
    kv = kk - kk % lanes
    tiny = not bool(_least_nonzero(x) * _least_nonzero(w) >= 2.0 ** -103)
    flush = ftz if tiny else (lambda t: t)

    def mac(acc, k):
        return flush(acc + flush(x[:, k:k + 1] * w[k]))

    parts = []
    for lane in range(lanes):
        acc = x.new_zeros(n, w.shape[1])
        for k in range(lane, kv, lanes):
            acc = mac(acc, k)
        parts.append(acc)
    while len(parts) > 1:
        parts = [flush(parts[i] + parts[i + 1])
                 for i in range(0, len(parts), 2)]
    out = parts[0]
    if kv < kk:
        tail = x.new_zeros(n, w.shape[1])
        for k in range(kv, kk):
            tail = mac(tail, k)
        out = flush(out + tail)
    return out


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ftz(a + b)


def _seq(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = _add(acc, x[:, j])
    return acc


def _halves(acc: torch.Tensor) -> torch.Tensor:
    """``[N, L, C] -> [N, C]``: lane i added to lane i + L/2, halving
    until one lane is left (LLVM's vector reduction)."""
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = _add(acc[:, :h], acc[:, h:])
    return acc[:, 0]


def sum_k(x: torch.Tensor, vectorized: bool,
          lanes_from: int = 18) -> torch.Tensor:
    """``x [N, k, C] -> [N, C]``: the sum over axis 1 in the order of
    XLA's CPU reduce of the neighbor axis (module docstring), each sum
    flushed;
    ``vectorized`` when the reference's fusion has the sum as its one
    output, ``lanes_from`` 17 for the observation's fusion."""
    n, k, c = x.shape
    if k < min(lanes_from, 18) or (k <= 32 and not vectorized):
        return _seq(x)
    if 20 <= k <= 23:
        g = [x[:, 4 * u:4 * u + 4] for u in range(4)]
        acc = _halves(_add(g[3], _add(g[2], _add(g[1], g[0]))))
        out = _halves(torch.cat([_add(acc, x[:, 16])[:, None],
                                 x[:, 17:20]], 1))
        for j in range(20, k):
            out = _add(out, x[:, j])
        return out
    if k <= 32:
        kv = k - k % 8
        acc = x.new_zeros(n, 8, c)
        for j in range(0, kv, 8):
            acc = _add(acc, x[:, j:j + 8])
        out = _halves(acc)
        for j in range(kv, k):
            out = _add(out, x[:, j])
        return out
    nw = -(-k // 32)
    pad = nw * 32 - k
    lo = pad // 2
    xp = torch.cat([x.new_zeros(n, lo, c), x, x.new_zeros(n, pad - lo, c)],
                   1)
    sums = torch.stack([_seq(xp[:, 32 * i:32 * (i + 1)])
                        for i in range(nw)], 1)
    return _seq(sums)
