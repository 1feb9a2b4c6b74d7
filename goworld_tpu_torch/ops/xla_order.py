"""The float orders of the JAX package's jitted CPU code, in torch ops.

The port's bit rule holds the card's float lanes to the CPU port's and
both to the JAX package's. XLA's CPU backend fixes each float result by
an order of operations that its source does not state. The orders here
were read off the compiled programs (their HLO and LLVM IR) and held
against them bit for bit (``tests/test_torch_behaviors.py``):

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
so the card gives the CPU's bits.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from goworld_tpu_torch.ops.integrate import _round_odd_sum

# vrsqrtps's estimate on the reference's CPU (an Intel Xeon with
# AVX-512): int32[2, 1024], the result bits at exponent field 128 (row
# 0) and 127 (row 1) for each value of the top 10 mantissa bits, the
# only input bits besides the exponent that move it (read by running
# the instruction on every exponent parity and mantissa)
_VRSQRTPS = Path(__file__).with_name("vrsqrtps_table.npy")


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum rounded to odd there and then
    to float32. ``b`` and ``c`` may be Python numbers, taken as float32
    as JAX's weak typing takes them."""
    p = a.double() * (b.double() if torch.is_tensor(b) else as_f32(b))
    cc = c.double() if torch.is_tensor(c) \
        else torch.full_like(p, as_f32(c))
    return _round_odd_sum(p, cc).to(torch.float32)


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
    the float32 reciprocal ``1 / float32(c)``."""
    r = float(np.float32(1.0) / np.float32(c))
    return x * r


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
    cols 9-16, 20, 24, 32, 40, 48). Other hidden sizes keep orders not
    measured here (ROADMAP.md Queue C4); the policy refuses them
    (:func:`goworld_tpu_torch.ops.mlp.layer_lanes`)."""
    if rows == 1 or cols >= 64:
        return 1
    if rows < 4:
        return 4 if depth % 4 == 0 and 16 <= cols < 32 else 1
    if depth == 10 and cols > 8 and rows <= 50:
        return 1
    return 2 if cols >= 32 else 4


def dot_f32(x: torch.Tensor, w: torch.Tensor, lanes: int) -> torch.Tensor:
    """``x [N, K] @ w [K, M]`` in float32 in XLA's order with ``lanes``
    partial sums (:func:`dot_lanes`). Each product is rounded on its own
    (a bfloat16 by bfloat16 product is exact)."""
    n, kk = x.shape
    kv = kk - kk % lanes
    parts = []
    for lane in range(lanes):
        acc = x.new_zeros(n, w.shape[1])
        for k in range(lane, kv, lanes):
            acc = acc + x[:, k:k + 1] * w[k]
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    out = parts[0]
    if kv < kk:
        tail = x.new_zeros(n, w.shape[1])
        for k in range(kv, kk):
            tail = tail + x[:, k:k + 1] * w[k]
        out = out + tail
    return out


def _seq(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _halves(acc: torch.Tensor) -> torch.Tensor:
    """``[N, L, C] -> [N, C]``: lane i added to lane i + L/2, halving
    until one lane is left (LLVM's vector reduction)."""
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def sum_k(x: torch.Tensor, vectorized: bool,
          lanes_from: int = 18) -> torch.Tensor:
    """``x [N, k, C] -> [N, C]``: the sum over axis 1 in the order of
    XLA's CPU reduce of the neighbor axis (module docstring);
    ``vectorized`` when the reference's fusion has the sum as its one
    output, ``lanes_from`` 17 for the observation's fusion."""
    n, k, c = x.shape
    if k < min(lanes_from, 18) or (k <= 32 and not vectorized):
        return _seq(x)
    if 20 <= k <= 23:
        g = [x[:, 4 * u:4 * u + 4] for u in range(4)]
        acc = _halves(g[3] + (g[2] + (g[1] + g[0])))
        out = _halves(torch.cat([(acc + x[:, 16])[:, None], x[:, 17:20]], 1))
        for j in range(20, k):
            out = out + x[:, j]
        return out
    if k <= 32:
        kv = k - k % 8
        acc = x.new_zeros(n, 8, c)
        for j in range(0, kv, 8):
            acc = acc + x[:, j:j + 8]
        out = _halves(acc)
        for j in range(kv, k):
            out = out + x[:, j]
        return out
    nw = -(-k // 32)
    pad = nw * 32 - k
    lo = pad // 2
    xp = torch.cat([x.new_zeros(n, lo, c), x, x.new_zeros(n, pad - lo, c)],
                   1)
    sums = torch.stack([_seq(xp[:, 32 * i:32 * (i + 1)])
                        for i in range(nw)], 1)
    return _seq(sums)
