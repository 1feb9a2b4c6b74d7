"""The NPC policy's forward pass: the plain version and the wrapper of
its CUDA kernel (``csrc/npc_mlp.cu``).

The JAX package evaluates its bf16 MLP (``models/npc_policy.py``
``policy_accel``) as plain XLA dots. On the CPU every dot is a float32
dot of the bf16 values in XLA's order (:func:`ops.xla_order.dot_f32`),
rounded to bf16; the bias is added in float32 and rounded to bf16;
tanh runs on that and is rounded to bf16; the last layer's bias sum
stays float32. The two functions here compute exactly that:

* :func:`npc_mlp_plain` in torch ops (tanh in float64, rounded to
  float32, then to bf16: over every bf16 input this is XLA's float32
  tanh rounded to bf16);
* :func:`npc_mlp`, the kernel for a tensor on the card, the plain
  version for a tensor on the CPU. No matmul library runs on the card:
  its summation order is not XLA's.

The kernel is a CUDA-core SGEMM in XLA's order (one output, or one of
its partial sums, summed by one thread in k order). It sums layer 2 by
fused multiply-adds: a bf16 x bf16 product has at most 16 significant
bits, so it is exact in float32 unless it overflows or drops bits below
2^-149, and then one FFMA gives the bits of the rounded product plus
the add. Layer 2 multiplies tanh outputs (``|x| <= 1``: no overflow)
and a row tile falls back on the rounded mul and add where its
activations and w2 could meet below the 2^-149 grid
(:func:`fma_exact`); layer 1 (the raw observations, up to +-3e38, where
a fused ``1.5 * 2**127 * 2 - 3e38`` is finite and the rounded one inf)
and the 3-column output layer keep the rounded mul and add. Its tanh
is a lookup into :func:`tanh_table`, built from :func:`tanh_bf16`.
"""

from __future__ import annotations

import functools

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops.xla_order import dot_f32, dot_lanes

OBS_DIM = 10
ACT_DIM = 3
# a product of bf16 values is on float32's 2^-149 grid when the biased
# exponent fields (at least 1) of its factors sum to this or more
EXACT_LO = 119
# the hidden sizes whose dot orders were read off the reference's code
MEASURED_HIDDEN = (16, 128)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16-rounded ``tanh`` of float32 ``x`` (bf16 values), through
    float64 and float32 as the kernel rounds."""
    return _bf(torch.tanh(x.double()).to(torch.float32))


def _lo_exp(x: torch.Tensor) -> torch.Tensor:
    """max(E, 1), E the biased exponent field of float32 ``x``."""
    return torch.clamp_min((x.view(torch.int32) >> 23) & 0xFF, 1)


def fma_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Where the kernel's layer 2 may sum ``x * w`` by one fused
    multiply-add: ``x`` a tanh output (``|x| <= 1``, so the product is
    at most ``|w|``) and the factors' lowest significand bits at or
    above 2^-149 (or either factor zero), so the product is exact in
    float32. The kernel tests the second part per row tile, from the
    smallest exponent of the tile's nonzero activations and of w2's
    nonzero words."""
    on_grid = (_lo_exp(x) + _lo_exp(w) >= EXACT_LO) | (x == 0) | (w == 0)
    return on_grid & (x.abs() <= 1)


@functools.cache
def _tanh_table(device: torch.device) -> torch.Tensor:
    mags = torch.arange(32768, dtype=torch.int32, device=device) \
        .to(torch.int16).view(torch.bfloat16).float()
    return tanh_bf16(mags).to(torch.bfloat16)


def tanh_table(device) -> torch.Tensor:
    """bf16[32768]: :func:`tanh_bf16` of the bf16 magnitudes (the word
    ``i`` read as a bf16), built on ``device`` at its first use and kept.
    The kernel looks up ``|x|`` and applies the sign of ``x`` (tanh_bf16
    is odd on every bf16 input)."""
    return _tanh_table(torch.device(device))


def tanh_by_table(x: torch.Tensor) -> torch.Tensor:
    """:func:`tanh_bf16` of float32 ``x`` (bf16 values) as the kernel
    computes it: the table at ``|x|``, the sign of ``x``."""
    u = x.view(torch.int32) >> 16
    t = tanh_table(x.device).view(torch.int16)[(u & 0x7FFF).long()] \
        .to(torch.int32) & 0xFFFF
    return ((t | (u & 0x8000)) << 16).view(torch.float32)


def check_hidden(hidden: int) -> None:
    """Raise for a hidden size whose dot orders are not read yet."""
    if hidden not in MEASURED_HIDDEN:
        raise NotImplementedError(
            f"the policy at hidden {hidden}: XLA's dot orders are read "
            f"at hidden {MEASURED_HIDDEN} only; see ROADMAP.md Queue C4")


def layer_lanes(rows: int, hidden: int) -> tuple[int, int, int]:
    """XLA's partial sums of the three dots over ``rows`` rows (1 for a
    batch of one-row dots, as a vmapped member's)."""
    check_hidden(hidden)
    return (dot_lanes(rows, OBS_DIM, hidden), dot_lanes(rows, hidden, hidden),
            dot_lanes(rows, hidden, ACT_DIM))


def npc_mlp_plain(obs, w1, b1, w2, b2, w3, b3,
                  per_row: bool = False) -> torch.Tensor:
    """f32[N, 3]: the policy's forward pass over ``obs`` f32[N, 10]
    (bf16 weights ``w1 [10, H]``, ``w2 [H, H]``, ``w3 [H, 3]`` and
    biases), in plain torch ops with XLA's bits. ``per_row``: each row
    summed as a one-row dot (the reference's batched dot of a vmapped
    member)."""
    l1, l2, l3 = layer_lanes(1 if per_row else obs.shape[0], w1.shape[1])
    f = [t.to(torch.float32) for t in (w1, b1, w2, b2, w3, b3)]
    x = _bf(obs.to(torch.float32))
    x = tanh_bf16(_bf(_bf(dot_f32(x, f[0], l1)) + f[1]))
    x = tanh_bf16(_bf(_bf(dot_f32(x, f[2], l2)) + f[3]))
    return _bf(dot_f32(x, f[4], l3)) + f[5]


def npc_mlp(obs, w1, b1, w2, b2, w3, b3,
            per_row: bool = False) -> torch.Tensor:
    """:func:`npc_mlp_plain` as the kernel of ``csrc/npc_mlp.cu`` for
    tensors on the card (one launch over all rows), the plain version
    for tensors on the CPU."""
    if obs.dim() != 2 or obs.shape[1] != OBS_DIM:
        raise ValueError(f"obs: expected [N, {OBS_DIM}], got "
                         f"{tuple(obs.shape)}")
    n = obs.shape[0]
    h = w1.shape[1]
    shapes = {"w1": (OBS_DIM, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, ACT_DIM), "b3": (ACT_DIM,)}
    ws = dict(w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    for name, t in ws.items():
        kernels.require(t, name, torch.bfloat16, shapes[name])
        if t.device != obs.device:
            raise ValueError(f"{name} lives on {t.device}, obs on "
                             f"{obs.device}")
    kernels.require(obs, "obs", torch.float32)
    if obs.device.type == "cpu":
        return npc_mlp_plain(obs, w1, b1, w2, b2, w3, b3, per_row)
    if obs.device.type != "cuda":
        raise ValueError(f"obs: unsupported device {obs.device}")
    so = kernels.lib()
    if h > so.gw_npc_mlp_max_hidden():
        raise ValueError(f"hidden {h} exceeds the kernel's "
                         f"{so.gw_npc_mlp_max_hidden()}")
    out = torch.empty((n, ACT_DIM), dtype=torch.float32, device=obs.device)
    l1, l2, l3 = layer_lanes(1 if per_row else n, h)
    err = so.gw_npc_mlp(obs.data_ptr(), n, h, *(t.data_ptr() for t in
                                                 ws.values()),
                        l1, l2, l3, tanh_table(obs.device).data_ptr(),
                        out.data_ptr(),
                        kernels.stream_handle(obs.device))
    kernels.check(err, "npc_mlp")
    kernels.LAUNCHES["npc_mlp"] += 1
    return out
