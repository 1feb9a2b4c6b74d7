"""bf16 MLP behavior policy over local observations, the port of
``goworld_tpu/models/npc_policy.py`` (BASELINE config 5's ``mlp``).

The observation summarises each NPC's AOI context (position, velocity,
heading, neighbor count and mean neighbor offset); a 10 -> H -> H -> 3
bf16 MLP maps it to an acceleration. :func:`policy_accel` runs the
hand-written kernel of ``csrc/npc_mlp.cu`` on the card and its plain
version on the CPU (:mod:`goworld_tpu_torch.ops.mlp`); both give the
JAX package's bits. Float work on the way (the mean offset's sum, the
divides, the heading's sine and cosine) is computed in the jitted
reference's order (:mod:`goworld_tpu_torch.ops.xla_order`).
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import resolve_device
from goworld_tpu_torch.models.random_walk import cos_sin
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.mlp import (
    OBS_DIM,
    check_hidden,
    npc_mlp,
    tanh_table,
)
from goworld_tpu_torch.ops.xla_order import mul_recip, rsqrt_table, sum_k

_LANES = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclasses.dataclass(frozen=True)
class MLPPolicy:
    """The policy's bf16 parameters (the JAX ``MLPPolicy``'s fields)."""

    w1: torch.Tensor  # bf16[OBS_DIM, H]
    b1: torch.Tensor  # bf16[H]
    w2: torch.Tensor  # bf16[H, H]
    b2: torch.Tensor  # bf16[H]
    w3: torch.Tensor  # bf16[H, 3]
    b3: torch.Tensor  # bf16[3]

    def __post_init__(self):
        # the kernel's tanh table and the speed cap's rsqrt table, made
        # once a card, outside the tick
        if self.w1.device.type == "cuda":
            tanh_table(self.w1.device)
            rsqrt_table(self.w1.device)

    @property
    def hidden(self) -> int:
        return self.w1.shape[1]

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def to(self, device) -> "MLPPolicy":
        return MLPPolicy(**{k: getattr(self, k).to(device) for k in _LANES})


# bf16 constants of jax.random.normal: the uniform's lower bound (the
# bf16 after -1 toward 0) and sqrt(2) rounded to bf16
_NORMAL_LO = -0.99609375
_SQRT2_BF16 = 1.4140625


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def normal_bf16(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)`` as float32 values.

    JAX draws 8 random bits an element (the low byte of the threefry
    words), makes a bf16 uniform in [1, 2) from the top 7 of them, maps
    it to (-1, 1) in bf16 arithmetic and returns ``sqrt(2) *
    erfinv(u)`` in bf16. Only 128 uniforms can occur; erfinv in float64
    rounded to bf16 gives XLA's float32 erfinv rounded to bf16 on each
    of them (``tests/test_torch_behaviors.py``)."""
    bits8 = prng.random_bits32(key, shape) & 0xFF
    n = (bits8 >> 1).to(torch.float32) / 128.0           # floats - 1
    # (maxval - minval) rounds to 2.0 in bf16; each op rounds to bf16
    u = torch.clamp_min(_bf(n * 2.0 + _NORMAL_LO), _NORMAL_LO)
    z = _bf(torch.erfinv(u.double()).to(torch.float32))
    return _bf(z * _SQRT2_BF16)


def init_policy(seed: int = 5, hidden: int = 128,
                device="cuda") -> MLPPolicy:
    """``init_policy(jax.random.PRNGKey(seed), hidden)`` of the JAX
    package, bit for bit, on ``device`` (the card unless the caller
    asks for the CPU): each weight a bf16 normal draw times
    ``bf16(1 / sqrt(fan_in))`` rounded to bf16, biases zero. Raises
    ``NotImplementedError`` at a hidden size whose dot orders are not
    read yet (:func:`goworld_tpu_torch.ops.mlp.check_hidden`)."""
    check_hidden(hidden)
    dev = resolve_device(device)
    keys = prng.split(prng.prng_key(seed, "cpu"), 3)

    def dense(key, i, o):
        # 1 / jnp.sqrt(i) in float32, rounded to bf16
        root = torch.sqrt(torch.tensor(float(i), dtype=torch.float32))
        scale = float((1.0 / root).to(torch.bfloat16))
        w = _bf(normal_bf16(key, (i, o)) * scale)
        return w.to(torch.bfloat16).to(dev)

    zeros = lambda m: torch.zeros(m, dtype=torch.bfloat16, device=dev)  # noqa: E731
    return MLPPolicy(
        w1=dense(keys[0], OBS_DIM, hidden), b1=zeros(hidden),
        w2=dense(keys[1], hidden, hidden), b2=zeros(hidden),
        w3=dense(keys[2], hidden, 3), b3=zeros(3),
    )


def neighbor_mean_offset(pos_src: torch.Tensor, self_pos: torch.Tensor,
                         nbr: torch.Tensor, nbr_cnt: torch.Tensor,
                         sentinel: int, lanes_from: int = 18) -> torch.Tensor:
    """f32[N, 3] mean offset to valid neighbors; ``pos_src`` is the
    position table ``nbr`` indexes (the whole population of one Space,
    or a megaspace tile's local and ghost rows). The sum over the
    neighbor axis runs in XLA's order (:func:`ops.xla_order.sum_k`;
    ``lanes_from`` 17 inside the observation's fusion)."""
    valid = nbr != sentinel
    nbr_c = torch.clamp_max(nbr, pos_src.shape[0] - 1).long()
    npos = pos_src[nbr_c]
    offs = torch.where(valid[:, :, None], npos - self_pos[:, None, :], 0.0)
    cnt = torch.clamp_min(nbr_cnt, 1).to(torch.float32)
    return sum_k(offs, True, lanes_from) / cnt[:, None]


def build_obs_from_features(pos, vel, yaw, nbr_cnt, mean_off, k: int,
                            world_extent: tuple[float, float]):
    """f32[N, OBS_DIM] from precomputed neighbor features (the
    megaspace path, whose gid neighbor lists cannot gather positions
    locally)."""
    ex, ez = world_extent
    cos_y, sin_y = cos_sin(yaw)
    return torch.cat([
        mul_recip(pos[:, :1], ex),
        mul_recip(pos[:, 2:3], ez),
        mul_recip(vel, 10.0),
        sin_y[:, None],
        cos_y[:, None],
        mul_recip(nbr_cnt.to(torch.float32), k)[:, None],
        mul_recip(mean_off[:, ::2], 100.0),
    ], dim=1)


def build_obs(pos, vel, yaw, nbr, nbr_cnt,
              world_extent: tuple[float, float]) -> torch.Tensor:
    """f32[N, OBS_DIM]: normalized pos, vel, yaw sin/cos and the
    neighbor summary from the previous tick's lists."""
    n, k = nbr.shape
    mean_off = neighbor_mean_offset(pos, pos, nbr, nbr_cnt, n, 17)
    return build_obs_from_features(pos, vel, yaw, nbr_cnt, mean_off, k,
                                   world_extent)


def policy_accel(params: MLPPolicy, obs: torch.Tensor,
                 per_row: bool = False) -> torch.Tensor:
    """Batched forward pass -> f32[N, 3] acceleration: the kernel of
    ``csrc/npc_mlp.cu`` on the card, its plain version on the CPU.
    ``per_row`` sums each row as a one-row dot, as the reference's
    vmapped scenario member does (its dots are batched matvecs)."""
    return npc_mlp(obs.contiguous(), *(getattr(params, k) for k in _LANES),
                   per_row=per_row)
