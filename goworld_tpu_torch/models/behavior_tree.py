"""The Monster behavior tree as mask algebra, the port of
``goworld_tpu/models/behavior_tree.py`` (BASELINE config 5's
``btree``).

The reference Monster AI (``examples/unity_demo/Monster.go:32-100``)
chases the nearest player in its AOI, else wanders. Here the same
decision structure is a static tree evaluated over the whole population
at once: every condition is a bool[N] tensor, every action a candidate
velocity field, and selector/sequence semantics are mask algebra. No
branch runs on the host.

Tree semantics, as in the JAX package: ``Cond(name)`` succeeds where
the named condition holds; ``Act(name)`` always succeeds and, where
reached, emits its action; ``Seq`` runs its children while each
succeeds; ``Sel``'s first succeeding child claims the entity. Where
several actions are active for one entity, the first emitted in
traversal order wins.
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.models.random_walk import random_walk_step
from goworld_tpu_torch.ops.xla_order import fma32, sqrt32, sum_k


@dataclasses.dataclass(frozen=True)
class Cond:
    name: str


@dataclasses.dataclass(frozen=True)
class Act:
    name: str


@dataclasses.dataclass(frozen=True)
class Seq:
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Sel:
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


def eval_tree(node, active: torch.Tensor, conds: dict):
    """Evaluate ``node`` over the entities in ``active``. Returns
    (success bool[N], [(action name, mask bool[N]), ...] in traversal
    order)."""
    if isinstance(node, Cond):
        return active & conds[node.name], []
    if isinstance(node, Act):
        return active, [(node.name, active)]
    if isinstance(node, Seq):
        cur, acts = active, []
        for child in node.children:
            cur, a = eval_tree(child, cur, conds)
            acts.extend(a)
        return cur, acts
    if isinstance(node, Sel):
        remaining, acts = active, []
        succeeded = torch.zeros_like(active)
        for child in node.children:
            s, a = eval_tree(child, remaining, conds)
            acts.extend(a)
            succeeded = succeeded | s
            remaining = remaining & ~s
        return succeeded, acts
    raise TypeError(f"unknown BT node {node!r}")


def combine_actions(acts, actions: dict, like: torch.Tensor):
    """First-emitted-wins combination of masked action velocities
    (``like`` gives the [N, 3] shape and device)."""
    vel = torch.zeros_like(like, dtype=torch.float32)
    claimed = torch.zeros(like.shape[:1], dtype=torch.bool,
                          device=like.device)
    for name, mask in acts:
        take = mask & ~claimed
        vel = torch.where(take[:, None], actions[name], vel)
        claimed = claimed | take
    return vel


def monster_tree() -> Sel:
    """The unity_demo Monster AI: chase the nearest player in AOI;
    avoid crowds; otherwise wander."""
    return Sel(
        Seq(Cond("player_in_aoi"), Act("chase")),
        Seq(Cond("crowded"), Act("separate")),
        Act("wander"),
    )


@dataclasses.dataclass(frozen=True)
class BTFeatures:
    nbr_cnt: torch.Tensor      # i32[N] AOI neighbor count
    client_cnt: torch.Tensor   # i32[N] client-owning neighbors
    client_off: torch.Tensor   # f32[N, 3] offset to the nearest client
    mean_off: torch.Tensor     # f32[N, 3] mean neighbor offset
    # the mean's sum f32[N, 3] and divisor f32[N] when it was built here
    # from the lists (None from the summary lanes): XLA rewrites
    # (sum / den) / norm into sum / (den * norm), and so does toward()
    mean_sum: torch.Tensor | None = None
    mean_den: torch.Tensor | None = None


def features_from_neighbors(pos, has_client, nbr, nbr_cnt,
                            vectorized: bool = False) -> BTFeatures:
    """One Space's features from the previous tick's neighbor lists.
    The nearest client is the first lane of least Chebyshev distance
    (``argmin``'s tie rule); a row with no client neighbor reads lane 0
    and is zeroed. ``vectorized``: the mean offset's sum is the only
    output of its fusion in the reference (its client lanes unused;
    :func:`ops.xla_order.sum_k`)."""
    n = pos.shape[0]
    valid = nbr != n
    nbr_c = torch.clamp_max(nbr, n - 1).long()
    npos = pos[nbr_c]
    offs = torch.where(valid[:, :, None],
                       npos - pos[:nbr.shape[0], None, :], 0.0)
    is_client = valid & has_client[nbr_c]
    cheb = torch.maximum(offs[:, :, 0].abs(), offs[:, :, 2].abs())
    key = torch.where(is_client, cheb, torch.inf)
    lane = torch.argmin(key, dim=1)
    client_off = torch.gather(
        offs, 1, lane[:, None, None].expand(-1, 1, 3))[:, 0, :]
    client_cnt = is_client.sum(dim=1, dtype=torch.int32)
    client_off = torch.where(client_cnt[:, None] > 0, client_off, 0.0)
    denom = torch.clamp_min(nbr_cnt, 1).to(torch.float32)
    total = sum_k(offs, vectorized)
    return BTFeatures(nbr_cnt=nbr_cnt, client_cnt=client_cnt,
                      client_off=client_off,
                      mean_off=total / denom[:, None],
                      mean_sum=total, mean_den=denom)


def features_from_summary(nbr_cnt, nbr_client_cnt, nbr_mean_off):
    """The megaspace's features: its gid neighbor lists cannot gather
    positions, so chase heads along the mean neighbor offset (the JAX
    package's documented approximation)."""
    return BTFeatures(nbr_cnt=nbr_cnt, client_cnt=nbr_client_cnt,
                      client_off=nbr_mean_off, mean_off=nbr_mean_off)


def unit_norm(dx: torch.Tensor, dz: torch.Tensor, eps: float):
    """``sqrt(dx * dx + dz * dz + eps)`` with the jitted reference's
    fused multiply-add (``dz * dz`` rounded, ``dx * dx`` fused)."""
    return sqrt32(fma32(dx, dx, dz * dz) + eps)


def unit_scale(off, norm, num=None, den=None):
    """``off / norm`` (rows of [N, 3] by [N]); when ``off`` is ``num /
    den`` built in the same tick, ``num / (den * norm)``, as XLA's
    simplifier rewrites a divide of a divide."""
    if num is None:
        return off / norm[:, None]
    return num / (den * norm)[:, None]


def btree_velocity(key, feats: BTFeatures, vel, npc_moving, speed: float,
                   turn_prob: float, crowd_threshold: int = 12):
    """Evaluate the monster tree over the population -> (f32[N, 3],
    bool[N]): the velocity, and the rows whose ``pos + vel * dt`` the
    jitted reference contracts into one fused multiply-add. Its
    integrate loop is unswitched on the chase condition, then on the
    wander's pick, and only the pick path (where ``moving`` is then
    known) leaves the multiply beside the add (ROADMAP.md Queue C4)."""
    conds = {
        "player_in_aoi": feats.client_cnt > 0,
        "crowded": feats.nbr_cnt >= crowd_threshold,
    }

    def toward(off, sign, num=None, den=None):
        norm = unit_norm(off[:, 0], off[:, 2], 1e-6)
        s = unit_scale(off, norm, num, den) * (sign * speed)
        return torch.stack([s[:, 0], s[:, 1] * 0.0, s[:, 2]], dim=1)

    actions = {
        "chase": toward(feats.client_off, 1.0),
        "separate": toward(feats.mean_off, -1.0, feats.mean_sum,
                           feats.mean_den),
    }
    actions["wander"], pick = random_walk_step(key, vel, npc_moving, speed,
                                               turn_prob, with_pick=True)
    _, acts = eval_tree(monster_tree(), npc_moving, conds)
    out = combine_actions(acts, actions, vel)
    out = torch.where(npc_moving[:, None], out, 0.0)
    return out, pick & ~conds["player_in_aoi"]
