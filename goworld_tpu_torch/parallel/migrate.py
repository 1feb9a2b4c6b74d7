"""Entity migration between the tiles of a sharded Space, the port of
``goworld_tpu/parallel/migrate.py``: each tile packs up to ``cap``
emigrant rows per destination into a fixed ``[n_dev, cap, F]`` buffer,
the buffers are exchanged (JAX's ``all_to_all``; on one card a
transpose of the stacked buffers, :mod:`goworld_tpu_torch.parallel.
megaspace`), and each tile scatters its arrivals into free slots.

JAX's ``scatter(mode="drop")`` onto the out-of-range slot ``n`` is a
dump row here: every lane gains one extra row that takes the dropped
writes and is sliced off.
"""

from __future__ import annotations

import torch

from goworld_tpu_torch.core.state import SpaceState
from goworld_tpu_torch.ops.extract import (
    bounded_extract,
    bounded_extract_batched,
)

# int-lane fields per migrating row
I_TYPE, I_HAS_CLIENT, I_CLIENT_GATE, I_TAG, I_NPC_MOVING, I_VALID = range(6)
I_FIELDS = 6


def pack_emigrants(state: SpaceState, target: torch.Tensor,
                   tag: torch.Tensor, n_dev: int, cap: int):
    """Build per-destination send buffers and the departed mask.

    Args:
      state: one tile's state; target: i32[N] destination tile, -1 =
        stay; tag: i32[N] migration tag.

    Returns:
      fbuf: f32[n_dev, cap, 8+A] (pos, yaw, vel, aoi_radius, hot_attrs)
      ibuf: i32[n_dev, cap, I_FIELDS]
      departed: bool[N] rows actually packed (despawn them locally)
      demand: i32[n_dev] true per-destination emigrant counts (may
        exceed cap; the surplus stays put and retries next tick)
    """
    n = state.pos.shape[0]
    dev = state.pos.device
    emigrate = (target >= 0) & (target < n_dev) & state.alive
    dst_mask = (target[None, :] == torch.arange(
        n_dev, dtype=torch.int32, device=dev)[:, None]) & emigrate[None, :]
    flat, valid, demand = bounded_extract_batched(dst_mask, cap)
    slots = torch.where(valid, flat, n - 1).long()

    fbuf = torch.cat([
        state.pos[slots],
        state.yaw[slots][..., None],
        state.vel[slots],
        state.aoi_radius[slots][..., None],
        state.hot_attrs[slots],
    ], dim=-1)
    fbuf = torch.where(valid[..., None], fbuf, 0.0)
    ibuf = torch.stack([
        state.type_id[slots],
        state.has_client[slots].to(torch.int32),
        state.client_gate[slots],
        tag[slots],
        state.npc_moving[slots].to(torch.int32),
        valid.to(torch.int32),
    ], dim=-1)
    ibuf = torch.where(valid[..., None], ibuf, 0)

    drop_slots = torch.where(valid, flat, n).long()   # n = the dump row
    departed = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    departed.index_fill_(0, drop_slots.reshape(-1), True)
    return fbuf, ibuf, departed[:n], demand


def despawn_departed(state: SpaceState,
                     departed: torch.Tensor) -> SpaceState:
    keep = ~departed
    return state.replace(
        alive=state.alive & keep,
        has_client=state.has_client & keep,
        npc_moving=state.npc_moving & keep,
        dirty=state.dirty & keep,
        client_gate=torch.where(departed, -1, state.client_gate),
        attr_dirty=torch.where(departed, 0, state.attr_dirty),
    )


def exchange_emigrants(fbufs: torch.Tensor, ibufs: torch.Tensor,
                       group=None):
    """JAX's ``all_to_all`` of the send buffers: ``fbufs``
    f32[n_src, n_dev, cap, F] and ``ibufs`` i32[n_src, n_dev, cap,
    I_FIELDS] stack this controller's tiles' buffers, one block a
    destination tile; returns the blocks each of this controller's
    tiles receives, ``[n_dst, n_dev, cap, ...]`` in sender order. On one
    controller (``group`` None or of one) a transpose; on several the
    blocks for another rank's tiles go through one
    :meth:`~goworld_tpu_torch.parallel.multihost.Group.all_to_all` of
    their words (floats as their bits)."""
    if group is None or group.size == 1:
        return fbufs.transpose(0, 1), ibufs.transpose(0, 1)
    n_src, n_dev = fbufs.shape[:2]
    nf = fbufs.shape[-1]
    ranks = group.size
    nl = n_dev // ranks
    words = torch.cat([fbufs.contiguous().view(torch.int32), ibufs], dim=-1)
    blocks = words.view(n_src, ranks, nl, *words.shape[2:]).transpose(0, 1)
    got = group.all_to_all(blocks.contiguous())
    got = got.reshape(ranks * n_src, nl, *words.shape[2:]).transpose(0, 1)
    return got[..., :nf].view(torch.float32), got[..., nf:]


def _put(lane: torch.Tensor, slot: torch.Tensor, vals) -> torch.Tensor:
    """``lane.at[slot].set(vals, mode="drop")`` with slot ``n`` the
    dropped index: a new tensor, ``lane`` is not modified. A Python
    scalar goes in by ``index_fill_`` (an indexed assignment would copy
    it from the host)."""
    out = torch.cat([lane, lane.new_zeros((1,) + lane.shape[1:])])
    if isinstance(vals, torch.Tensor):
        out[slot] = vals
    else:
        out.index_fill_(0, slot, vals)
    return out[:lane.shape[0]]


def insert_arrivals(state: SpaceState, fbuf: torch.Tensor,
                    ibuf: torch.Tensor, nbr_sentinel: int,
                    quarantine: torch.Tensor | None = None):
    """Scatter arriving rows into free slots.

    ``quarantine`` (bool[N]) marks slots freed this tick (departed
    emigrants): they are not reused for one tick, so their stale
    interest lists still produce the previous occupant's leave events on
    the next diff.

    Returns (state, arr_tag i32[D*cap], arr_slot i32[D*cap], arr_n i32,
    dropped i32). arr_slot is -1 past arr_n; ``dropped`` counts arrivals
    that found no free slot.
    """
    n = state.pos.shape[0]
    a = state.hot_attrs.shape[1]
    d, cap, _ = fbuf.shape
    total = d * cap

    f = fbuf.reshape(total, 8 + a)
    i = ibuf.reshape(total, I_FIELDS)
    arr_valid = i[:, I_VALID] > 0

    free_mask = ~state.alive
    if quarantine is not None:
        free_mask = free_mask & ~quarantine
    free_flat, _free_valid, free_cnt = bounded_extract(free_mask, total)
    rank = torch.cumsum(arr_valid, 0, dtype=torch.int32) - 1
    can = arr_valid & (rank < torch.clamp_max(free_cnt, total)) \
        & (rank >= 0)
    slot = torch.where(
        can, free_flat[torch.clamp(rank, 0, total - 1).long()], n)
    sl = slot.long()

    gen = torch.cat([state.gen, state.gen.new_zeros(1)])
    gen.index_add_(0, sl, torch.ones_like(slot))
    st = state.replace(
        pos=_put(state.pos, sl, f[:, 0:3]),
        yaw=_put(state.yaw, sl, f[:, 3]),
        vel=_put(state.vel, sl, f[:, 4:7]),
        aoi_radius=_put(state.aoi_radius, sl, f[:, 7]),
        hot_attrs=_put(state.hot_attrs, sl, f[:, 8:]),
        type_id=_put(state.type_id, sl, i[:, I_TYPE]),
        has_client=_put(state.has_client, sl, i[:, I_HAS_CLIENT] > 0),
        client_gate=_put(state.client_gate, sl, i[:, I_CLIENT_GATE]),
        npc_moving=_put(state.npc_moving, sl, i[:, I_NPC_MOVING] > 0),
        alive=_put(state.alive, sl, True),
        dirty=_put(state.dirty, sl, True),
        gen=gen[:n],
        attr_dirty=_put(state.attr_dirty, sl, 0),
        # stale interest of the slot's previous occupant must not produce
        # phantom enter/leave diffs for the newcomer
        nbr=_put(state.nbr, sl, nbr_sentinel),
        nbr_cnt=_put(state.nbr_cnt, sl, 0),
    )
    arr_n = can.sum(dtype=torch.int32)
    dropped = (arr_valid & ~can).sum(dtype=torch.int32)
    # compact accepted arrivals to the front, in order (a stable sort)
    order = torch.argsort((~can).to(torch.int32), stable=True)
    arr_tag = torch.where(can, i[:, I_TAG], -1)[order]
    arr_slot = torch.where(can, slot, -1)[order]
    return st, arr_tag, arr_slot, arr_n, dropped
