"""Ghost exchange across tile borders, the port of
``goworld_tpu/parallel/halo.py``.

Every tile of a megaspace sees the ``radius``-wide boundary strips of
its neighbor tiles as ghosts: each strip is extracted into a bounded
block of ``halo_cap`` rows (surplus rows are dropped from the
neighbor's view that tick, in slot order, and the demand gauge reports
the true occupancy) and shipped to the neighbor.

The JAX function runs once per device under ``shard_map``; here all
tiles live on one device with a leading ``[n_dev]`` axis, so each
function takes and returns stacked tensors, and a ship moves every
tile's block at once. Two ship impls, bit-identical (``halo_impl``):

* ``"async"``: the strip tuple is packed into one i32[n_dev, H, 5]
  buffer (pos bits, yaw bits, a meta word of gid/dirty/valid) and moved
  by the CUDA kernel of ``csrc/halo_ship.cu`` (:func:`ship_ring_cuda`),
  which replaces the Pallas ``make_async_remote_copy`` ring
  ``_async_ship``;
* ``"ppermute"``: each lane moves unpacked through
  :func:`ship_ring_plain` (``torch.roll`` over the tile axis and a mask),
  which is what ``lax.ppermute`` with a non-periodic pair list computes.

Invalid ghost gids are normalised to 0 and the yaw lane is gated on
dirty under both impls; that keeps them bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops.aoi import _f32
from goworld_tpu_torch.ops.extract import bounded_extract_batched

HALO_IMPLS = ("ppermute", "async")

# packed meta word: (gid + 1) << 2 | dirty << 1 | valid. gid is in [-1,
# gid_sentinel], so the +1 keeps it non-negative and the pack is exact
# while gid_sentinel + 1 < 2^29 (MegaConfig guards the bound).
_META_GID_BITS = 29
# tiles a ship kernel launch takes (its parameter struct's size)
MAX_SHIP_TILES = 64


def meta_gid_bound() -> int:
    """Largest gid the async meta word can carry exactly."""
    return (1 << _META_GID_BITS) - 2


def _pack_strip(gpos, gyaw, gdirty, gvalid, ggid) -> torch.Tensor:
    """One i32[..., H, 5] buffer per strip: cols 0-2 pos bits, col 3 yaw
    bits, col 4 meta. f32 -> i32 is a bitcast (exact round trip)."""
    meta = ((ggid + 1) << 2) | (gdirty.to(torch.int32) << 1) \
        | gvalid.to(torch.int32)
    return torch.cat([gpos.contiguous().view(torch.int32),
                      gyaw.contiguous().view(torch.int32)[..., None],
                      meta[..., None]], dim=-1)


def _unpack_strip(buf: torch.Tensor):
    meta = buf[..., 4]
    return (
        buf[..., 0:3].view(torch.float32),
        buf[..., 3].view(torch.float32),
        ((meta >> 1) & 1).bool(),
        (meta & 1).bool(),
        (meta >> 2) - 1,
    )


def ship_ring_plain(bufs: torch.Tensor, shift: int, recv_ok) -> torch.Tensor:
    """Plain version of :func:`ship_ring_cuda`, for a lane of any type:
    ``out[t] = bufs[(t - shift) % n_dev]`` where ``recv_ok[t]``, else
    zeros."""
    out = torch.roll(bufs, shift, dims=0)
    for t, ok in enumerate(recv_ok):
        if not ok:
            out[t].zero_()
    return out


def ship_ring_cuda(bufs: torch.Tensor, shift: int, recv_ok) -> torch.Tensor:
    """Ship every tile's packed strip ``shift`` tiles along the periodic
    ring: ``out[t] = recv_ok[t] ? bufs[(t - shift) % n_dev] : 0``. The
    CUDA kernel of ``csrc/halo_ship.cu`` for a tensor on the card; the
    plain version :func:`ship_ring_plain` for a tensor on the CPU.

    Args:
      bufs: i32[n_dev, H, 5] contiguous, one packed strip per tile.
      shift: the ring offset (any int; taken mod n_dev).
      recv_ok: n_dev Python bools, which receivers take their block.
        They depend on the tile index only, so the host never waits.
    """
    kernels.require(bufs, "bufs", torch.int32)
    n_dev = bufs.shape[0]
    if bufs.dim() != 3 or bufs.shape[2] != 5:
        raise ValueError(f"bufs: expected [n_dev, H, 5], got "
                         f"{tuple(bufs.shape)}")
    if len(recv_ok) != n_dev:
        raise ValueError(f"recv_ok has {len(recv_ok)} flags for "
                         f"{n_dev} tiles")
    if bufs.device.type == "cpu":
        return ship_ring_plain(bufs, shift, recv_ok)
    if bufs.device.type != "cuda":
        raise ValueError(f"bufs: unsupported device {bufs.device}")
    if not 1 <= n_dev <= MAX_SHIP_TILES:
        raise ValueError(f"the ship kernel takes 1..{MAX_SHIP_TILES} "
                         f"tiles, got {n_dev}")
    out = torch.empty_like(bufs)
    words = bufs[0].numel()
    if words == 0:
        return out
    step = words * bufs.element_size()
    src = (ctypes.c_void_p * n_dev)(
        *[bufs.data_ptr() + t * step for t in range(n_dev)])
    dst = (ctypes.c_void_p * n_dev)(
        *[out.data_ptr() + t * step for t in range(n_dev)])
    mask = sum(1 << t for t, ok in enumerate(recv_ok) if ok)
    err = kernels.lib().gw_halo_ship(
        src, dst, n_dev, words, shift % n_dev, mask,
        kernels.stream_handle(bufs.device))
    kernels.check(err, "ship_ring_cuda")
    kernels.LAUNCHES["halo_ship"] += 1
    return out


def _ship(shift: int, pack, recv_ok, impl: str):
    """Ship one stacked strip tuple ``(pos, yaw, dirty, valid, gid)``
    ``shift`` tiles along the flat axis; receivers whose ``recv_ok`` is
    False (world-edge tiles) get zeros, as ``ppermute`` fills them."""
    if impl == "async":
        return _unpack_strip(ship_ring_cuda(_pack_strip(*pack), shift,
                                            recv_ok))
    if impl != "ppermute":
        raise ValueError(f"halo_impl {impl!r} not in {HALO_IMPLS}")
    return tuple(ship_ring_plain(t, shift, recv_ok) for t in pack)


def _pack(mask, src_pos, src_yaw, src_dirty, src_gid, halo_cap: int):
    """The strip of each tile selected by ``mask`` [n_dev, M] as a
    bounded ghost block, plus each tile's true strip occupancy."""
    m = src_pos.shape[1]
    flat, valid, demand = bounded_extract_batched(mask, halo_cap)
    slots = torch.where(valid, flat, m - 1).long()
    sel_dirty = torch.gather(src_dirty, 1, slots) & valid
    sel_pos = torch.gather(src_pos, 1, slots[..., None].expand(-1, -1, 3))
    return (
        torch.where(valid[..., None], sel_pos, 0.0),
        torch.where(sel_dirty, torch.gather(src_yaw, 1, slots), 0.0),
        sel_dirty,
        valid,
        torch.where(valid, torch.gather(src_gid, 1, slots), -1),
    ), demand


def _tile_mins(idx: torch.Tensor, width: float) -> torch.Tensor:
    """Each tile's lower edge, in float32 as the JAX package computes it
    (an f32 index times the weakly typed width)."""
    return idx.to(torch.float32) * _f32(width, idx.device)


def _local_gid(n_dev: int, n_per_dev: int, n: int, dev) -> torch.Tensor:
    d = torch.arange(n_dev, dtype=torch.int32, device=dev)
    return d[:, None] * n_per_dev \
        + torch.arange(n, dtype=torch.int32, device=dev)[None, :]


def _cat(parts, i):
    return torch.cat([p[i] for p in parts], dim=1)


def exchange_halo(n_dev: int, pos, yaw, dirty, alive, tile_w: float,
                  radius: float, halo_cap: int, impl: str = "ppermute"):
    """Ship boundary strips of 1D x-strip tiles to their lateral
    neighbors.

    Args: stacked ``pos`` f32[n_dev, N, 3] (global coords), ``yaw``
    f32[n_dev, N], ``dirty`` and ``alive`` bool[n_dev, N].

    Returns ghost blocks of 2*halo_cap rows per tile (left-neighbor
    ghosts, then right-neighbor ghosts): (gpos f32[n_dev, 2H, 3], gyaw,
    gdirty, gvalid, ggid i32 = owner * N + slot), plus ``strip_demand``
    i32[n_dev], the true occupancy of each tile's fuller inward-facing
    strip (an alarm when it exceeds halo_cap).
    """
    n = pos.shape[1]
    dev = pos.device
    d = torch.arange(n_dev, dtype=torch.int32, device=dev)
    tile_min = _tile_mins(d, tile_w)[:, None]
    x = pos[..., 0]
    gid = _local_gid(n_dev, n, n, dev)

    left_pack, left_demand = _pack(
        alive & (x < tile_min + _f32(radius, dev)), pos, yaw, dirty, gid,
        halo_cap)
    right_pack, right_demand = _pack(
        alive & (x >= tile_min + _f32(tile_w, dev) - _f32(radius, dev)),
        pos, yaw, dirty, gid, halo_cap)
    # edge tiles do not ship their outward strip: keep it out of the
    # capacity alarm
    strip_demand = torch.maximum(
        torch.where(d > 0, left_demand, 0),
        torch.where(d < n_dev - 1, right_demand, 0))

    # my left strip is a ghost for tile d-1, my right strip for d+1;
    # edge tiles receive zeros
    from_right = _ship(-1, left_pack,
                       [t < n_dev - 1 for t in range(n_dev)], impl)
    from_left = _ship(+1, right_pack, [t > 0 for t in range(n_dev)], impl)

    parts = (from_left, from_right)
    gvalid = _cat(parts, 3)
    ggid = torch.where(gvalid, _cat(parts, 4), 0)
    return (_cat(parts, 0), _cat(parts, 1), _cat(parts, 2), gvalid, ggid,
            strip_demand)


def exchange_halo_2d(shape: tuple[int, int], n_per_dev: int, pos, yaw,
                     dirty, alive, tile_w: float, tile_d: float,
                     radius: float, halo_cap: int, impl: str = "ppermute"):
    """Two-phase 8-neighbor halo for 2D (XZ) tiles.

    Tile ``d`` is ``(ix, iz) = (d // tz, d % tz)``. Phase 1 ships the
    west/east strips; phase 2 ships the north/south strips of the
    combined region (local rows plus phase-1 ghosts), so corner
    neighbors arrive through it. Ghost blocks are 4*halo_cap rows per
    tile (west, east, north, south). Arguments and returns as
    :func:`exchange_halo`; ``strip_demand`` is the max true occupancy
    over each tile's inward-facing strips.
    """
    tx, tz = shape
    n_dev = tx * tz
    n = pos.shape[1]
    dev = pos.device
    d = torch.arange(n_dev, dtype=torch.int32, device=dev)
    ix, iz = d // tz, d % tz
    tmin_x = _tile_mins(ix, tile_w)[:, None]
    tmin_z = _tile_mins(iz, tile_d)[:, None]
    r = _f32(radius, dev)
    x, z = pos[..., 0], pos[..., 2]
    local_gid = _local_gid(n_dev, n_per_dev, n, dev)
    ixs = [t // tz for t in range(n_dev)]
    izs = [t % tz for t in range(n_dev)]

    # phase 1: x strips over the flat axis (stride tz)
    west_pack, west_dem = _pack(alive & (x < tmin_x + r), pos, yaw, dirty,
                                local_gid, halo_cap)
    east_pack, east_dem = _pack(
        alive & (x >= tmin_x + _f32(tile_w, dev) - r), pos, yaw, dirty,
        local_gid, halo_cap)
    from_east = _ship(-tz, west_pack, [i < tx - 1 for i in ixs], impl)
    from_west = _ship(+tz, east_pack, [i > 0 for i in ixs], impl)

    # phase 2: z strips of local rows plus phase-1 ghosts
    combined = [torch.cat([own, w, e], dim=1) for own, w, e in zip(
        (pos, yaw, dirty, alive, local_gid), from_west, from_east)]
    cpos, cyaw, cdirty, cvalid, cgid = combined
    cz = cpos[..., 2]
    north_pack, north_dem = _pack(cvalid & (cz < tmin_z + r), cpos, cyaw,
                                  cdirty, cgid, halo_cap)
    south_pack, south_dem = _pack(
        cvalid & (cz >= tmin_z + _f32(tile_d, dev) - r), cpos, cyaw,
        cdirty, cgid, halo_cap)
    from_south = _ship(-1, north_pack, [i < tz - 1 for i in izs], impl)
    from_north = _ship(+1, south_pack, [i > 0 for i in izs], impl)

    parts = (from_west, from_east, from_north, from_south)
    gvalid = _cat(parts, 3)
    ggid = torch.where(gvalid, _cat(parts, 4), 0)
    # inward-facing strips only: world-edge outward strips never ship
    strip_demand = torch.stack([
        torch.where(ix > 0, west_dem, 0),
        torch.where(ix < tx - 1, east_dem, 0),
        torch.where(iz > 0, north_dem, 0),
        torch.where(iz < tz - 1, south_dem, 0),
    ]).amax(0)
    return (_cat(parts, 0), _cat(parts, 1), _cat(parts, 2), gvalid, ggid,
            strip_demand)
