"""Ghost exchange across tile borders, the port of
``goworld_tpu/parallel/halo.py``.

Every tile of a megaspace sees the ``radius``-wide boundary strips of
its neighbor tiles as ghosts: each strip is extracted into a bounded
block of ``halo_cap`` rows (surplus rows are dropped from the
neighbor's view that tick, in slot order, and the demand gauge reports
the true occupancy) and shipped to the neighbor.

The JAX function runs once per device under ``shard_map``; here all
tiles live on one device with a leading ``[n_dev]`` axis, so each
function takes and returns stacked tensors. An exchange is one phase
(1D) or two (2D); a phase ships two directions (:class:`Ring`) for all
tiles. Two ship impls, bit-identical (``halo_impl``):

* ``"async"``: one launch of the CUDA kernel of ``csrc/halo_ship.cu``
  a phase (:func:`ship_phase`), which replaces the Pallas
  ``make_async_remote_copy`` ring ``_async_ship``: it reads each strip
  row where it lies (phase 2's from the phase-1 ghosts already in the
  block) and writes the receiver's ghost lanes in place into a block
  allocated once per exchange. Its plain version
  (:func:`ship_phase_plain`) is the JAX package's composition: gather,
  pack into one i32[n_dev, H, 5] buffer, ring, unpack;
* ``"ppermute"``: each lane of the gathered strip moves unpacked through
  :func:`ship_ring_plain` (``torch.roll`` over the tile axis and a mask),
  which is what ``lax.ppermute`` with a non-periodic pair list computes;
  phase 2 gathers from the local and phase-1 ghost lanes concatenated,
  and the directions' lanes are concatenated at the end.

Invalid ghost gids are normalised to 0 and the yaw lane is gated on
dirty under both impls; that keeps them bit-identical.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops.aoi import _f32
from goworld_tpu_torch.ops.extract import bounded_extract_batched

HALO_IMPLS = ("ppermute", "async")

# packed meta word: (gid + 1) << 2 | dirty << 1 | valid. gid is in [-1,
# gid_sentinel], so the +1 keeps it non-negative and the pack is exact
# while gid_sentinel + 1 < 2^29 (MegaConfig guards the bound).
_META_GID_BITS = 29
# tiles a phase kernel launch takes (the bits of its receiver masks)
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
    """One lane of any type shipped ``shift`` tiles along the periodic
    ring: ``out[t] = bufs[(t - shift) % n_dev]`` where ``recv_ok[t]``,
    else zeros."""
    out = torch.roll(bufs, shift, dims=0)
    for t, ok in enumerate(recv_ok):
        if not ok:
            out[t].zero_()
    return out


@dataclasses.dataclass(frozen=True)
class Ring:
    """One ship direction: receiver ``t`` takes the strip of tile ``(t -
    shift) % n_dev`` where ``recv_ok[t]`` (a bool per tile), else
    zeros. The receivers depend on the tile index only, so the host
    never waits on the card for them."""

    shift: int
    recv_ok: tuple[bool, ...]

    @functools.cached_property
    def mask(self) -> int:
        """The receivers as a bitmask (bit t: tile t receives)."""
        return sum(1 << t for t, ok in enumerate(self.recv_ok) if ok)


@functools.cache
def rings_1d(n_dev: int) -> tuple[Ring, Ring]:
    """The 1D phase: right strips to the right neighbor (its
    left-neighbor ghosts), then left strips to the left neighbor; edge
    tiles receive zeros."""
    t = range(n_dev)
    return (Ring(1, tuple(i > 0 for i in t)),
            Ring(-1, tuple(i < n_dev - 1 for i in t)))


@functools.cache
def rings_2d(tx: int, tz: int) -> tuple[tuple[Ring, Ring], tuple[Ring, Ring]]:
    """The two 2D phases over tile ``d = ix * tz + iz``: east strips
    east and west strips west (west then east ghosts), then south strips
    south and north strips north (north then south ghosts)."""
    ix = [d // tz for d in range(tx * tz)]
    iz = [d % tz for d in range(tx * tz)]
    return ((Ring(tz, tuple(i > 0 for i in ix)),
             Ring(-tz, tuple(i < tx - 1 for i in ix))),
            (Ring(1, tuple(i > 0 for i in iz)),
             Ring(-1, tuple(i < tz - 1 for i in iz))))


def _gather_strip(src, flat, valid):
    """Each tile's bounded strip ``(pos, yaw, dirty, valid, gid)``: rows
    ``flat[t, j]`` where ``valid[t, j]`` of the tile's source lanes ``src
    = (pos, yaw, dirty, gid)``, zeros (gid -1) elsewhere, as the JAX
    package gathers it."""
    pos, yaw, dirty, gid = src
    slots = torch.where(valid, flat, 0).long()
    sel_dirty = torch.gather(dirty, 1, slots) & valid
    sel_pos = torch.gather(pos, 1, slots[..., None].expand(-1, -1, 3))
    return (
        torch.where(valid[..., None], sel_pos, 0.0),
        torch.where(sel_dirty, torch.gather(yaw, 1, slots), 0.0),
        sel_dirty,
        valid,
        torch.where(valid, torch.gather(gid, 1, slots), -1),
    )


def ship_phase_plain(src, strips, out, col0: int) -> None:
    """Plain version of :func:`ship_phase`: per direction the strip is
    gathered from the own lanes followed by ``out``'s columns ``[0,
    col0)``, packed into one i32[n_dev, H, 5] buffer, shipped by
    :func:`ship_ring_plain`, unpacked, its gid normalised, and written
    into ``out``."""
    h = strips[0][1].shape[1]
    if col0:
        ghost = (out[0], out[1], out[2], out[4])
        src = [torch.cat([s, g[:, :col0]], dim=1) for s, g in zip(src, ghost)]
    for k, (ring, flat, count) in enumerate(strips):
        valid = torch.arange(h, dtype=torch.int32, device=flat.device) \
            < torch.clamp_max(count, h)[:, None]
        lanes = _unpack_strip(ship_ring_plain(
            _pack_strip(*_gather_strip(src, flat, valid)), ring.shift,
            ring.recv_ok))
        cols = slice(col0 + k * h, col0 + (k + 1) * h)
        for dst, lane in zip(out[:4], lanes[:4]):
            dst[:, cols] = lane
        out[4][:, cols] = torch.where(lanes[3], lanes[4], 0)


def _ship_lanes(src, flat, valid, ring: Ring):
    """The ``"ppermute"`` ship of one direction: each lane of the
    gathered strip through :func:`ship_ring_plain`."""
    return tuple(ship_ring_plain(x, ring.shift, ring.recv_ok)
                 for x in _gather_strip(src, flat, valid))


def _cat(parts, i):
    return torch.cat([p[i] for p in parts], dim=1)


def _ghosts(parts):
    """The ``"ppermute"`` ghost block: the directions' shipped lanes
    concatenated, invalid gids normalised to 0."""
    gvalid = _cat(parts, 3)
    return (_cat(parts, 0), _cat(parts, 1), _cat(parts, 2), gvalid,
            torch.where(gvalid, _cat(parts, 4), 0))


_SRC = (("pos", torch.float32, (3,)), ("yaw", torch.float32, ()),
        ("dirty", torch.bool, ()), ("gid", torch.int32, ()))
_OUT = (("gpos", torch.float32, (3,)), ("gyaw", torch.float32, ()),
        ("gdirty", torch.bool, ()), ("gvalid", torch.bool, ()),
        ("ggid", torch.int32, ()))


def _check_phase(src, strips, out, col0: int) -> None:
    """Reject what the phase kernel does not take (on every device, so
    that the CPU runs the same checks)."""
    if len(src) != 4 or len(out) != 5 or len(strips) != 2:
        raise ValueError("a phase takes 4 source lanes, 5 output lanes and "
                         "2 strips")
    n_dev, m = src[0].shape[:2]
    g = out[0].shape[1]
    dev = src[0].device
    lanes = [(t, name, dt, (n_dev, m, *tail))
             for t, (name, dt, tail) in zip(src, _SRC)]
    lanes += [(t, name, dt, (n_dev, g, *tail))
              for t, (name, dt, tail) in zip(out, _OUT)]
    h = strips[0][1].shape[-1]
    for k, (ring, flat, count) in enumerate(strips):
        lanes.append((count, f"count{k}", torch.int32, (n_dev,)))
        if flat.dtype != torch.int32:
            raise TypeError(f"flat{k}: expected torch.int32, got "
                            f"{flat.dtype}")
        if tuple(flat.shape) != (n_dev, h) or flat.stride(-1) != 1:
            raise ValueError(f"flat{k}: expected [{n_dev}, {h}] with unit "
                             f"row stride, got {tuple(flat.shape)} strides "
                             f"{flat.stride()}")
        if flat.device != dev:
            raise ValueError(f"flat{k} lies on {flat.device}, not {dev}")
        if len(ring.recv_ok) != n_dev:
            raise ValueError(f"ring {k} has {len(ring.recv_ok)} receiver "
                             f"flags for {n_dev} tiles")
    for t, name, dt, shape in lanes:
        kernels.require(t, name, dt, shape)
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, not {dev}")
    if not 1 <= n_dev <= MAX_SHIP_TILES:
        raise ValueError(f"the phase kernel takes 1..{MAX_SHIP_TILES} "
                         f"tiles, got {n_dev}")
    if not 0 <= col0 <= g - 2 * h:
        raise ValueError(f"columns [{col0}, {col0 + 2 * h}) outside the "
                         f"ghost block's {g}")


def ship_phase(src, strips, out, col0: int) -> None:
    """One exchange phase for all tiles, written in place into the ghost
    block ``out`` at columns ``[col0, col0 + 2H)``. The CUDA kernel of
    ``csrc/halo_ship.cu`` for tensors on the card (one launch); the plain
    version :func:`ship_phase_plain` for tensors on the CPU.

    Args:
      src: the tiles' own lanes ``(pos f32[n_dev, M, 3], yaw f32[n_dev,
        M], dirty bool[n_dev, M], gid i32[n_dev, M])``, contiguous.
      strips: two ``(ring, flat, count)``: a :class:`Ring` and the strip's
        extraction as ``bounded_extract_batched`` returns it (``flat``
        i32[n_dev, H] with unit row stride, ``count`` i32[n_dev]; rows
        past ``min(count, H)`` are not read). A slot ``s >= M`` names row
        ``s - M`` of ``out``'s columns ``[0, col0)``.
      out: the ghost block ``(gpos f32[n_dev, G, 3], gyaw f32[n_dev, G],
        gdirty bool, gvalid bool, ggid i32[n_dev, G])``, contiguous;
        direction k fills columns ``col0 + k*H`` to ``col0 + (k+1)*H``.
      col0: the phase's first output column.
    """
    _check_phase(src, strips, out, col0)
    dev = src[0].device
    if dev.type == "cpu":
        ship_phase_plain(src, strips, out, col0)
        return
    if dev.type != "cuda":
        raise ValueError(f"ship_phase: unsupported device {dev}")
    n_dev, m = src[0].shape[:2]
    (r0, flat0, count0), (r1, flat1, count1) = strips
    if flat0.shape[1] == 0:
        return
    err = kernels.lib().gw_halo_ship_phase(
        *(t.data_ptr() for t in src), m, *(t.data_ptr() for t in out),
        out[0].shape[1], n_dev, flat0.shape[1], col0,
        flat0.data_ptr(), flat0.stride(0), count0.data_ptr(),
        r0.shift % n_dev, r0.mask,
        flat1.data_ptr(), flat1.stride(0), count1.data_ptr(),
        r1.shift % n_dev, r1.mask,
        kernels.stream_handle(dev))
    kernels.check(err, "ship_phase")
    kernels.LAUNCHES["halo_ship_phase"] += 1


def _check_impl(impl: str) -> None:
    if impl not in HALO_IMPLS:
        raise ValueError(f"halo_impl {impl!r} not in {HALO_IMPLS}")


def _empty_ghosts(n_dev: int, rows: int, dev):
    """The ghost block of an exchange; every row is written by its
    phases."""
    return (torch.empty((n_dev, rows, 3), dtype=torch.float32, device=dev),
            torch.empty((n_dev, rows), dtype=torch.float32, device=dev),
            torch.empty((n_dev, rows), dtype=torch.bool, device=dev),
            torch.empty((n_dev, rows), dtype=torch.bool, device=dev),
            torch.empty((n_dev, rows), dtype=torch.int32, device=dev))


def _tile_mins(idx: torch.Tensor, width: float) -> torch.Tensor:
    """Each tile's lower edge, in float32 as the JAX package computes it
    (an f32 index times the weakly typed width)."""
    return idx.to(torch.float32) * _f32(width, idx.device)


def _local_gid(n_dev: int, n_per_dev: int, n: int, dev) -> torch.Tensor:
    d = torch.arange(n_dev, dtype=torch.int32, device=dev)
    return d[:, None] * n_per_dev \
        + torch.arange(n, dtype=torch.int32, device=dev)[None, :]


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
    _check_impl(impl)
    n = pos.shape[1]
    dev = pos.device
    d = torch.arange(n_dev, dtype=torch.int32, device=dev)
    tile_min = _tile_mins(d, tile_w)[:, None]
    x = pos[..., 0]
    src = (pos, yaw, dirty, _local_gid(n_dev, n, n, dev))

    left_flat, left_valid, left_demand = bounded_extract_batched(
        alive & (x < tile_min + _f32(radius, dev)), halo_cap)
    right_flat, right_valid, right_demand = bounded_extract_batched(
        alive & (x >= tile_min + _f32(tile_w, dev) - _f32(radius, dev)),
        halo_cap)
    # edge tiles do not ship their outward strip: keep it out of the
    # capacity alarm
    strip_demand = torch.maximum(
        torch.where(d > 0, left_demand, 0),
        torch.where(d < n_dev - 1, right_demand, 0))

    # my right strip is a ghost for tile d+1, my left strip for d-1
    from_left, from_right = rings_1d(n_dev)
    if impl == "async":
        out = _empty_ghosts(n_dev, 2 * halo_cap, dev)
        ship_phase(src, ((from_left, right_flat, right_demand),
                         (from_right, left_flat, left_demand)), out, 0)
    else:
        out = _ghosts([_ship_lanes(src, right_flat, right_valid, from_left),
                       _ship_lanes(src, left_flat, left_valid, from_right)])
    return (*out, strip_demand)


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
    _check_impl(impl)
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
    src = (pos, yaw, dirty, _local_gid(n_dev, n_per_dev, n, dev))
    (from_west, from_east), (from_north, from_south) = rings_2d(tx, tz)

    # phase 1: x strips over the flat axis (stride tz)
    west_flat, west_valid, west_dem = bounded_extract_batched(
        alive & (x < tmin_x + r), halo_cap)
    east_flat, east_valid, east_dem = bounded_extract_batched(
        alive & (x >= tmin_x + _f32(tile_w, dev) - r), halo_cap)
    # phase 2: z strips of local rows plus the phase-1 ghosts
    lo, hi = tmin_z + r, tmin_z + _f32(tile_d, dev) - r
    if impl == "async":
        out = _empty_ghosts(n_dev, 4 * halo_cap, dev)
        ship_phase(src, ((from_west, east_flat, east_dem),
                         (from_east, west_flat, west_dem)), out, 0)
        # the phase-1 ghosts are the block's first 2H columns: only the
        # masks are concatenated
        h2 = 2 * halo_cap
        gz, gvalid = out[0][:, :h2, 2], out[3][:, :h2]
        north_flat, _, north_dem = bounded_extract_batched(torch.cat(
            [alive & (z < lo), gvalid & (gz < lo)], dim=1), halo_cap)
        south_flat, _, south_dem = bounded_extract_batched(torch.cat(
            [alive & (z >= hi), gvalid & (gz >= hi)], dim=1), halo_cap)
        ship_phase(src, ((from_north, south_flat, south_dem),
                         (from_south, north_flat, north_dem)), out, h2)
    else:
        west = _ship_lanes(src, east_flat, east_valid, from_west)
        east = _ship_lanes(src, west_flat, west_valid, from_east)
        cpos, cyaw, cdirty, cvalid, cgid = (
            torch.cat([own, w, e], dim=1) for own, w, e in zip(
                (pos, yaw, dirty, alive, src[3]), west, east))
        cz = cpos[..., 2]
        north_flat, north_valid, north_dem = bounded_extract_batched(
            cvalid & (cz < lo), halo_cap)
        south_flat, south_valid, south_dem = bounded_extract_batched(
            cvalid & (cz >= hi), halo_cap)
        csrc = (cpos, cyaw, cdirty, cgid)
        out = _ghosts([west, east,
                       _ship_lanes(csrc, south_flat, south_valid, from_north),
                       _ship_lanes(csrc, north_flat, north_valid, from_south)])

    # inward-facing strips only: world-edge outward strips never ship
    strip_demand = torch.stack([
        torch.where(ix > 0, west_dem, 0),
        torch.where(ix < tx - 1, east_dem, 0),
        torch.where(iz > 0, north_dem, 0),
        torch.where(iz < tz - 1, south_dem, 0),
    ]).amax(0)
    return (*out, strip_demand)
