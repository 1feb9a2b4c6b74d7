"""Batched AOI (area-of-interest) neighbor search, the port of
``goworld_tpu/ops/aoi.py``.

Interest is Chebyshev in the XZ plane: B is in A's AOI iff ``|dx| <=
r`` and ``|dz| <= r``. One uniform-grid sweep per tick:

1. bin entities into ``radius``-sized cells with one always-empty border
   ring (``_cell_rows``),
2. order slots by cell row with a stable sort (``_sort_cells``),
3. lay the sorted entities out as a component-major view with sentinel
   padding, and find each query's three contiguous z-triple runs
   (``_build_ranges``, ``_query_runs``),
4. back half: per query, the candidates of the 3x3 window are ranked by
   packed (quantized distance, id, flags) keys and the k smallest kept.

The back half comes in two forms with bit-identical results:
``sweep_impl="ranges"`` in plain torch ops block by block, and
``sweep_impl="fused"`` as one CUDA kernel (``csrc/aoi_fused.cu``,
wrapper :func:`sweep_fused_cuda`). ``sort_impl="pallas"`` names the
CUDA counting sort (the knob keeps the JAX package's value names so that
one config means the same on both sides).

Slot words (``(id << 2) | flags``) stay an int32 tensor beside the float
coordinates: as float32 bit patterns every one of them is subnormal, and
a float op under flush-to-zero would zero the ids.

``precision="q16"`` sweeps positions snapped onto a power-of-two
lattice (:func:`quantize_positions`); the ``ranges`` back half then
streams one packed ``(qx << 16) | qz`` int32 a candidate, with the same
results. ``skin > 0`` adds Verlet reuse (:func:`grid_neighbors_verlet`):
a candidate cache rebuilt by a padded sweep when entities have moved
more than ``skin/2``, and re-ranked at the current positions every
tick. The JAX package's uint32 words (the packed id cache) are held
here as the same bits in int32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops.batch import bin_counts, space_base, take
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
    row_starts,
)
from goworld_tpu_torch.utils import consts

# Packed ranking keys (n < 2^21 path), as in the JAX package:
#   with flags:    key = (qd8 << 23) | (id << 2) | flags,   qd8  in [1, 254]
#   without flags: key = (qd10 << 21) | id,                 qd10 in [0, 1023]
_ID_BITS = consts.AOI_ID_BITS
_ID_MASK = (1 << _ID_BITS) - 1
_WORD_MASK = (1 << 23) - 1
_QD_MAX = 254

ROADMAP_HINT = "not ported yet; see ROADMAP.md Queue A"


def _log2_ceil(x: float) -> int:
    """Exact ceil(log2(x)) for positive floats (frexp, no log
    rounding)."""
    m, e = math.frexp(x)
    return e - 1 if m == 0.5 else e


# precision=q16 lattice quantizer: one for the sweep, the Verlet re-rank
# and the tick's snap, so the domains never disagree
def _lattice(spec: "GridSpec", pos: torch.Tensor):
    """(qx, qz): x and z in lattice steps, floored and clamped to
    [0, 2^15 - 1], as float32 (exact: a multiply by a power of two)."""
    hi = float((1 << consts.PRECISION_POS_BITS) - 1)
    inv = 1.0 / spec.quant_step
    return tuple(torch.clamp(torch.floor(pos[..., c] * inv), 0.0, hi)
                 for c in (0, 2))


def quantize_positions(spec: "GridSpec", pos: torch.Tensor) -> torch.Tensor:
    """Snap x and z onto the precision lattice (float32 values on the
    lattice; y passes through). Identity when precision is off,
    idempotent otherwise."""
    if spec.precision == "off":
        return pos
    qx, qz = _lattice(spec, pos)
    step = spec.quant_step
    return torch.stack([qx * step, pos[..., 1], qz * step], dim=-1)


def quantize_xz_i32(spec: "GridSpec", pos: torch.Tensor) -> torch.Tensor:
    """The packed lattice plane: ``(qx << 16) | qz``, one nonnegative
    int32 an entity (qx, qz < 2^15)."""
    qx, qz = _lattice(spec, pos)
    return (qx.to(torch.int32) << 16) | qz.to(torch.int32)


def _q16_dist(spec: "GridSpec", qxz_a, qxz_b) -> torch.Tensor:
    """Chebyshev distance between packed lattice coordinates as the
    exact float32 ``int_diff * quant_step``: bit for bit
    ``max(|ax-bx|, |az-bz|)`` over the snapped float32 positions."""
    dq = torch.maximum(((qxz_a >> 16) - (qxz_b >> 16)).abs(),
                       ((qxz_a & 0xFFFF) - (qxz_b & 0xFFFF)).abs())
    return dq.to(torch.float32) * spec.quant_step


# 21-bit id triplets: the Verlet cache's cand plane under q16 holds 3
# ids of <= 21 bits in 2 words (the JAX package's uint32 words, here
# their int32 bit patterns)
_ID21_MASK = (1 << 21) - 1


def packed_cand_words(v: int) -> int:
    """Words a row of a packed V-lane candidate cache."""
    return 2 * ((v + 2) // 3)


def pack_ids21(ids: torch.Tensor, pad_value: int) -> torch.Tensor:
    """int32 ids [..., V] (each < 2^21) to [..., 2*ceil(V/3)] packed
    words, pad lanes filled with ``pad_value``. Word 0 of a triplet is
    ``a | (b << 21)`` (its top bit, bit 10 of b, is the int32 sign bit),
    word 1 ``(b >> 11) | (c << 10)``."""
    *lead, v = ids.shape
    pad = (-v) % 3
    if pad:
        ids = torch.cat([ids, torch.full((*lead, pad), pad_value,
                                         dtype=ids.dtype,
                                         device=ids.device)], dim=-1)
    t = ids.to(torch.int32).reshape(*lead, -1, 3)
    a, b, c = t[..., 0], t[..., 1], t[..., 2]
    w0 = a | ((b & 0x3FF) << 21) \
        | torch.where((b & 0x400) != 0, -(1 << 31), 0).to(torch.int32)
    w1 = (b >> 11) | (c << 10)
    return torch.stack([w0, w1], dim=-1).reshape(*lead, -1)


def unpack_ids21(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_ids21`; the pad lanes stay (they carry the
    sentinel and rank as invalid). Every right shift of an int32 word
    is masked, since ``>>`` sign-extends."""
    *lead, _w = words.shape
    t = words.reshape(*lead, -1, 2)
    w0, w1 = t[..., 0], t[..., 1]
    a = w0 & _ID21_MASK
    b = ((w0 >> 21) & 0x7FF) | ((w1 & 0x3FF) << 11)
    c = (w1 >> 10) & _ID21_MASK
    return torch.stack([a, b, c], dim=-1).reshape(*lead, -1)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static AOI configuration, field for field the JAX package's
    ``GridSpec`` with the same knob names, value sets and validation.

    The world is the XZ rectangle ``[origin, origin + extent)``;
    positions outside clamp into the edge cells. Knob values this port
    does not run yet are accepted here (so one config means the same on
    both sides) and rejected with ``NotImplementedError`` by the sweep.
    """

    radius: float
    origin_x: float = 0.0
    origin_z: float = 0.0
    extent_x: float = 1024.0
    extent_z: float = 1024.0
    k: int = consts.DEFAULT_MAX_NEIGHBORS
    cell_cap: int = consts.DEFAULT_CELL_CAP
    row_block: int = consts.DEFAULT_ROW_BLOCK
    topk_impl: str = consts.DEFAULT_TOPK_IMPL
    sweep_impl: str = consts.DEFAULT_SWEEP_IMPL
    sort_impl: str = consts.DEFAULT_SORT_IMPL
    skin: float = consts.DEFAULT_AOI_SKIN
    verlet_cap: int = 0
    rebuild_every_max: int = 0
    precision: str = consts.DEFAULT_PRECISION

    def __post_init__(self):
        if self.topk_impl not in ("exact", "sort", "f32", "approx"):
            raise ValueError(
                f"topk_impl must be exact|sort|f32|approx, "
                f"got {self.topk_impl!r}"
            )
        if self.sweep_impl not in ("table", "ranges", "cellrow",
                                   "shift", "fused"):
            raise ValueError(
                f"sweep_impl must be table|ranges|cellrow|shift|fused, "
                f"got {self.sweep_impl!r}"
            )
        if self.sort_impl not in ("argsort", "counting", "pallas"):
            raise ValueError(
                f"sort_impl must be argsort|counting|pallas, "
                f"got {self.sort_impl!r}"
            )
        if not self.skin >= 0.0:
            raise ValueError(
                f"skin must be >= 0 (0 disables Verlet reuse), "
                f"got {self.skin!r}"
            )
        if self.verlet_cap < 0 or 0 < self.verlet_cap < self.k:
            raise ValueError(
                f"verlet_cap must be 0 (= auto k + k//2) or >= k "
                f"(={self.k}), got {self.verlet_cap!r}"
            )
        if self.rebuild_every_max < 0:
            raise ValueError(
                f"rebuild_every_max must be >= 0 (0 = displacement-"
                f"driven only), got {self.rebuild_every_max!r}"
            )
        if self.precision not in ("off", "q16"):
            raise ValueError(
                f"precision must be off|q16, got {self.precision!r}"
            )
        if self.precision != "off":
            if self.origin_x != 0.0 or self.origin_z != 0.0:
                raise ValueError(
                    "precision=q16 requires origin_x == origin_z == 0 "
                    "(lattice arithmetic is origin-free; shift the "
                    f"world), got ({self.origin_x!r}, {self.origin_z!r})"
                )
            step = self.quant_step
            if not step > 0.0 or not math.isfinite(step):
                raise ValueError(
                    f"precision=q16 rejected: degenerate lattice step "
                    f"{step!r} from extents ({self.extent_x!r}, "
                    f"{self.extent_z!r})"
                )
            if step > self.radius / 4.0:
                raise ValueError(
                    f"precision=q16 rejected: int16 lattice step "
                    f"{step!r} over extent "
                    f"{max(self.extent_x, self.extent_z)!r} exceeds "
                    f"radius/4 ({self.radius / 4.0!r}) — at 2^"
                    f"{consts.PRECISION_POS_BITS} points/axis this "
                    "resolution could flip a cell assignment or reach "
                    "comparison vs the f32 world; shrink the extent or "
                    "raise the radius"
                )
        if self.skin > 0 and self.verlet_cap_eff > 9 * self.cell_cap:
            raise ValueError(
                f"verlet_cap (effective {self.verlet_cap_eff}) must be "
                f"<= 9*cell_cap ({9 * self.cell_cap}) — raise cell_cap "
                f"or lower verlet_cap/k"
            )

    @property
    def cell_size(self) -> float:
        """Grid cell edge (``radius + skin``; under precision=q16 rounded
        up to a power-of-two multiple of the lattice step)."""
        if self.precision != "off":
            return self.quant_step * (1 << self.quant_cell_shift)
        return self.radius + self.skin

    @property
    def quant_step(self) -> float:
        """precision=q16 lattice step: the smallest power of two with
        <= 2^PRECISION_POS_BITS lattice points across the larger
        extent."""
        ext = max(self.extent_x, self.extent_z)
        return 2.0 ** (_log2_ceil(ext) - consts.PRECISION_POS_BITS)

    @property
    def quant_cell_shift(self) -> int:
        """log2(cell edge / lattice step) under precision=q16."""
        return max(0, _log2_ceil(
            (self.radius + self.skin) / self.quant_step))

    @property
    def quant_bits(self) -> int:
        """Lattice points/axis as bits (0 when precision is off)."""
        return consts.PRECISION_POS_BITS if self.precision != "off" \
            else 0

    @property
    def verlet_cap_eff(self) -> int:
        """``verlet_cap`` resolved: 0 = auto ``k + k//2``."""
        return self.verlet_cap if self.verlet_cap > 0 \
            else self.k + self.k // 2

    @property
    def cells_x(self) -> int:
        return max(1, int(-(-self.extent_x // self.cell_size)))

    @property
    def cells_z(self) -> int:
        return max(1, int(-(-self.extent_z // self.cell_size)))


def check_ported(spec: GridSpec) -> None:
    """Raise ``NotImplementedError`` for a knob value this port does not
    run yet. It never substitutes another path."""
    if spec.sweep_impl not in ("ranges", "fused", "table"):
        raise NotImplementedError(
            f"sweep_impl={spec.sweep_impl!r} {ROADMAP_HINT}")
    if spec.topk_impl == "approx":
        raise NotImplementedError(f"topk_impl='approx' {ROADMAP_HINT}")


def _f32(x: float, dev) -> torch.Tensor:
    """A 0-d float32 tensor made on ``dev`` by a fill (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=dev)


def _cell_rows(spec: GridSpec, pos, alive, watch_radius):
    """Front half, stage 1: per-entity padded cell-row ids.

    The divide is by a 0-d float32 tensor: a divide by a Python scalar
    may become a multiply by its reciprocal on the card, which can move
    a floor across a cell edge."""
    dev = pos.device
    czp = spec.cells_z + 2
    cxp = spec.cells_x + 2
    n_rows = cxp * czp
    if watch_radius is not None:
        # radius-0 entities leave the candidate pool here
        alive = alive & (watch_radius > 0.0)
    cs = _f32(spec.cell_size, dev)

    def cell(col, origin, cells):
        # clamp in float before the cast, so no out-of-range float is
        # ever converted (same result as the JAX cast-then-clip)
        c = torch.floor((pos[..., col] - origin) / cs)
        return torch.clamp(c, 0, cells - 1).to(torch.int32)

    cx = cell(0, spec.origin_x, spec.cells_x)
    cz = cell(2, spec.origin_z, spec.cells_z)
    row = (cx + 1) * czp + (cz + 1)
    srow = torch.where(alive, row, n_rows).to(torch.int32)
    return cx, cz, srow, alive, czp, n_rows


def _sort_cells(n_rows: int, srow, sort_impl: str):
    """Front half, stage 2: slots ordered by cell row. Every impl is
    stable and therefore gives the same result."""
    if sort_impl == "pallas":
        return counting_sort_cells_cuda(srow, n_rows)
    if sort_impl == "counting":
        return counting_sort_cells(srow, n_rows)
    order = torch.argsort(srow, dim=-1, stable=True).to(torch.int32)
    return order, take(srow, order, srow.dim() - 1)


def _sorted_src(pos, flag_bits, order):
    """Front half, stage 3: sorted x, z and packed slot words. The word
    carries the slot id plus the caller's flag bits, so consumers never
    gather them per neighbor. Returns (px, pz, word, table sentinel)."""
    n = pos.shape[-2]
    nb = pos.dim() - 2
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    if flag_bits is not None:
        word = (idx << 2) | (flag_bits.to(torch.int32) & 3)
        table_sentinel = n << 2
    else:
        word = idx.expand(pos.shape[:-1])
        table_sentinel = n
    return (take(pos[..., 0], order, nb), take(pos[..., 2], order, nb),
            take(word, order, nb), table_sentinel)


def _build_ranges(cc: int, n_rows: int, srow, px, pz, word,
                  table_sentinel: int):
    """Front half, stage 4: row_start offsets plus the padded
    component-major sorted view: ``s_xz`` f32[2, n + 3cc] and ``s_w``
    i32[n + 3cc], with 3cc sentinel lanes so that every run is in
    bounds (each Space's own tail under a leading Space axis)."""
    row_start = row_starts(srow, n_rows)
    dev = px.device
    lead = px.shape[:-1]
    pad = torch.full((*lead, 3 * cc), math.inf, dtype=torch.float32,
                     device=dev)
    s_xz = torch.stack([torch.cat([px, pad], -1),
                        torch.cat([pz, pad], -1)], dim=-2)
    s_w = torch.cat([word, torch.full((*lead, 3 * cc), table_sentinel,
                                      dtype=torch.int32, device=dev)], -1)
    return row_start, s_xz, s_w


def _build_table(cc: int, n_rows: int, sorted_row, row_start, px, pz,
                 word, table_sentinel: int):
    """Front half, stage 4 of ``sweep_impl="table"``: the dense per-cell
    table, each cell's first ``cc`` entities in sort order (their rank
    in the cell is the sorted position less the cell's start) with
    their x, z and packed word side by side, +inf and the sentinel word
    in empty lanes. Returns ``(x, z)`` f32[n_rows, cc] and the words
    i32[n_rows, cc] (each Space's own under a leading Space axis)."""
    n = sorted_row.shape[-1]
    nb = sorted_row.dim() - 1
    lead = sorted_row.shape[:-1]
    dev = sorted_row.device
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - take(row_start, sorted_row, nb)
    valid = (rank < cc) & (sorted_row < n_rows)
    size = n_rows * cc + 1           # the last lane takes the rest
    flat = torch.where(valid, sorted_row * cc + rank, n_rows * cc) \
        + space_base(lead, size, dev)
    flat = flat.reshape(-1).long()

    def table(src, empty):
        t = torch.full((flat.numel() // n * size,), empty, dtype=src.dtype,
                       device=dev)
        t.scatter_(0, flat, src.reshape(-1))
        return t.reshape(*lead, size)[..., :-1].reshape(*lead, n_rows, cc)

    return (table(px, math.inf), table(pz, math.inf),
            table(word, table_sentinel))


def _table_window(table, cx, cz, alive, rows, czp: int):
    """The candidates of query ``rows`` read from the table: the three
    z-triples of cells around each query's cell (an excluded query reads
    the border rows at 0, all empty), 9 rows of ``cc`` lanes in the
    reference's order. Returns (x, z, words), each ``[..., B, 9cc]``."""
    nb = cx.dim() - 1
    dxs = torch.arange(-1, 2, dtype=torch.int32, device=cx.device)
    starts = (cx[..., rows, None] + dxs + 1) * czp + cz[..., rows, None]
    starts = torch.where(alive[..., rows, None], starts, 0)
    r9 = (starts[..., None] + torch.arange(3, dtype=torch.int32,
                                           device=cx.device))
    r9 = r9.reshape(*r9.shape[:-2], 9)
    return tuple(take(t, r9, nb).reshape(*r9.shape[:-1], -1)
                 for t in table)


def _query_runs(cx, cz, alive, row_start, czp: int):
    """Each query's three z-triple runs ``[lo, hi)`` of the sorted view,
    one per x offset; excluded queries read an empty border run."""
    dxs = torch.arange(-1, 2, dtype=torch.int32, device=cx.device)
    starts = (cx[..., None] + dxs + 1) * czp + cz[..., None]
    starts = torch.where(alive[..., None], starts, 0)
    nb = cx.dim() - 1
    return take(row_start, starts, nb), take(row_start, starts + 3, nb)


def _invalid_key_int(topk_impl) -> int:
    """Sentinel ranking key: +inf's bit pattern for the float-domain
    ranking ("f32"), INT32_MAX otherwise."""
    return 0x7F800000 if topk_impl in ("approx", "f32") else 2**31 - 1


def _key_code(spec: GridSpec, want_flags: bool, qmax: float):
    """The packed-key encoding as plain numbers: (id_shift, qd_shift,
    qd_cap, qd_bias, scale as float32, invalid_key). ``scale`` is the
    float32 that JAX rounds ``levels / qmax`` to before the multiply."""
    invalid = _invalid_key_int(spec.topk_impl)
    if want_flags or spec.topk_impl in ("approx", "f32"):
        code = (23, _QD_MAX - 1, 1, np.float32(253.0 / qmax))
    else:
        code = (_ID_BITS, 1023, 0, np.float32(1024.0 / qmax))
    return (2 if want_flags else 0, *code, invalid)


def _pack_keys(dist, valid, cand_w, code):
    """Pack (quantized distance, word) into one int32 ranking key;
    invalid lanes get the invalid key."""
    _id_shift, qd_shift, qd_cap, qd_bias, scale, invalid = code
    d = torch.where(valid, dist, 0.0)
    qd = torch.clamp_max(
        (d * float(scale)).to(torch.int32),
        qd_cap) + qd_bias
    return torch.where(valid, (qd << qd_shift) | cand_w, invalid)


def _window_keys(s_xz, s_w, lo, hi, pos, reach, rows, cc, sentinel, code,
                 q16=None):
    """Packed keys int32[B, 9cc] and validity of the candidates of query
    ``rows``: the three runs of each query, lanes past a run's end
    masked (they may hold entities of other cells). ``q16`` is
    ``(spec, sorted packed lattice view, lattice plane)`` under
    precision=q16: distances then come from the packed words, exactly
    (only the slot word of a lane past a run's end is masked; its
    validity never reads coordinates)."""
    b = rows.shape[0]
    lead = lo.shape[:-2]
    nb = len(lead)
    lanes3 = torch.arange(3 * cc, device=lo.device)
    idx = (lo[..., None].long() + lanes3).reshape(*lead, b, 9 * cc)
    in_range = (lanes3 < (hi - lo)[..., None]).reshape(*lead, b, 9 * cc)
    cand_w = torch.where(in_range, take(s_w, idx, nb), sentinel << code[0])
    if q16 is not None:
        spec, s_q, qxz = q16
        dist = _q16_dist(spec, take(s_q, idx, nb), qxz[..., rows, None])
    else:
        cand_px = torch.where(in_range, take(s_xz[..., 0, :], idx, nb),
                              math.inf)
        cand_pz = take(s_xz[..., 1, :], idx, nb)
        dist = torch.maximum((cand_px - pos[..., rows, 0, None]).abs(),
                             (cand_pz - pos[..., rows, 2, None]).abs())
    return _cand_keys(dist, cand_w, reach, rows, sentinel, code)


def _cand_keys(dist, cand_w, reach, rows, sentinel, code):
    """Packed keys and validity of candidate words ``cand_w`` at
    Chebyshev distances ``dist`` from query ``rows``."""
    cand_id = cand_w >> code[0]
    valid = ((cand_id != sentinel) & (dist <= reach[..., rows, None])
             & (cand_id != rows[:, None]))
    return _pack_keys(dist, valid, cand_w, code), valid


def _table_keys(table, cx, cz, alive, czp, pos, reach, rows, sentinel,
                code):
    """:func:`_window_keys` over the table of ``sweep_impl="table"``."""
    cand_px, cand_pz, cand_w = _table_window(table, cx, cz, alive, rows,
                                             czp)
    dist = torch.maximum((cand_px - pos[..., rows, 0, None]).abs(),
                         (cand_pz - pos[..., rows, 2, None]).abs())
    return _cand_keys(dist, cand_w, reach, rows, sentinel, code)


def _pad_k(top, k, invalid):
    """Keep exactly k ranked columns (invalid keys pad when there are
    fewer candidate lanes than k)."""
    if top.shape[-1] >= k:
        return top[..., :k]
    fill = torch.full((*top.shape[:-1], k - top.shape[-1]), invalid,
                      dtype=top.dtype, device=top.device)
    return torch.cat([top, fill], dim=-1)


def _rank_packed(packed, k, topk_impl):
    """The k smallest keys per row in ascending order. The three exact
    rankings give the same values (valid keys are unique); each is
    written as the JAX package lowers it."""
    kk = min(k, packed.shape[-1])
    if topk_impl == "exact":
        top = torch.topk(packed, kk, dim=-1, largest=False).values
    elif topk_impl == "f32":
        fk = packed.view(torch.float32)
        top = torch.topk(fk, kk, dim=-1, largest=False).values \
            .view(torch.int32)
    else:
        top = torch.sort(packed, dim=-1).values[..., :kk]
    return _pad_k(top, k, _invalid_key_int(topk_impl))


def _unpack_top(top, invalid_key, want_flags, sentinel):
    """Ranked keys to (nbr ascending ids, cnt, flags-or-None)."""
    ok = top < invalid_key
    if want_flags:
        combo = torch.sort(
            torch.where(ok, top & _WORD_MASK, sentinel << 2), dim=-1
        ).values
        nbr = combo >> 2
        fl = torch.where(nbr == sentinel, 0, combo & 3)
    else:
        nbr = torch.sort(torch.where(ok, top & _ID_MASK, sentinel),
                         dim=-1).values
        fl = None
    return nbr, ok.sum(-1, dtype=torch.int32), fl


def _blocks(q: int, row_block: int, dev):
    rb = max(1, min(row_block, q))
    for s in range(0, q, rb):
        yield torch.arange(s, min(s + rb, q), device=dev)


def sweep_fused_plain(s_xz, s_w, lo, hi, pos, reach, k, cc, code,
                      with_stats, row_block=consts.DEFAULT_ROW_BLOCK,
                      gate=None, out=None):
    """Plain version of :func:`sweep_fused_cuda`: the ``ranges`` back
    half, block by block, keeping the k smallest keys of each row (of
    each Space, under a leading Space axis).
    Under a gate it computes the result and writes it into ``out`` where
    the gate is nonzero (``torch.where``), the kernel's dataflow."""
    q = lo.shape[-2]
    lead = lo.shape[:-2]
    sentinel = pos.shape[-2]
    invalid = code[-1]
    tops, dems = [], []
    for rows in _blocks(q, row_block, lo.device):
        keys, valid = _window_keys(s_xz, s_w, lo[..., rows, :],
                                   hi[..., rows, :], pos, reach, rows, cc,
                                   sentinel, code)
        tops.append(_pad_k(torch.sort(keys, dim=-1).values, k, invalid))
        dems.append(valid.sum(-1, dtype=torch.int32))
    top = torch.cat(tops, -2) if tops else lo.new_zeros((*lead, 0, k))
    dem = (torch.cat(dems, -1) if dems else lo.new_zeros((*lead, 0))) \
        if with_stats else None
    if gate is None:
        return top, dem
    run = gate != 0
    out[0].copy_(torch.where(run, top, out[0]))
    if with_stats:
        out[1].copy_(torch.where(run, dem, out[1]))
    return out[0], out[1] if with_stats else None


def sweep_fused_cuda(s_xz, s_w, lo, hi, pos, reach, k, cc, code,
                     with_stats, row_block=consts.DEFAULT_ROW_BLOCK,
                     gate=None, out=None):
    """The fused back half (window gather, key pack, top-k) as the CUDA
    kernel of ``csrc/aoi_fused.cu`` for tensors on the card; the plain
    version :func:`sweep_fused_plain` for tensors on the CPU.

    The kernel walks the rows in cell order: work item ``i < n``
    handles row ``s_w[i] >> id_shift``. So the first n ids of ``s_w``
    must be a permutation of ``[0, n)``, as :func:`front_half` makes
    them (dead and excluded slots included, in the dump bin).

    Every tensor may carry one leading Space axis of S (``s_xz [S, 2,
    L]``, ..., ``top [S, Q, k]``): one launch then sweeps every Space,
    each with its own view, sentinel tail and Space-local ids.

    Args:
      s_xz: f32[2, L] sorted x and z rows; s_w: i32[L] packed slot
        words (L = n + 3cc, the last 3cc lanes sentinels).
      lo, hi: i32[Q, 3] run bounds of each query row.
      pos: f32[n, 3] positions (queries are rows 0..Q-1); reach: f32[n].
      k: kept keys per row; cc: cell_cap (9*cc <= 256 on the card).
      code: the key encoding from ``_key_code``.
      with_stats: also return the demand vector i32[Q].
      row_block: rows per block of the plain version only.
      gate: None, or an i32 0-d tensor on the same device: the call
        then writes ``out`` only where the gate is nonzero. On the card
        every block reads the gate first and leaves at once when it is
        0, so a closed gate costs one empty launch and leaves ``out``
        as it was, byte for byte.
      out: with a gate, ``(top i32[Q, k], dem i32[Q] or None)``, the
        buffers written in place. They are read after the call either
        way, so they must hold valid values (never ``torch.empty``).

    Returns (top i32[Q, k] ascending ranked keys, dem i32[Q] or None).
    """
    n = pos.shape[-2]
    q = lo.shape[-2]
    lead = tuple(pos.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"one leading Space axis at most, got {lead}")
    spaces = lead[0] if lead else 1
    s_len = s_w.shape[-1]
    kernels.require(s_xz, "s_xz", torch.float32, (*lead, 2, s_len))
    kernels.require(s_w, "s_w", torch.int32, (*lead, n + 3 * cc))
    kernels.require(lo, "lo", torch.int32, (*lead, q, 3))
    kernels.require(hi, "hi", torch.int32, (*lead, q, 3))
    kernels.require(pos, "pos", torch.float32, (*lead, n, 3))
    kernels.require(reach, "reach", torch.float32, (*lead, n))
    if gate is not None:
        kernels.require(gate, "gate", torch.int32, ())
        kernels.require(out[0], "out top", torch.int32, (*lead, q, k))
        if with_stats:
            kernels.require(out[1], "out dem", torch.int32, (*lead, q))
    if not 0 < q <= n < (1 << _ID_BITS):
        raise ValueError(f"need 0 < Q <= n < 2^{_ID_BITS}, got {q}, {n}")
    ins = (s_xz, s_w, lo, hi, pos, reach) + (
        () if gate is None else (gate, *out[:1 + with_stats]))
    devs = {t.device for t in ins}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return sweep_fused_plain(s_xz, s_w, lo, hi, pos, reach, k, cc,
                                 code, with_stats, row_block, gate, out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (1 <= cc and 9 * cc <= 256):
        raise ValueError(f"the fused kernel takes 9*cell_cap <= 256, "
                         f"got cell_cap={cc}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    id_shift, qd_shift, qd_cap, qd_bias, scale, invalid = code
    if gate is None:
        top = torch.empty((*lead, q, k), dtype=torch.int32, device=dev)
        dem = torch.empty((*lead, q), dtype=torch.int32, device=dev) \
            if with_stats else None
    else:
        top, dem = out[0], out[1] if with_stats else None
    err = kernels.lib().gw_sweep_fused(
        s_xz.data_ptr(), s_w.data_ptr(), s_len, lo.data_ptr(),
        hi.data_ptr(), pos.data_ptr(), reach.data_ptr(), q, k, cc, n,
        spaces, id_shift, qd_shift, qd_cap, qd_bias, float(scale), invalid,
        None if gate is None else gate.data_ptr(),
        top.data_ptr(), dem.data_ptr() if with_stats else None,
        kernels.stream_handle(dev))
    kernels.check(err, "sweep_fused_cuda")
    kernels.LAUNCHES["sweep_fused"] += 1
    return top, dem


def _cell_occupancy_stats(srow, n_rows: int, cc: int):
    """(cell_max, over_cap_cells) from the unclipped per-cell occupancy
    (each Space's, under a leading Space axis)."""
    occ = bin_counts(srow, n_rows + 1, srow.dim() - 1)[..., :n_rows]
    return occ.amax(-1).to(torch.int32), \
        (occ > cc).sum(-1, dtype=torch.int32)


class FrontHalf(NamedTuple):
    """What the sweep's front half hands its back half."""

    # every lane may carry a leading Space axis [S, ...]
    srow: torch.Tensor      # i32[N] padded cell row (n_rows = excluded)
    n_rows: int
    s_xz: torch.Tensor | None  # f32[2, N + 3cc] sorted x, z (None: s_q)
    s_w: torch.Tensor       # i32[N + 3cc] sorted packed slot words
    lo: torch.Tensor        # i32[Q, 3] run starts
    hi: torch.Tensor        # i32[Q, 3] run ends
    reach: torch.Tensor     # f32[N] per-watcher reach
    code: tuple             # key encoding (_key_code)
    cell_stats: tuple | None  # (cell_max, over_cap_cells) under stats
    # q16 ``ranges`` only: the sorted packed lattice view i32[N + 3cc]
    # (0 on the pad lanes) and the lattice plane i32[N]
    s_q: torch.Tensor | None = None
    qxz: torch.Tensor | None = None
    # ``table`` only: the per-cell table (:func:`_build_table`) and the
    # queries' cells (cx, cz, alive, czp) its window reads
    table: tuple | None = None
    cells: tuple | None = None


def front_half(spec: GridSpec, pos, alive, query_rows, watch_radius,
               flag_bits, with_stats=False,
               reach_pad: float = 0.0) -> FrontHalf:
    """Cell rows, the cell sort and the sorted view with each query's
    runs: everything the back half reads. ``pos`` is already snapped
    under precision=q16 (:func:`_sweep` snaps it); the ``ranges`` back
    half then reads the packed lattice view in place of x and z."""
    check_ported(spec)
    n = pos.shape[-2]
    lead = pos.shape[:-2]
    if n >= (1 << _ID_BITS):
        raise NotImplementedError(
            f"the wide-id sweep (capacity >= 2^{_ID_BITS}) {ROADMAP_HINT}")
    q = n if query_rows is None else query_rows
    cc = spec.cell_cap
    dev = pos.device
    cx, cz, srow, alive, czp, n_rows = _cell_rows(
        spec, pos, alive, watch_radius)
    cell_stats = _cell_occupancy_stats(srow, n_rows, cc) \
        if with_stats else None
    order, sorted_row = _sort_cells(n_rows, srow, spec.sort_impl)
    px, pz, word, table_sentinel = _sorted_src(pos, flag_bits, order)
    row_start, s_xz, s_w = _build_ranges(cc, n_rows, srow, px, pz, word,
                                         table_sentinel)
    table = cells = None
    if spec.sweep_impl == "table":
        table = _build_table(cc, n_rows, sorted_row, row_start, px, pz,
                             word, table_sentinel)
        cells = (cx, cz, alive, czp)
    s_q = qxz = None
    if spec.precision != "off" and spec.sweep_impl == "ranges":
        qxz = quantize_xz_i32(spec, pos)
        s_q = torch.cat([take(qxz, order, len(lead)),
                         torch.zeros((*lead, 3 * cc), dtype=torch.int32,
                                     device=dev)], -1)
        s_xz = None
    lo, hi = _query_runs(cx[..., :q], cz[..., :q], alive[..., :q],
                         row_start, czp)
    if watch_radius is None:
        reach = torch.full((*lead, n), spec.radius + reach_pad,
                           dtype=torch.float32, device=dev)
    else:
        reach = torch.clamp_max(watch_radius.to(torch.float32),
                                _f32(spec.radius, dev)) \
            + _f32(reach_pad, dev)
    code = _key_code(spec, flag_bits is not None, spec.radius + reach_pad)
    return FrontHalf(srow, n_rows, s_xz, s_w, lo, hi, reach, code,
                     cell_stats, s_q, qxz, table, cells)


def _sweep(spec: GridSpec, pos, alive, query_rows, watch_radius,
           flag_bits, with_stats=False, reach_pad: float = 0.0,
           gate=None):
    """The whole sweep: (nbr, cnt, flags-or-None, stats-or-None). Every
    impl sweeps the snapped world under precision=q16. ``gate`` (an i32
    0-d tensor) gates the fused kernel into buffers made for the call
    and filled with the invalid key and 0: a closed gate returns empty
    lists, which a caller that selects with the gate discards."""
    pos = quantize_positions(spec, pos)
    fh = front_half(spec, pos, alive, query_rows, watch_radius, flag_bits,
                    with_stats, reach_pad)
    k, cc = spec.k, spec.cell_cap
    sentinel = pos.shape[-2]
    lead = fh.lo.shape[:-2]
    if spec.sweep_impl == "fused":
        q = fh.lo.shape[-2]
        out = None if gate is None else (
            torch.full((*lead, q, k), fh.code[-1], dtype=torch.int32,
                       device=pos.device),
            torch.zeros((*lead, q), dtype=torch.int32, device=pos.device))
        top, dem = sweep_fused_cuda(fh.s_xz, fh.s_w, fh.lo, fh.hi, pos,
                                    fh.reach, k, cc, fh.code, with_stats,
                                    spec.row_block, gate, out)
    else:
        q16 = None if fh.s_q is None else (spec, fh.s_q, fh.qxz)
        tops, dems = [], []
        for rows in _blocks(fh.lo.shape[-2], spec.row_block, pos.device):
            if fh.table is not None:
                keys, valid = _table_keys(fh.table, *fh.cells, pos,
                                          fh.reach, rows, sentinel, fh.code)
            else:
                keys, valid = _window_keys(
                    fh.s_xz, fh.s_w, fh.lo[..., rows, :], fh.hi[..., rows, :],
                    pos, fh.reach, rows, cc, sentinel, fh.code, q16)
            tops.append(_rank_packed(keys, k, spec.topk_impl))
            dems.append(valid.sum(-1, dtype=torch.int32))
        top = torch.cat(tops, -2)
        dem = torch.cat(dems, -1)
    nbr, cnt, fl = _unpack_top(top, fh.code[-1], flag_bits is not None,
                               sentinel)
    stats = None
    if with_stats:
        stats = (dem.amax(-1).to(torch.int32),
                 (dem > k).sum(-1, dtype=torch.int32), *fh.cell_stats)
    return nbr, cnt, fl, stats


def grid_neighbors(spec: GridSpec, pos, alive, query_rows=None,
                   watch_radius=None):
    """AOI neighbor lists for every entity.

    Args:
      spec: grid configuration.
      pos: f32[N, 3] positions; AOI uses x and z.
      alive: bool[N] slot-occupied mask.
      query_rows: if set, only rows [0, query_rows) get lists while all
        N entities stay candidates.
      watch_radius: optional f32[N] per-entity AOI distance; <= 0
        excludes the entity from AOI entirely, otherwise it watches
        within ``min(watch_radius, spec.radius)``.

    Returns nbr int32[Q, k] (ascending, padded with sentinel N) and cnt
    int32[Q].
    """
    nbr, cnt, _, _ = _sweep(spec, pos, alive, query_rows, watch_radius,
                            None)
    return nbr, cnt


def grid_neighbors_flags(spec: GridSpec, pos, alive, query_rows=None,
                         watch_radius=None, flag_bits=None,
                         with_stats=False):
    """:func:`grid_neighbors` plus each neighbor's 2 flag bits (int32[Q,
    k], 0 on sentinel lanes); with ``with_stats`` also the 4 gauges
    ``(demand_max, over_k_rows, cell_max, over_cap_cells)``."""
    if flag_bits is None:
        raise ValueError("grid_neighbors_flags requires flag_bits")
    nbr, cnt, fl, stats = _sweep(spec, pos, alive, query_rows,
                                 watch_radius, flag_bits, with_stats)
    if with_stats:
        return nbr, cnt, fl, stats
    return nbr, cnt, fl


# ------------------------------------------------------------------
# Verlet skin reuse (GridSpec.skin > 0)
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VerletCache:
    """The carried AOI candidate cache of one Space, the JAX package's
    ``VerletCache`` lane for lane.

    ``cand`` holds, per entity, every candidate within ``min(watch
    radius, radius) + skin`` at the last rebuild (ascending ids,
    sentinel N). While no entity has moved more than ``skin/2`` since,
    it is a superset of every true neighbourhood, so ranking it at the
    current positions gives what a full sweep gives."""

    cand: torch.Tensor        # i32[N, V] ids; q16: i32[N, 2*ceil(V/3)] packed
    ref_x: torch.Tensor       # f32[N] x at the last rebuild
    ref_z: torch.Tensor       # f32[N] z at the last rebuild
    ref_alive: torch.Tensor   # bool[N] alive set at the last rebuild
    ref_radius: torch.Tensor  # f32[N] watch radii at the last rebuild
    age: torch.Tensor         # i32 0-d: ticks since the rebuild
    valid: torch.Tensor       # bool 0-d: False until the first rebuild
    cell_max: torch.Tensor        # i32 0-d: max cell occupancy at rebuild
    over_cap_cells: torch.Tensor  # i32 0-d: cells past cell_cap at rebuild
    over_v_rows: torch.Tensor     # i32 0-d: rows past verlet_cap at rebuild

    def replace(self, **changes) -> "VerletCache":
        return dataclasses.replace(self, **changes)

    def apply(self, fn) -> "VerletCache":
        """The cache with ``fn`` applied to every lane."""
        return VerletCache(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def init_verlet_cache(spec: GridSpec, n: int, device) -> VerletCache:
    """An empty (invalid) cache on ``device``: the first tick rebuilds.
    Under precision=q16 the cand plane is packed in 21-bit triplets."""
    v = spec.verlet_cap_eff
    i32, f32 = torch.int32, torch.float32
    cand = torch.full((n, v), n, dtype=i32, device=device)
    if spec.precision != "off":
        cand = pack_ids21(cand, n)

    def zi():
        return torch.zeros((), dtype=i32, device=device)

    return VerletCache(
        cand=cand,
        ref_x=torch.zeros(n, dtype=f32, device=device),
        ref_z=torch.zeros(n, dtype=f32, device=device),
        ref_alive=torch.zeros(n, dtype=torch.bool, device=device),
        ref_radius=torch.zeros(n, dtype=f32, device=device),
        age=zi(),
        valid=torch.zeros((), dtype=torch.bool, device=device),
        cell_max=zi(),
        over_cap_cells=zi(),
        over_v_rows=zi(),
    )


def _rank_candidates(spec: GridSpec, pos, watch_radius, flag_bits, cand,
                     with_stats: bool):
    """The back half over cached candidate ids (the reuse re-rank):
    gather each candidate's current position (and flag bits) by id,
    test ``dist <= reach`` exactly and rank with the sweep's packed
    keys. Plain torch ops, as the JAX package's XLA; all rows at once.
    Returns (nbr, cnt, flags-or-None, demand-or-None)."""
    n = pos.shape[0]
    dev = pos.device
    want_flags = flag_bits is not None
    q16 = spec.precision != "off"
    cb = unpack_ids21(cand) if q16 else cand          # [N, >= V]
    cbc = cb.clamp_max(n - 1).long()
    if q16:
        qxz = quantize_xz_i32(spec, pos)
        dist = _q16_dist(spec, qxz[cbc], qxz[:, None])
    else:
        px, pz = pos[:, 0], pos[:, 2]
        dist = torch.maximum((px[cbc] - px[:, None]).abs(),
                             (pz[cbc] - pz[:, None]).abs())
    radius = _f32(spec.radius, dev)
    if watch_radius is None:
        reach = radius
    else:
        reach = torch.clamp_max(watch_radius.to(torch.float32),
                                radius)[:, None]
    valid = (cb != n) & (dist <= reach)
    w = (cb << 2) | (flag_bits[cbc].to(torch.int32) & 3) if want_flags \
        else cb
    code = _key_code(spec, want_flags, spec.radius)
    top = _rank_packed(_pack_keys(dist, valid, w, code), spec.k,
                       spec.topk_impl)
    nbr, cnt, fl = _unpack_top(top, code[-1], want_flags, n)
    dem = valid.sum(1, dtype=torch.int32) if with_stats else None
    return nbr, cnt, fl, dem


def grid_neighbors_verlet(spec: GridSpec, pos, alive, cache: VerletCache,
                          watch_radius=None, flag_bits=None,
                          with_stats=False):
    """:func:`grid_neighbors_flags` with Verlet reuse of the sweep.

    The rebuild decision is a 0-d device tensor, never read by the
    host::

      need = cache invalid
          or 2 * (max alive Chebyshev displacement since rebuild) > skin
          or the alive set changed
          or an alive watch radius changed
          or age >= rebuild_every_max (when > 0)

    JAX runs the rebuild under ``lax.cond``; here its launches are
    issued every tick. The fused kernel reads ``need`` as its gate and
    does no work on a reuse tick; the front half before it still runs,
    and every new cache lane is ``torch.where(need, rebuilt, old)``.
    The rebuild is the sweep at ``k = verlet_cap_eff`` with reach padded
    by ``skin`` and no flag bits; every tick then ranks the cached
    candidates at the current positions and flags.

    Returns ``(nbr, cnt, flags-or-None, stats-or-None, cache', rebuilt
    i32 0-d, skin_slack f32 0-d)``. ``stats`` keeps the sweep's four
    gauges: ``over_k_rows`` adds the cache's ``over_v_rows``, the cell
    gauges are the last rebuild's. ``skin_slack`` is ``skin/2`` minus
    the displacement (``skin/2`` against an invalid cache).
    """
    check_ported(spec)
    n = pos.shape[0]
    if pos.dim() != 2:
        raise ValueError(
            "Verlet reuse runs on one Space's lanes; a batched step "
            "clears the skin, as the JAX package's vmapped step does")
    if spec.skin <= 0.0:
        raise ValueError(
            "grid_neighbors_verlet requires spec.skin > 0 "
            f"(got {spec.skin!r}); use grid_neighbors_flags instead")
    if n >= (1 << _ID_BITS):
        raise ValueError(
            f"Verlet reuse needs n < 2^{_ID_BITS}; got n={n}")
    dev = pos.device
    pos = quantize_positions(spec, pos)
    disp = torch.where(
        alive,
        torch.maximum((pos[:, 0] - cache.ref_x).abs(),
                      (pos[:, 2] - cache.ref_z).abs()),
        0.0).max()
    need = ~cache.valid | (2.0 * disp > spec.skin) \
        | (alive != cache.ref_alive).any()
    if watch_radius is not None:
        need = need | (alive & (watch_radius != cache.ref_radius)).any()
    age = cache.age + 1
    if spec.rebuild_every_max > 0:
        need = need | (age >= spec.rebuild_every_max)
    half = _f32(0.5 * spec.skin, dev)
    slack = torch.where(cache.valid, half - disp, half)

    spec_v = dataclasses.replace(spec, k=spec.verlet_cap_eff)
    cand, _cnt, _fl, cstats = _sweep(
        spec_v, pos, alive, None, watch_radius, None, with_stats=True,
        reach_pad=spec.skin, gate=need.to(torch.int32))
    if spec.precision != "off":
        cand = pack_ids21(cand, n)

    def pick(new, old):
        return torch.where(need, new, old)

    cache = VerletCache(
        cand=pick(cand, cache.cand),
        ref_x=pick(pos[:, 0], cache.ref_x),
        ref_z=pick(pos[:, 2], cache.ref_z),
        ref_alive=pick(alive, cache.ref_alive),
        ref_radius=(cache.ref_radius if watch_radius is None
                    else pick(watch_radius, cache.ref_radius)),
        age=pick(torch.zeros_like(age), age),
        valid=cache.valid | need,
        cell_max=pick(cstats[2], cache.cell_max),
        over_cap_cells=pick(cstats[3], cache.over_cap_cells),
        over_v_rows=pick(cstats[1], cache.over_v_rows),
    )
    nbr, cnt, fl, dem = _rank_candidates(spec, pos, watch_radius,
                                         flag_bits, cache.cand, with_stats)
    stats = None
    if with_stats:
        stats = (dem.max().to(torch.int32),
                 (dem > spec.k).sum(dtype=torch.int32)
                 + cache.over_v_rows,
                 cache.cell_max, cache.over_cap_cells)
    return nbr, cnt, fl, stats, cache, need.to(torch.int32), slack


def neighbors_oracle(pos, alive, radius, watch_radius=None):
    """NumPy reference (unbounded, uncapped) for tests: a list of
    neighbor-id sets, with the per-entity radius semantics of
    :func:`grid_neighbors`."""
    pos = np.asarray(pos)
    alive = np.asarray(alive)
    n = pos.shape[0]
    if watch_radius is None:
        participates = alive
        reach = np.full(n, radius, np.float64)
    else:
        wr = np.asarray(watch_radius, np.float64)
        participates = alive & (wr > 0)
        reach = np.minimum(wr, radius)
    out = []
    for i in range(n):
        if not participates[i]:
            out.append(set())
            continue
        dx = np.abs(pos[:, 0] - pos[i, 0])
        dz = np.abs(pos[:, 2] - pos[i, 2])
        mask = (np.maximum(dx, dz) <= reach[i]) & participates
        mask[i] = False
        out.append(set(np.nonzero(mask)[0].tolist()))
    return out
