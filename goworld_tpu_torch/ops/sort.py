"""Stable sort of entity slots by grid-cell row, the port of
``goworld_tpu/ops/sort.py``.

The AOI sweep's front half orders slots by cell row. Every path here is
STABLE, so each gives exactly ``argsort(srow, stable=True)`` and
``srow[order]``, including which entities a ``cell_cap`` overflow
drops:

* :func:`counting_sort_cells` is the plain version: the JAX package's
  chunked counting sort (bin offsets from a histogram and cumsum, then
  each element's rank among earlier equal keys, chunk by chunk).
* :func:`counting_sort_cells_cuda` is the kernel's wrapper
  (``csrc/counting_sort.cu``, a one-sweep LSD radix sort: one histogram
  kernel for all passes, then one scatter kernel a pass with decoupled
  look-back). :func:`radix_plan` picks its passes and digit width. It
  takes the plain version for a CPU tensor only.
"""

from __future__ import annotations

import torch

from goworld_tpu_torch import kernels
from goworld_tpu_torch.ops.batch import bin_counts, row_cumsum, space_base

DEFAULT_CHUNK = 2048
# widest digit of the radix kernel's plan: the bench's 19-bit keys sort
# in 3 passes of 7 bits (128 bins a pass), which beat 2 passes of 10 bits
# and 4 of 5 on an H100 (``ablate_kernels``, PERF.md)
RADIX_MAX_DIGIT_BITS = 8


def row_starts(srow: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Exclusive-cumsum bin offsets: ``row_starts[r]`` is the first
    sorted position of cell row ``r``; the dump bin ``n_rows`` (dead
    entities) sorts last. int32[n_rows + 1]; ``[S, n_rows + 1]``, each
    Space's own, for ``srow [S, N]``."""
    counts = bin_counts(srow, n_rows + 1, srow.dim() - 1)
    return torch.cat([
        counts.new_zeros((*counts.shape[:-1], 1)),
        row_cumsum(counts[..., :-1]),
    ], -1)


def _finish(srow: torch.Tensor, dst: torch.Tensor, n: int):
    """Invert the destination map into (order, sorted_row). ``dst`` is a
    permutation of [0, len(dst)); padded elements land at n and past."""
    m = dst.shape[0]
    order = torch.empty(m, dtype=torch.int32, device=srow.device)
    order[dst.long()] = torch.arange(m, dtype=torch.int32,
                                     device=srow.device)
    order = order[:n]
    return order, srow[order.long()]


def counting_sort_cells(
    srow: torch.Tensor, n_rows: int, chunk: int = DEFAULT_CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable counting sort of slot ids by cell row (plain torch ops).

    Args:
      srow: int32[n] cell-row keys in ``[0, n_rows]`` (``n_rows`` is the
        dump bin for dead entities and sorts last).
      n_rows: bin count.
      chunk: elements per step of the rank pass; any value gives the
        same result.

    Returns (order, sorted_row): a stable argsort of ``srow`` and
    ``srow[order]``, both int32[n].

    ``srow [S, n]`` holds S Spaces' keys: each is sorted on its own, as
    one sort of the Space-major keys ``s * (n_rows + 1) + row`` (whose
    stable sort is the S sorts laid end to end), returned as
    Space-local ``[S, n]`` orders and rows.
    """
    if srow.dim() == 2:
        spaces, per = srow.shape
        stride = n_rows + 1
        flat = (srow + space_base((spaces,), stride, srow.device)) \
            .reshape(-1)
        order, sorted_row = counting_sort_cells(flat, spaces * stride - 1,
                                                chunk)
        return _space_local(order, sorted_row, spaces, per, stride)
    n = srow.shape[0]
    dev = srow.device
    starts = row_starts(srow, n_rows)
    c = max(1, min(chunk, n))
    nb = -(-n // c)
    pad = nb * c - n
    keys_all = torch.cat([
        srow, torch.full((pad,), n_rows, dtype=torch.int32, device=dev)])
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=dev), -1)
    fill = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    dst = []
    for b in range(nb):
        keys = keys_all[b * c:(b + 1) * c]
        kl = keys.long()
        # within-chunk stable rank: earlier elements of the same key
        r = ((keys[:, None] == keys[None, :]) & tri).sum(
            dim=1, dtype=torch.int32)
        dst.append(starts[kl] + fill[kl] + r)
        fill.index_add_(0, kl, torch.ones_like(keys))
    return _finish(srow, torch.cat(dst), n)


def _space_local(order, sorted_row, spaces: int, per: int, stride: int):
    """The flat sort of Space-major keys as Space-local ``[S, n]``
    orders and rows."""
    dev = order.device
    return (order.reshape(spaces, per) - space_base((spaces,), per, dev),
            sorted_row.reshape(spaces, per)
            - space_base((spaces,), stride, dev))


def radix_plan(key_bits: int) -> tuple[int, int]:
    """(passes, digit_bits) of the radix kernel for keys of ``key_bits``
    bits: the fewest passes of at most ``RADIX_MAX_DIGIT_BITS`` bits,
    with the bits spread evenly over them (19 bits: 3 passes of 7)."""
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must be in [1, 31], got {key_bits}")
    passes = -(-key_bits // RADIX_MAX_DIGIT_BITS)
    return passes, -(-key_bits // passes)


def counting_sort_cells_cuda(
    srow: torch.Tensor, n_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`counting_sort_cells` as the CUDA kernel of
    ``csrc/counting_sort.cu`` for a tensor on the card; the plain
    version for a tensor on the CPU. Keys outside ``[0, n_rows]`` are
    not checked on the card (that would stall the host) and sort
    wrongly; the kernel takes fewer than 2^30 keys in all.

    ``srow [S, n]`` sorts S Spaces in one call (passes + 1 kernels,
    whatever S is): the kernels read Space s's keys as ``s * (n_rows +
    1) + row`` and write Space-local orders and rows."""
    if srow.dim() not in (1, 2):
        raise ValueError(f"srow: expected [n] or [S, n], got "
                         f"{tuple(srow.shape)}")
    kernels.require(srow, "srow", torch.int32)
    spaces = srow.shape[0] if srow.dim() == 2 else 1
    stride = n_rows + 1
    if n_rows < 0 or spaces * stride > 2**31 - 1:
        raise ValueError(f"n_rows out of range: {n_rows} ({spaces} "
                         f"Spaces)")
    if srow.device.type == "cpu":
        return counting_sort_cells(srow, n_rows)
    if srow.device.type != "cuda":
        raise ValueError(f"srow: unsupported device {srow.device}")
    so = kernels.lib()
    n = srow.numel()
    dev = srow.device
    passes, digit_bits = radix_plan(max(1, (spaces * stride - 1)
                                        .bit_length()))
    # one scratch block: ping-pong keys and slots, the digit table, the
    # tickets and the look-back records
    slen = so.gw_counting_sort_scratch_len(n, passes, digit_bits)
    scratch = torch.empty(slen, dtype=torch.int32, device=dev)
    out = torch.empty((2, *srow.shape), dtype=torch.int32, device=dev)
    order, sorted_row = out[0], out[1]
    err = so.gw_counting_sort(
        srow.data_ptr(), n, spaces, stride if spaces > 1 else 0, passes,
        digit_bits, scratch.data_ptr(), slen, order.data_ptr(),
        sorted_row.data_ptr(), kernels.stream_handle(dev))
    kernels.check(err, "counting_sort_cells_cuda")
    kernels.LAUNCHES["counting_sort"] += 1
    return order, sorted_row
