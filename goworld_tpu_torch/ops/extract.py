"""Bounded extraction, the port of ``goworld_tpu/ops/extract.py``: flatten
a boolean mask into up to ``cap`` flat indices plus a validity mask and
the TRUE demand count (which may exceed ``cap``; the surplus is dropped
in row-major order and the host watches the count).

``torch.nonzero`` waits for the host to learn the output size, so the
compaction here is a cumsum plus a scatter, as XLA lowers
``flatnonzero(size=...)``: the tick never stalls on the host.
"""

from __future__ import annotations

import torch

from goworld_tpu_torch.ops.batch import row_cumsum, take

# the JAX package's default small-tier row budget (its
# GOWORLD_SMALL_TIER_ROWS / small_tier_rows knob is not ported)
SMALL_TIER_ROWS = 16384


def _flatnonzero(flat: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.flatnonzero(flat, size=size, fill_value=fill)`` as int32, of
    each row of a ``[..., M]`` mask."""
    dev = flat.device
    pos = row_cumsum(flat) - 1
    # set bits past ``size`` and unset bits land in a dump slot
    tgt = torch.where(flat & (pos < size), pos, size).long()
    out = torch.full((*flat.shape[:-1], size + 1), fill, dtype=torch.int32,
                     device=dev)
    out.scatter_(-1, tgt, torch.arange(flat.shape[-1], dtype=torch.int32,
                                       device=dev).expand(flat.shape))
    return out[..., :size]


def bounded_extract_batched(mask: torch.Tensor, cap: int):
    """:func:`bounded_extract` of each row of a ``[..., M]`` mask at once
    (the JAX package vmaps the 1-D form): returns (flat int32[..., cap]
    indices into each row, valid bool[..., cap], count int32[...])."""
    flat = _flatnonzero(mask, cap, 0)
    count = mask.sum(-1, dtype=torch.int32)
    valid = torch.arange(cap, dtype=torch.int32, device=mask.device) \
        < torch.clamp_max(count, cap)[..., None]
    return flat, valid, count


def bounded_extract(mask: torch.Tensor, cap: int, nb: int = 0):
    """Returns (flat int32[cap] indices into mask.ravel(), valid
    bool[cap], count int32). Entries past ``count`` point at 0 and are
    invalid. With ``nb`` leading Space axes each Space's mask is
    flattened and extracted on its own: ``[*B, cap]`` and ``[*B]``."""
    return bounded_extract_batched(
        mask.reshape(*mask.shape[:nb], -1), cap)


def two_tier(count, small: int, full: int, tier_fn, adaptive: bool = True):
    """The JAX package runs ``tier_fn(small)`` when ``count <= small``
    and ``tier_fn(full)`` otherwise; its contract makes both give the
    same output whenever the small tier applies. Choosing would need
    ``count`` on the host every tick, so this port always runs the full
    tier (the small tier is a speed knob, still to port)."""
    del count, small, adaptive
    return tier_fn(full)


def bounded_extract_rows(mask: torch.Tensor, cap: int,
                         adaptive: bool = True):
    """Two-level :func:`bounded_extract` for 2-D masks (same contract and
    results): extract at most ``cap`` rows holding any set bit, then the
    bits within those rows. A ``[S, N, K]`` mask is S Spaces' masks, each
    extracted on its own (``[S, cap]`` indices, ``[S]`` counts)."""
    *lead, n, k = mask.shape
    nb = len(lead)
    dev = mask.device
    count = mask.sum((-2, -1), dtype=torch.int32)
    row_any = mask.any(dim=-1)
    cap_rows = min(cap, n)
    valid = torch.arange(cap, dtype=torch.int32, device=dev) \
        < torch.clamp_max(count, cap)[..., None]

    def tier(cr):
        rflat, rvalid, _ = bounded_extract_batched(row_any, cr)
        rows = torch.where(rvalid, rflat, n)
        rows_c = torch.clamp_max(rows, n - 1)
        sub = take(mask, rows_c, nb) & (rows[..., None] < n)
        flat2, _, _ = bounded_extract(sub, cap, nb)
        flat = take(rows_c, flat2 // k, nb) * k + flat2 % k
        return torch.where(valid, flat, 0)

    flat = two_tier(row_any.sum(), min(SMALL_TIER_ROWS, cap_rows), cap_rows,
                    tier, adaptive)
    return flat, valid, count
