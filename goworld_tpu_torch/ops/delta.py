"""Interest-set enter/leave deltas from consecutive neighbor lists, the
port of ``goworld_tpu/ops/delta.py``. Lists are sorted, fixed-width and
sentinel-padded, so the delta is a per-row set difference and the pairs
come back as capacity-bounded arrays."""

from __future__ import annotations

import torch

from goworld_tpu_torch.ops.batch import take
from goworld_tpu_torch.ops.extract import (
    _flatnonzero,
    bounded_extract,
    bounded_extract_rows,
    SMALL_TIER_ROWS,
    two_tier,
)


def _not_in(a: torch.Tensor, b: torch.Tensor, sentinel) -> torch.Tensor:
    """Per-row mask over b: True where b's entry is valid and absent
    from a (all-pairs compare over a's lane)."""
    found = (b[:, :, None] == a[:, None, :]).any(dim=2)
    return (b != sentinel) & ~found


def _in_sorted(rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Whether each entry of ``values [..., R, k]`` occurs in the same
    row of ``rows [..., R, k]``, whose rows are sorted ascending: one
    binary search an entry (the [R, k, k] all-pairs compare's result,
    without its k^2 bytes a row)."""
    at = torch.searchsorted(rows, values).clamp_max(rows.shape[-1] - 1)
    return rows.gather(-1, at) == values


def interest_delta(old_nbr, new_nbr, sentinel):
    """Masks of entered (over new_nbr) and left (over old_nbr)
    neighbors."""
    return _not_in(old_nbr, new_nbr, sentinel), \
        _not_in(new_nbr, old_nbr, sentinel)


def masked_pairs(mask, values, cap: int, adaptive: bool = True):
    """Up to ``cap`` (row, value) pairs where mask is set: (watcher
    int32[cap], subject int32[cap], count int32); entries past the count
    are -1 and the count is the true demand."""
    k = mask.shape[1]
    flat, valid, count = bounded_extract_rows(mask, cap, adaptive)
    watcher = torch.where(valid, flat // k, -1)
    subject = torch.where(valid, values.reshape(-1)[flat.long()], -1)
    return watcher, subject, count


def interest_pairs(old_nbr, new_nbr, sentinel, enter_cap: int,
                   leave_cap: int, row_cap: int, adaptive: bool = True):
    """Changed-rows-only interest diff plus pair extraction: the same
    pairs, order and drop policy as ``interest_delta`` and two
    ``masked_pairs`` calls, with the membership test run only on up to
    ``row_cap`` rows whose list changed (a binary search in the other
    sorted list, :func:`_in_sorted`).

    Lists with a leading Space axis (``[S, N, k]``) are S Spaces: the
    rows, pairs and caps are each Space's own, compacted along its rows,
    never over the flat array.

    Returns (enter_w, enter_j, enter_n, leave_w, leave_j, leave_n,
    changed_n); ``changed_n`` is the true number of changed rows (the
    row-cap overflow signal)."""
    *lead, n, k = old_nbr.shape
    nb = len(lead)
    changed = (old_nbr != new_nbr).any(dim=-1)
    changed_total = changed.sum(-1, dtype=torch.int32)

    def tier(rcap):
        rows = _flatnonzero(changed, rcap, n)
        rows_c = torch.clamp_max(rows, n - 1)
        row_ok = (rows < n)[..., None]
        old_s = take(old_nbr, rows_c, nb)
        new_s = take(new_nbr, rows_c, nb)
        enter_m = row_ok & (new_s != sentinel) & ~_in_sorted(old_s, new_s)
        leave_m = row_ok & (old_s != sentinel) & ~_in_sorted(new_s, old_s)

        def pairs(mask, values, cap):
            flat, valid, count = bounded_extract(mask, cap, nb)
            watcher = torch.where(valid, take(rows_c, flat // k, nb), -1)
            subject = torch.where(
                valid, take(values.reshape(*lead, -1), flat, nb), -1)
            return watcher, subject, count

        return (*pairs(enter_m, new_s, enter_cap),
                *pairs(leave_m, old_s, leave_cap))

    out = two_tier(changed_total, min(SMALL_TIER_ROWS, row_cap), row_cap,
                   tier, adaptive)
    return (*out, changed_total)
