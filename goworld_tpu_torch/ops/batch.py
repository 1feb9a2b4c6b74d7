"""Per-Space indexing for lanes with a leading Space axis.

The tick runs on one Space's lanes (``[N, ...]``) or on S Spaces at once
(``[S, N, ...]``), as the JAX package's World vmaps its step over the
stacked state. Elementwise ops and reductions along the trailing axes
take both as they are; an index into a Space's rows must stay inside
that Space, which is what these helpers add. ``nb`` is the number of
leading Space axes: 0 (one Space) or 1.
"""

from __future__ import annotations

import torch


def take(x: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """``x[idx]`` within each Space: ``x`` is ``[*B, M, *F]``, ``idx``
    an integer ``[*B, *I]`` of rows in ``[0, M)``; returns ``[*B, *I,
    *F]``. One index kernel either way."""
    if nb == 0:
        return x[idx.long()]
    if nb != 1:
        raise ValueError(f"one leading Space axis at most, got {nb}")
    s = torch.arange(x.shape[0], device=x.device).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return x[s, idx.long()]


def space_base(lead: tuple, stride: int, device) -> torch.Tensor:
    """``s * stride`` for each Space ``s`` of the leading shape
    ``lead``, shaped ``[*lead, 1]`` to broadcast over a Space's rows
    (``[1]``, holding 0, for one Space)."""
    count = 1
    for d in lead:
        count *= int(d)
    return (torch.arange(count, dtype=torch.int32, device=device)
            * stride).reshape(*lead, 1)


def bin_counts(keys: torch.Tensor, bins: int, nb: int) -> torch.Tensor:
    """Per-Space histogram of int32 ``keys [*B, N]`` in ``[0, bins)``:
    int32 ``[*B, bins]``, one ``index_add_`` for all Spaces (a Space's
    keys land in its own block of bins)."""
    lead = keys.shape[:nb]
    flat = keys
    if nb:
        flat = keys + space_base(lead, bins, keys.device)
    count = 1
    for d in lead:
        count *= int(d)
    counts = torch.zeros(count * bins, dtype=torch.int32,
                         device=keys.device)
    counts.index_add_(0, flat.reshape(-1).long(),
                      torch.ones_like(flat).reshape(-1))
    return counts.reshape(*lead, bins)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of each row of ``x [..., M]``. With
    leading axes it is one scan of the flat array less each row's start:
    torch scans a few long rows along their last axis one block a row,
    far slower on the card than one scan of the flat array (``PERF.md``
    §6, the several-Space tick)."""
    if x.dim() == 1:
        return torch.cumsum(x, 0, dtype=torch.int32)
    m = x.shape[-1]
    c = torch.cumsum(x.reshape(-1), 0, dtype=torch.int32).reshape(-1, m)
    start = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return (c - start[:, None]).reshape(x.shape)
