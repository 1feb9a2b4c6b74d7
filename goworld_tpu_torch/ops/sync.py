"""Sync-record collection, the port of ``goworld_tpu/ops/sync.py``:
``watch[i, j]`` = watcher i has a client AND neighbor j of i is dirty,
flattened into a capacity-bounded record array; hot-attr deltas ride the
same shape."""

from __future__ import annotations

import torch

from goworld_tpu_torch.ops.batch import take
from goworld_tpu_torch.ops.extract import bounded_extract_rows


def collect_sync(nbr, dirty, has_client, pos, yaw, cap: int,
                 nbr_dirty=None, adaptive: bool = True):
    """Position/yaw sync records for client-owning watchers.

    Args:
      nbr: int32[N, k] sorted neighbor lists (ids in [0, P), sentinel
        P = len(pos)).
      dirty: bool[P] subject moved-this-tick mask.
      has_client: bool[N] watcher owns a connected client.
      pos: f32[P, 3]; yaw: f32[P].
      cap: max records.
      nbr_dirty: optional bool[N, k], each neighbor's dirty bit as the
        AOI sweep delivered it; skips the [N, k] gather of ``dirty``.

    Returns watcher int32[cap], subject int32[cap], vals f32[cap, 4]
    (x, y, z, yaw), count int32 (true demand; may exceed cap). With a
    leading Space axis on every argument, each Space's records and count
    (``[S, cap]``, ``[S]``).
    """
    *lead, n, k = nbr.shape
    nb = len(lead)
    p = pos.shape[-2]
    valid_nbr = nbr != p
    nbr_c = torch.clamp_max(nbr, p - 1)
    if nbr_dirty is None:
        nbr_dirty = take(dirty, nbr_c, nb)
    watch = has_client[..., None] & valid_nbr & nbr_dirty
    flat, valid, count = bounded_extract_rows(watch, cap, adaptive)
    watcher = torch.where(valid, flat // k, -1)
    subject_raw = take(nbr_c.reshape(*lead, -1), flat, nb)
    subject = torch.where(valid, subject_raw, -1)
    sub_c = torch.clamp_max(subject_raw, p - 1)
    vals = torch.cat([take(pos, sub_c, nb), take(yaw, sub_c, nb)[..., None]],
                     dim=-1)
    vals = torch.where(valid[..., None], vals, 0.0)
    return watcher, subject, vals, count


def collect_attr_deltas(hot_attrs, attr_dirty, cap: int,
                        adaptive: bool = True):
    """Dirty (entity, attr) cells as bounded records.

    Args:
      hot_attrs: f32[N, A]; attr_dirty: int32[N] bitmask over A <= 32
        attrs (the JAX package's uint32 lane, same bits).
      cap: max records.

    Returns entity int32[cap], attr_idx int32[cap], value f32[cap],
    count int32.
    """
    *lead, n, a = hot_attrs.shape
    shifts = torch.arange(a, dtype=torch.int32, device=hot_attrs.device)
    mask = ((attr_dirty[..., None] >> shifts) & 1).bool()
    flat, valid, count = bounded_extract_rows(mask, cap, adaptive)
    ent = torch.where(valid, flat // a, -1)
    attr_idx = torch.where(valid, flat % a, -1)
    value = torch.where(
        valid, take(hot_attrs.reshape(*lead, -1), flat, len(lead)), 0.0)
    return ent, attr_idx, value, count
