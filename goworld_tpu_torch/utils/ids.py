"""Entity / client identifier generation, the port's copy of
``goworld_tpu/utils/ids.py`` (same 16-character format and index).

Reference parity: GoWorld represents ``EntityID``/``ClientID`` as 16-char
strings (``engine/common/types.go:9-46``) produced from a 12-byte
Mongo-ObjectId-style uuid — 4B unix time, 3B machine, 2B pid, 3B counter —
base64-encoded to 16 chars (``engine/common/uuid/uuid.go:27-60``), plus a
deterministic variant used for per-game nil-space ids
(``engine/entity/space_ops.go:33-47``).

We keep the same wire format (16-char url-safe base64 of 12 bytes) so that
ids stay fixed-width on the wire and sortable-by-creation-time, but device
kernels never see these strings: the host maps ``EntityID`` <-> (space shard,
slot, generation) and ships only int32 slot indices to the TPU.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
import time

ENTITYID_LENGTH = 16  # chars on the wire, = base64(12 bytes)

_counter_lock = threading.Lock()
_counter = int.from_bytes(os.urandom(3), "big")

_machine = hashlib.md5(socket.gethostname().encode()).digest()[:3]
_pid = struct.pack(">H", os.getpid() & 0xFFFF)


def _b64_12(raw: bytes) -> str:
    assert len(raw) == 12
    return base64.urlsafe_b64encode(raw).decode("ascii")  # 16 chars, no pad


def gen_entity_id() -> str:
    """Generate a fresh 16-char EntityID (time+machine+pid+counter)."""
    global _counter
    with _counter_lock:
        _counter = (_counter + 1) & 0xFFFFFF
        cnt = _counter
    raw = (
        struct.pack(">I", int(time.time()) & 0xFFFFFFFF)
        + _machine
        + _pid
        + cnt.to_bytes(3, "big")
    )
    return _b64_12(raw)


def gen_fixed_id(key: str) -> str:
    """Deterministic EntityID from a string key.

    Used for nil-space ids so every process derives the same id for game N,
    like the reference's ``GenFixedUUID`` (``uuid.go``/``space_ops.go:41``).
    """
    return _b64_12(hashlib.sha256(key.encode()).digest()[:12])


def nil_space_id(game_id: int) -> str:
    # the JAX package's key, so both packages name game N's nil space alike
    return gen_fixed_id(f"goworld_tpu.nilspace.{game_id}")


def eid_hash64(eids) -> "np.ndarray":
    """Vectorized 64-bit hash of an S16 EntityID array.

    The batched sync decoders (``World.stage_pos_sync_batch``,
    ``DispatcherService._h_sync_upstream``) key their intern indexes on
    this instead of the raw S16 bytes: ``searchsorted`` over u64 is ~4x
    cheaper than over S16 (one integer compare vs a memcmp per probe).
    Splitmix64-style mix of the two 8-byte halves. Collisions are handled
    by the callers (exact-match verify on candidates; index falls back to
    raw-byte keys if two LIVE ids ever collide — ~1e-7 at 1M ids).
    """
    import numpy as np

    a = np.ascontiguousarray(np.asarray(eids, "S16"))
    h = a.view(np.uint64).reshape(-1, 2)
    return (
        (h[:, 0] ^ (h[:, 0] >> np.uint64(31)))
        * np.uint64(0x9E3779B97F4A7C15)
    ) ^ (h[:, 1] + np.uint64(0xD1B54A32D192ED03))


def build_eid_index(eids) -> tuple:
    """Build a sorted lookup index over an S16 EntityID array.

    Returns ``(hashed, keys, sorted_eids, order)``: ``keys`` is sorted
    :func:`eid_hash64` values (fast u64 probes) unless two input ids
    hash-collide, in which case it falls back to the raw S16 bytes
    (``hashed=False``); ``sorted_eids``/``order`` align the inputs with
    ``keys`` so callers can permute their payload columns. Shared by the
    two vectorized sync decoders (game leg ``World._sync_pos_index``,
    router leg ``DispatcherService._route_index``) so the collision
    fallback and verify logic live in exactly one place.
    """
    import numpy as np

    eids = np.ascontiguousarray(np.asarray(eids, "S16"))
    keys = eid_hash64(eids)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    hashed = True
    if keys.size and (keys[1:] == keys[:-1]).any():
        order = np.argsort(eids, kind="stable")
        keys = eids[order]
        hashed = False
    return hashed, keys, eids[order], order


def probe_eid_index(hashed: bool, keys, sorted_eids, query_eids) -> tuple:
    """Resolve S16 ``query_eids`` against a :func:`build_eid_index`.

    Returns ``(p, ok)``: candidate positions into the sorted index and
    the exact-match mask (hash candidates are byte-verified here, so a
    hash false positive can never resolve; ~1e-19/record with 64-bit
    keys, and zero once the build fell back to raw bytes).
    """
    import numpy as np

    query_eids = np.ascontiguousarray(np.asarray(query_eids, "S16"))
    probe = eid_hash64(query_eids) if hashed else query_eids
    p = np.minimum(np.searchsorted(keys, probe), keys.size - 1)
    ok = keys[p] == probe
    if hashed:
        ok &= sorted_eids[p] == query_eids
    return p, ok


def is_valid_entity_id(eid: str) -> bool:
    if not isinstance(eid, str) or len(eid) != ENTITYID_LENGTH:
        return False
    try:
        raw = base64.urlsafe_b64decode(eid)
    except Exception:
        return False
    # canonical ids are exactly base64(12 bytes), so no '=' padding and a
    # 12-byte decode; reject anything gen_entity_id could not have produced
    return len(raw) == 12 and "=" not in eid
