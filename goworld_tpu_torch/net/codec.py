"""Batch codec for the hot sync-record path: a C++ core via ctypes, and
its numpy plain version.

Reference being rebuilt: the per-record encode/decode loops of the position
sync pipeline (``GateService.go:402-429``, ``DispatcherService.go:770-808``,
``GameService.go:395-407``). The reference touches each 16-byte record in Go
per packet hop; here whole batches are (de)serialised in one native call,
because the game host feeds the records straight into device input
buffers. The core is ``native/packet_codec.cpp``, built at first use by
:mod:`goworld_tpu_torch.native` (a failed build or load raises), as in the
JAX package; each ``*_plain`` function is the same transform on numpy
structured arrays, byte for byte (the tests hold the core to it). An
empty batch takes the plain path, as in the JAX package.

Public API (all batch-level):
  encode_sync_batch(ids, vals) -> bytes           # N x 32B records
  decode_sync_batch(buf) -> (ids S16[N], vals f32[N,4])
  encode_client_sync_batch(cids, ids, vals) -> bytes   # N x 48B
  decode_client_sync_batch(buf) -> (cids, ids, vals)
  bucket_by_shard(shard_of, n_shards, capacity) -> (idx i32[S,cap], counts)
  scan_frames(buf) -> ([(payload_offset, payload_size)], consumed)
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from goworld_tpu_torch import native

SYNC_DTYPE = np.dtype([("eid", "S16"), ("v", "<f4", (4,))])
CLIENT_SYNC_DTYPE = np.dtype(
    [("cid", "S16"), ("eid", "S16"), ("v", "<f4", (4,))]
)

_C = ctypes.POINTER(ctypes.c_char)
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("packet_codec")
    lib.encode_sync_records.argtypes = [_C, _F32, ctypes.c_int32, _C]
    lib.decode_sync_records.argtypes = [_C, ctypes.c_int32, _C, _F32]
    lib.encode_client_sync_records.argtypes = [
        _C, _C, _F32, ctypes.c_int32, _C]
    lib.decode_client_sync_records.argtypes = [
        _C, ctypes.c_int32, _C, _C, _F32]
    lib.scan_frames.argtypes = [
        _C, ctypes.c_int64, ctypes.c_int64, _I64, _I64, ctypes.c_int32,
        _I64]
    lib.scan_frames.restype = ctypes.c_int32
    lib.bucket_by_shard.argtypes = [
        _I32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _I32, _I32]
    return lib


def native_available() -> bool:
    """True once the C++ core is built and loaded (raises otherwise)."""
    return _lib() is not None


def _as_id_array(ids) -> np.ndarray:
    a = np.asarray(ids, dtype="S16")
    return np.ascontiguousarray(a)


def _ptr(a: np.ndarray, kind=_C):
    return a.ctypes.data_as(kind)


def _sync_args(ids, vals):
    ida = _as_id_array(ids)
    va = np.ascontiguousarray(np.asarray(vals, np.float32).reshape(-1, 4))
    n = ida.shape[0]
    if va.shape[0] != n:
        raise ValueError(f"length mismatch: {n} ids, {va.shape[0]} vals")
    return ida, va


def encode_sync_batch(ids, vals) -> bytes:
    """ids: N 16-char ids (list[str] or S16 array); vals: f32[N,4]."""
    ida, va = _sync_args(ids, vals)
    n = ida.shape[0]
    if not n:
        return encode_sync_batch_plain(ida, va)
    out = np.empty(n * 32, np.uint8)
    _lib().encode_sync_records(_ptr(ida), _ptr(va, _F32), n, _ptr(out))
    return out.tobytes()


def encode_sync_batch_plain(ids, vals) -> bytes:
    ida, va = _sync_args(ids, vals)
    rec = np.empty(ida.shape[0], SYNC_DTYPE)
    rec["eid"] = ida
    rec["v"] = va
    return rec.tobytes()


def _records(buf, size: int, what: str) -> int:
    n, rem = divmod(len(buf), size)
    if rem:
        raise ValueError(
            f"{what} length {len(buf)} not a multiple of {size}")
    return n


def decode_sync_batch(buf: bytes | memoryview) -> tuple[np.ndarray, np.ndarray]:
    """-> (ids S16[N], vals f32[N,4])."""
    n = _records(buf, 32, "sync batch")
    if not n:
        return decode_sync_batch_plain(buf)
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    ids = np.empty(n, "S16")
    vals = np.empty((n, 4), np.float32)
    _lib().decode_sync_records(_ptr(raw), n, _ptr(ids), _ptr(vals, _F32))
    return ids, vals


def decode_sync_batch_plain(
    buf: bytes | memoryview,
) -> tuple[np.ndarray, np.ndarray]:
    _records(buf, 32, "sync batch")
    rec = np.frombuffer(buf, SYNC_DTYPE)
    return rec["eid"].copy(), rec["v"].copy()


def _client_args(cids, ids, vals):
    ca = _as_id_array(cids)
    ida = _as_id_array(ids)
    va = np.ascontiguousarray(np.asarray(vals, np.float32).reshape(-1, 4))
    n = ca.shape[0]
    if ida.shape[0] != n or va.shape[0] != n:
        raise ValueError(
            f"length mismatch: {n} cids, {ida.shape[0]} ids, "
            f"{va.shape[0]} vals"
        )
    return ca, ida, va


def encode_client_sync_batch(cids, ids, vals) -> bytes:
    ca, ida, va = _client_args(cids, ids, vals)
    n = ca.shape[0]
    if not n:
        return encode_client_sync_batch_plain(ca, ida, va)
    out = np.empty(n * 48, np.uint8)
    _lib().encode_client_sync_records(
        _ptr(ca), _ptr(ida), _ptr(va, _F32), n, _ptr(out))
    return out.tobytes()


def encode_client_sync_batch_plain(cids, ids, vals) -> bytes:
    ca, ida, va = _client_args(cids, ids, vals)
    rec = np.empty(ca.shape[0], CLIENT_SYNC_DTYPE)
    rec["cid"] = ca
    rec["eid"] = ida
    rec["v"] = va
    return rec.tobytes()


def decode_client_sync_batch(
    buf: bytes | memoryview,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = _records(buf, 48, "client sync batch")
    if not n:
        return decode_client_sync_batch_plain(buf)
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    cids = np.empty(n, "S16")
    ids = np.empty(n, "S16")
    vals = np.empty((n, 4), np.float32)
    _lib().decode_client_sync_records(
        _ptr(raw), n, _ptr(cids), _ptr(ids), _ptr(vals, _F32))
    return cids, ids, vals


def decode_client_sync_batch_plain(
    buf: bytes | memoryview,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    _records(buf, 48, "client sync batch")
    rec = np.frombuffer(buf, CLIENT_SYNC_DTYPE)
    return rec["cid"].copy(), rec["eid"].copy(), rec["v"].copy()


def bucket_by_shard(
    shard_of: np.ndarray, n_shards: int, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Group record indices by shard (dispatcher re-batching analog).

    shard_of: i32[N] with -1 meaning drop. Returns (idx i32[S,capacity],
    counts i32[S]); overflow beyond capacity is dropped (callers size
    capacity to the device input cap and warn on counts == capacity).
    """
    so = np.ascontiguousarray(np.asarray(shard_of, np.int32))
    n = so.shape[0]
    if not n:
        return bucket_by_shard_plain(so, n_shards, capacity)
    idx = np.zeros((n_shards, capacity), np.int32)
    counts = np.zeros(n_shards, np.int32)
    _lib().bucket_by_shard(_ptr(so, _I32), n, n_shards, capacity,
                           _ptr(idx, _I32), _ptr(counts, _I32))
    return idx, counts


def bucket_by_shard_plain(
    shard_of: np.ndarray, n_shards: int, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    so = np.ascontiguousarray(np.asarray(shard_of, np.int32))
    idx = np.zeros((n_shards, capacity), np.int32)
    counts = np.zeros(n_shards, np.int32)
    for i in range(so.shape[0]):
        s = so[i]
        if 0 <= s < n_shards and counts[s] < capacity:
            idx[s, counts[s]] = i
            counts[s] += 1
    return idx, counts


def scan_frames(
    buf: bytes | bytearray, max_payload: int = 32 * 1024 * 1024,
    max_frames: int = 4096,
) -> tuple[list[tuple[int, int]], int]:
    """Find complete length-prefixed frames in a receive buffer.

    Returns ([(payload_offset, payload_size), ...], consumed_bytes).
    Raises ConnectionError on a malformed size prefix. (Used by sync-mode
    receivers; asyncio paths use readexactly framing in packet.py.)
    """
    raw = np.ascontiguousarray(np.frombuffer(bytes(buf), np.uint8))
    offs = np.empty(max_frames, np.int64)
    sizes = np.empty(max_frames, np.int64)
    consumed = np.zeros(1, np.int64)
    cnt = _lib().scan_frames(
        _ptr(raw), len(buf), max_payload, _ptr(offs, _I64),
        _ptr(sizes, _I64), max_frames, _ptr(consumed, _I64))
    if cnt < 0:
        raise ConnectionError("malformed frame size")
    return ([(int(offs[i]), int(sizes[i])) for i in range(cnt)],
            int(consumed[0]))


def scan_frames_plain(
    buf: bytes | bytearray, max_payload: int = 32 * 1024 * 1024,
    max_frames: int = 4096,
) -> tuple[list[tuple[int, int]], int]:
    frames = []
    pos = 0
    n = len(buf)
    while len(frames) < max_frames and pos + 4 <= n:
        size = int.from_bytes(buf[pos:pos + 4], "little")
        if size < 2 or size > max_payload:
            raise ConnectionError("malformed frame size")
        if pos + 4 + size > n:
            break
        frames.append((pos + 4, size))
        pos += 4 + size
    return frames, pos


# =======================================================================
# Delta-compressed client sync (the precision plane's wire half):
# steady-state sync fan-out bytes scale with
# dirty_frac * 13 B/record instead of every record's 48 B.
#
# The encoder (game side, per gate) keeps a per-(client, entity)
# BASELINE and ships int16 fixed-point deltas against it; a KEYFRAME
# record (full f32 values + the 32 B of addressing) is shipped when no
# baseline exists, every `keyframe_every` ticks per pair, or when a
# delta overflows int16 — after the first keyframe the pair is
# addressed by a u32 HANDLE assigned in-band, so a delta record is
# [u8 kind][u32 handle][4 x i16] = 13 B vs the full record's 48 B.
#
# DETERMINISM CONTRACT: the decoder's state is a pure function of the
# byte stream — every handle assignment, baseline value and reset
# rides in-band, and both sides advance baselines with the identical
# `base + dq * step` arithmetic, so decode is bit-deterministic. With
# the lattice quantizer active (GridSpec.precision=q16) x/z deltas are
# EXACT (both endpoints are lattice points, the step is a power of
# two); y/yaw reconstruct within step/2 until the next keyframe
# refresh (errors never chain: each delta is computed against the
# decoder-visible baseline). A decoder that missed a handle (gate
# restart) drops the record and self-heals at the pair's next
# keyframe — the same self-healing contract sync records already have.
# =======================================================================
DELTA_SYNC_VERSION = 1


def _i16(x: float) -> bool:
    return -32768.0 <= x <= 32767.0


class DeltaSyncEncoder:
    """Per-gate encoder state (game process). See module note above."""

    def __init__(self, step: float, yaw_step: float = 0.0,
                 keyframe_every: int = 16,
                 max_entries: int = 1 << 20):
        if not step > 0.0:
            raise ValueError(f"delta-sync step must be > 0, got {step!r}")
        if keyframe_every < 1:
            raise ValueError(
                f"sync_keyframe_every must be >= 1, got {keyframe_every!r}")
        # both steps round through f32 HERE: the wire header packs them
        # as "<f", so the decoder advances baselines with the f32
        # value — the encoder must chain with the IDENTICAL arithmetic
        # or its model of the decoder drifts between keyframes
        self.step = float(np.float32(step))
        # yaw is radians-scale; default step keeps headings visually
        # smooth (2*pi / 2^16) while fitting a full turn in i16
        self.yaw_step = float(np.float32(
            yaw_step if yaw_step > 0.0
            else (2.0 * 3.141592653589793) / 65536.0))
        self.keyframe_every = int(keyframe_every)
        self.max_entries = int(max_entries)
        # key (32B cid+eid) -> [handle, base_tick, bx, by, bz, byaw]
        self._base: dict[bytes, list] = {}
        self._next_handle = 0
        # keyframe_bytes/delta_bytes split the wire bytes BY RECORD
        # KIND (wire_bytes additionally counts the 16 B batch headers):
        # the sync-age plane correlates delivery staleness against
        # wire mode through sync_bytes_out{kind} (net/game.py)
        self.stats = {"keyframes": 0, "deltas": 0, "wire_bytes": 0,
                      "full_bytes": 0, "resets": 0,
                      "keyframe_bytes": 0, "delta_bytes": 0}

    def encode_batch(self, cids, eids, vals, tick: int) -> bytes:
        """(S16 cids, S16 eids, f32[N,4] vals) -> delta wire payload."""
        import struct

        cids = np.asarray(cids, "S16")
        eids = np.asarray(eids, "S16")
        vals = np.asarray(vals, np.float32).reshape(-1, 4)
        flags = 0
        if len(self._base) > self.max_entries:
            # bounded state: clear BOTH sides in-band (decoder resets
            # on the flag) — everything re-keyframes, nothing desyncs
            self._base.clear()
            self._next_handle = 0
            self.stats["resets"] += 1
            flags |= 1
        out = bytearray(struct.pack(
            "<BBHffI", DELTA_SYNC_VERSION, flags, self.keyframe_every,
            self.step, self.yaw_step, len(cids)))
        steps = (self.step, self.step, self.step, self.yaw_step)
        # S16 scalars strip trailing NULs; the wire needs fixed 16B
        craw = np.ascontiguousarray(cids).tobytes()
        eraw = np.ascontiguousarray(eids).tobytes()
        for i in range(len(cids)):
            key = craw[16 * i:16 * i + 16] + eraw[16 * i:16 * i + 16]
            v = vals[i]
            e = self._base.get(key)
            dq = None
            if e is not None and tick - e[1] < self.keyframe_every:
                dq = [round((float(v[j]) - e[2 + j]) / steps[j])
                      for j in range(4)]
                if not all(_i16(d) for d in dq):
                    dq = None          # i16 overflow -> keyframe
            if dq is None:
                if e is None:
                    e = self._base[key] = [self._next_handle, tick,
                                           0.0, 0.0, 0.0, 0.0]
                    self._next_handle += 1
                e[1] = tick
                e[2:6] = [float(v[0]), float(v[1]), float(v[2]),
                          float(v[3])]
                out += struct.pack("<B", 0) + key \
                    + struct.pack("<Iffff", e[0], *e[2:6])
                self.stats["keyframes"] += 1
                self.stats["keyframe_bytes"] += 53
            else:
                for j in range(4):     # decoder-identical chaining
                    e[2 + j] += dq[j] * steps[j]
                out += struct.pack("<BIhhhh", 1, e[0], *dq)
                self.stats["deltas"] += 1
                self.stats["delta_bytes"] += 13
        self.stats["wire_bytes"] += len(out)
        self.stats["full_bytes"] += 48 * len(cids)
        return bytes(out)

    def drop_client(self, cid) -> None:
        """Forget a disconnected client's baselines (its pairs simply
        re-keyframe if it ever reappears; handles are never reused)."""
        cid = np.ascontiguousarray(np.asarray([cid], "S16")).tobytes()
        for key in [k for k in self._base if k[:16] == cid]:
            del self._base[key]


class DeltaSyncDecoder:
    """Per-gate decoder state (gate process); pure function of the
    byte stream — see the determinism contract above."""

    def __init__(self, max_entries: int = 1 << 20):
        # handle -> [cid, eid, bx, by, bz, byaw]. Bounded: handles are
        # never reused on the wire, so under client churn the table
        # would otherwise grow one entry per pair EVER seen (the
        # encoder's reset only fires when ITS live table overflows,
        # which drop_client keeps small) — evict oldest-inserted past
        # the cap; an evicted-but-live pair just drops deltas until
        # its next keyframe (the stream's normal self-healing).
        self._base: dict[int, list] = {}
        self.max_entries = int(max_entries)
        self.stats = {"records": 0, "dropped_unknown": 0, "resets": 0,
                      "evicted": 0}

    def decode_batch(self, payload) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """payload -> (S16 cids[M], S16 eids[M], f32[M,4] vals);
        unknown-handle deltas are dropped (self-heal at keyframe)."""
        import struct

        buf = bytes(payload)
        try:
            ver, flags, _kfe, step, yaw_step, count = \
                struct.unpack_from("<BBHffI", buf, 0)
        except struct.error as exc:
            raise ConnectionError(
                f"delta-sync header truncated: {exc}") from exc
        if ver != DELTA_SYNC_VERSION:
            raise ConnectionError(
                f"delta-sync version {ver} unsupported")
        if flags & 1:
            self._base.clear()
            self.stats["resets"] += 1
        off = 16
        steps = (step, step, step, yaw_step)
        cids, eids, vals = [], [], []
        try:
            for _ in range(count):
                kind = buf[off]
                off += 1
                if kind == 0:
                    cid, eid = buf[off:off + 16], buf[off + 16:off + 32]
                    off += 32
                    handle, x, y, z, yw = struct.unpack_from("<Iffff",
                                                             buf, off)
                    off += 20
                    self._base[handle] = [cid, eid, x, y, z, yw]
                    while len(self._base) > self.max_entries:
                        self._base.pop(next(iter(self._base)))
                        self.stats["evicted"] += 1
                    cids.append(cid)
                    eids.append(eid)
                    vals.append((x, y, z, yw))
                elif kind == 1:
                    handle, dx, dy, dz, dyw = struct.unpack_from(
                        "<Ihhhh", buf, off)
                    off += 12
                    e = self._base.get(handle)
                    if e is None:
                        self.stats["dropped_unknown"] += 1
                        continue
                    for j, d in enumerate((dx, dy, dz, dyw)):
                        e[2 + j] += d * steps[j]
                    cids.append(e[0])
                    eids.append(e[1])
                    vals.append(tuple(e[2:6]))
                else:
                    raise ConnectionError(
                        f"delta-sync record kind {kind} unknown")
        except (struct.error, IndexError) as exc:
            # truncated mid-record: the caller drops the batch (sync
            # records self-heal); a raw struct.error must never escape
            # into the dispatcher read loop
            raise ConnectionError(
                f"delta-sync batch truncated at {off}: {exc}") from exc
        self.stats["records"] += count
        return (np.asarray(cids, "S16"), np.asarray(eids, "S16"),
                np.asarray(vals, np.float32).reshape(-1, 4))
