"""Replication stream frames, the port's copy of
``goworld_tpu/replication/frames.py`` (host only): SnapshotChain records
in-band.

The stream reuses the v2 quantized/delta chain format (freeze.py
``SnapshotChain``) verbatim — a frame body IS a chain record, so the
byte economics match the disk chain (~13 B/row steady state at NPC
scale) and the lattice-domain bit-exactness guarantees carry over.
What this module adds is the WIRE envelope:

* every frame carries ``crc`` (CRC32 of its body bytes) and
  ``prev_crc`` (the previous frame's body CRC — zero on a keyframe,
  which re-anchors the chain), so a torn stream — truncation,
  corruption, reordering, a dropped frame — is DETECTED, never
  half-applied;
* a strict per-stream ``seq`` so replays and reorders are named;
* decoding resolves delta records against the IN-MEMORY keyframe
  (the disk resolver re-reads the keyframe file; a standby holds it
  live), with the same base-plane-CRC guard so a delta can never be
  merged onto the wrong keyframe.

Failure model (the decoder): any damaged/foreign/out-of-order frame
raises :class:`TornStreamError` and flips ``needs_keyframe`` — the
stream self-heals at the next keyframe, which the primary sends on
cadence and on explicit resync request. Nothing is ever applied from
a frame that failed any check (reject-whole, the CorruptSnapshotError
stance of the disk chain).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from goworld_tpu_torch.utils import mpack

REPLICATION_STREAM_VERSION = 1

# plane dtypes/widths — must match freeze.py's v2 chain records
_PLANE_WIDTHS = {
    "pos_xz": (np.int16, 2), "pos_y": (np.float32, 1),
    "yaw": (np.int16, 1), "moving": (np.uint8, 1),
}


def _crc(b: bytes) -> int:
    import zlib

    return zlib.crc32(b) & 0xFFFFFFFF


class TornStreamError(RuntimeError):
    """A replication frame failed an integrity/continuity check and was
    rejected whole. ``reason`` is a stable machine token (counted per
    kind by the applier's reject metrics)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def encode_frame(seq: int, tick: int, kind: str, body: bytes,
                 prev_crc: int) -> bytes:
    """One wire frame. ``body`` is the msgpack'd chain record; the
    envelope CRC covers exactly those bytes (so the body blob can be
    handed to msgpack once and shipped verbatim)."""
    return mpack.packb({
        "v": REPLICATION_STREAM_VERSION,
        "seq": int(seq),
        "tick": int(tick),
        "kind": kind,
        "body": body,
        "crc": _crc(body),
        "prev_crc": int(prev_crc) if kind != "key" else 0,
    })


def decode_envelope(blob: bytes) -> dict:
    """Parse + integrity-check one frame envelope (no chain/continuity
    checks — those need decoder state). Raises TornStreamError."""
    try:
        fr = mpack.unpackb(blob)
    except Exception as exc:
        raise TornStreamError("unparseable",
                              f"{len(blob)} bytes: {exc}") from exc
    if not isinstance(fr, dict) \
            or fr.get("v") != REPLICATION_STREAM_VERSION:
        raise TornStreamError(
            "bad_version", f"version {fr.get('v') if isinstance(fr, dict) else '?'!r}")
    for k in ("seq", "tick", "kind", "body", "crc"):
        if k not in fr:
            raise TornStreamError("missing_field", k)
    if fr["kind"] not in ("key", "delta"):
        raise TornStreamError("bad_kind", repr(fr["kind"]))
    if _crc(fr["body"]) != fr["crc"]:
        raise TornStreamError(
            "body_crc", f"seq {fr['seq']}: envelope CRC mismatch")
    return fr


def resolve_delta_record(rec: dict, key_rec: dict) -> dict:
    """Resolve a v2 delta record against an IN-MEMORY keyframe record
    (the standby's copy of the last applied keyframe), returning the
    v1-shaped data dict. Mirrors freeze._resolve_snapshot_v2's delta
    branch minus the disk read; the base plane CRCs recorded in the
    delta are verified against the held keyframe so a delta can never
    merge onto the wrong base."""
    from goworld_tpu_torch import freeze as _freeze

    for nm in _PLANE_WIDTHS:
        if _crc(key_rec["planes"][nm]) != rec["base"]["plane_crcs"][nm]:
            raise TornStreamError(
                "base_crc", f"plane {nm!r} mismatch vs held keyframe")
    host = rec["host"]
    m = len(host["entities"])
    rows = np.frombuffer(rec["rows"], np.int32)
    if rows.shape[0] != m:
        raise TornStreamError(
            "row_shape", f"{rows.shape[0]} rows for {m} entities")
    planes: dict[str, bytes] = {}
    try:
        for nm, (dt, w) in _PLANE_WIDTHS.items():
            bp = np.frombuffer(key_rec["planes"][nm], dt).reshape(-1, w)
            sp = np.frombuffer(rec["sparse"][nm], dt).reshape(-1, w)
            out = np.zeros((m, w), dt)
            ref = rows >= 0
            out[ref] = bp[rows[ref]]
            out[~ref] = sp
            planes[nm] = out.tobytes()
    except Exception as exc:
        raise TornStreamError(
            "delta_reconstruct", repr(exc)) from exc
    step = float(rec["quant"]["step"])
    origin = tuple(rec["quant"].get("origin", (0.0, 0.0)))
    data = _freeze._inject_planes(
        _copy_host(host), planes, step, origin)
    return data, planes


def _copy_host(host: dict) -> dict:
    """Shallow-plus copy of a record's host section deep enough that
    _inject_planes (which writes pos/yaw/moving back into the entity
    dicts) never mutates the decoder's held keyframe record."""
    out = dict(host)
    out["entities"] = [dict(e) for e in host["entities"]]
    return out


class StreamEncoder:
    """Primary-side framing: chain records (built by the replication
    worker's SnapshotChain) -> wire frames, CRC-chained. One encoder
    per stream; single-threaded (the worker's thread)."""

    def __init__(self):
        self.seq = 0
        self._prev_crc = 0

    def encode(self, tick: int, kind: str, rec: dict) -> bytes:
        body = mpack.packb(rec)
        blob = encode_frame(self.seq, tick, kind, body, self._prev_crc)
        self._prev_crc = _crc(body)
        self.seq += 1
        return blob


class StreamDecoder:
    """Standby-side validation + resolution. ``feed(blob)`` returns
    ``(kind, tick, data_v1, planes, eids)`` for an accepted frame —
    ``planes`` is the lattice-domain state (quantized plane bytes,
    row i == eids[i]), the byte-exact surface the determinism tests
    compare — or raises :class:`TornStreamError` (frame rejected
    whole, ``needs_keyframe`` set; the stream heals at the next
    keyframe)."""

    def __init__(self):
        self.needs_keyframe = True
        self.next_seq = 0
        self.applied_seq = -1
        self.applied_tick = -1
        self.last_reject: str | None = None
        self._prev_crc: int | None = None
        self._key_rec: dict | None = None

    def _torn(self, reason: str, detail: str) -> TornStreamError:
        self.needs_keyframe = True
        self.last_reject = reason
        return TornStreamError(reason, detail)

    def feed(self, blob: bytes):
        try:
            fr = decode_envelope(blob)
        except TornStreamError as exc:
            raise self._torn(exc.reason, str(exc)) from None
        kind, seq = fr["kind"], int(fr["seq"])
        if kind == "key":
            # a keyframe re-anchors the chain — but never BACKWARD: a
            # replayed/reordered old keyframe would roll the mirror
            # back behind frames already applied
            if seq < self.next_seq:
                raise self._torn(
                    "stale_keyframe",
                    f"seq {seq} < expected {self.next_seq}")
            try:
                rec = mpack.unpackb(fr["body"])
                planes = {nm: rec["planes"][nm] for nm in _PLANE_WIDTHS}
                for nm in _PLANE_WIDTHS:
                    if _crc(planes[nm]) != rec["plane_crcs"][nm]:
                        raise self._torn(
                            "plane_crc", f"keyframe plane {nm!r}")
                from goworld_tpu_torch import freeze as _freeze

                data = _freeze._inject_planes(
                    _copy_host(rec["host"]), planes,
                    float(rec["quant"]["step"]),
                    tuple(rec["quant"].get("origin", (0.0, 0.0))))
            except TornStreamError:
                raise
            except Exception as exc:
                raise self._torn("bad_record", repr(exc)) from None
            self._key_rec = rec
            self.needs_keyframe = False
        else:
            if self.needs_keyframe or self._key_rec is None:
                raise self._torn(
                    "awaiting_keyframe",
                    f"delta seq {seq} before any accepted keyframe")
            if seq != self.next_seq:
                raise self._torn(
                    "seq_gap", f"seq {seq} != expected {self.next_seq}")
            if self._prev_crc is not None \
                    and fr.get("prev_crc") != self._prev_crc:
                raise self._torn(
                    "chain_break",
                    f"seq {seq}: prev_crc {fr.get('prev_crc')} != "
                    f"{self._prev_crc}")
            try:
                rec = mpack.unpackb(fr["body"])
                data, planes = resolve_delta_record(rec, self._key_rec)
            except TornStreamError as exc:
                raise self._torn(exc.reason, str(exc)) from None
            except Exception as exc:
                raise self._torn("bad_record", repr(exc)) from None
        self._prev_crc = fr["crc"]
        self.next_seq = seq + 1
        self.applied_seq = seq
        self.applied_tick = int(fr["tick"])
        self.last_reject = None
        eids = [e["id"] for e in data["entities"]]
        return kind, int(fr["tick"]), data, planes, eids
