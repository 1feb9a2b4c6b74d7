"""BSON (Binary JSON) encoder/decoder, from scratch.

The port's copy of ``goworld_tpu/ext/db/bson.py``, with its validated
decoder: the same bytes for the same document.

The reference's MongoDB backends (``engine/storage/backend/mongodb/
mongodb.go:27-136``, ``engine/kvdb/backend/kvdb_mongodb/mongodb.go``)
ride the mgo driver; the port depends on no MongoDB driver, so the
public BSON spec (bsonspec.org) is implemented directly — the subset a
game-state store needs:

  0x01 double   0x02 string   0x03 document   0x04 array
  0x05 binary   0x08 bool     0x0A null       0x10 int32   0x12 int64

Python mapping: float <-> double, str <-> string, dict <-> document,
list <-> array, bytes <-> binary (subtype 0), bool <-> bool,
None <-> null, int -> int32 when it fits else int64 (both decode to
int). Attr trees are exactly this shape (entity attrs are
plain-JSON-like after ``to_plain``).
"""

from __future__ import annotations

import struct
from typing import Any

_D = struct.Struct("<d")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _encode_value(out: bytearray, name: bytes, v: Any) -> None:
    # bool BEFORE int: bool is an int subclass
    if isinstance(v, bool):
        out += b"\x08" + name + b"\x00" + (b"\x01" if v else b"\x00")
    elif isinstance(v, float):
        out += b"\x01" + name + b"\x00" + _D.pack(v)
    elif isinstance(v, int):
        if I32_MIN <= v <= I32_MAX:
            out += b"\x10" + name + b"\x00" + _I32.pack(v)
        else:
            out += b"\x12" + name + b"\x00" + _I64.pack(v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += b"\x02" + name + b"\x00" + _I32.pack(len(b) + 1) + b \
            + b"\x00"
    elif isinstance(v, dict):
        out += b"\x03" + name + b"\x00" + encode(v)
    elif isinstance(v, (list, tuple)):
        out += b"\x04" + name + b"\x00" + encode(
            {str(i): x for i, x in enumerate(v)})
    elif isinstance(v, (bytes, bytearray)):
        out += b"\x05" + name + b"\x00" + _I32.pack(len(v)) + b"\x00" \
            + bytes(v)
    elif v is None:
        out += b"\x0a" + name + b"\x00"
    else:
        raise TypeError(f"BSON cannot encode {type(v).__name__}")


def encode(doc: dict) -> bytes:
    """Encode a dict into one BSON document."""
    body = bytearray()
    for k, v in doc.items():
        if not isinstance(k, str):
            k = str(k)
        kb = k.encode("utf-8")
        if b"\x00" in kb:
            raise ValueError("BSON keys cannot contain NUL")
        _encode_value(body, kb, v)
    return _I32.pack(len(body) + 5) + bytes(body) + b"\x00"


def _read_cstring(buf: memoryview, at: int) -> tuple[str, int]:
    end = at
    while buf[end] != 0:
        end += 1
    return bytes(buf[at:end]).decode("utf-8"), end + 1


def _decode_doc(buf: memoryview, at: int) -> tuple[dict, int]:
    # wire int32 lengths are attacker-controlled (minimongo feeds raw
    # socket bytes here): validate every one BEFORE advancing, or a
    # negative length walks the cursor backwards and loops the handler
    # thread forever
    if len(buf) - at < 5:
        raise ValueError("BSON document truncated")
    (total,) = _I32.unpack_from(buf, at)
    if total < 5 or total > len(buf) - at:
        raise ValueError(f"BSON document length {total} out of range")
    end = at + total
    if buf[end - 1] != 0:
        raise ValueError("BSON document missing terminator")
    p = at + 4
    doc: dict = {}
    while p < end - 1:
        t = buf[p]
        p += 1
        name, p = _read_cstring(buf, p)
        if t == 0x01:
            (doc[name],) = _D.unpack_from(buf, p)
            p += 8
        elif t == 0x02:
            (n,) = _I32.unpack_from(buf, p)
            p += 4
            if n < 1 or p + n > end:
                raise ValueError(f"BSON string length {n} out of range")
            doc[name] = bytes(buf[p:p + n - 1]).decode("utf-8")
            p += n
        elif t == 0x03:
            doc[name], p = _decode_doc(buf, p)
        elif t == 0x04:
            sub, p = _decode_doc(buf, p)
            doc[name] = [sub[k] for k in sub]  # keys are "0","1",...
        elif t == 0x05:
            (n,) = _I32.unpack_from(buf, p)
            p += 5  # length + subtype byte
            if n < 0 or p + n > end:
                raise ValueError(f"BSON binary length {n} out of range")
            doc[name] = bytes(buf[p:p + n])
            p += n
        elif t == 0x08:
            doc[name] = buf[p] != 0
            p += 1
        elif t == 0x0A:
            doc[name] = None
        elif t == 0x10:
            (doc[name],) = _I32.unpack_from(buf, p)
            p += 4
        elif t == 0x12:
            (doc[name],) = _I64.unpack_from(buf, p)
            p += 8
        else:
            raise ValueError(f"BSON type 0x{t:02x} not supported")
    return doc, end


def decode(data: bytes | memoryview, at: int = 0) -> dict:
    """Decode one BSON document starting at ``at``."""
    doc, _ = _decode_doc(memoryview(data), at)
    return doc


def decode_with_end(data: bytes | memoryview,
                    at: int = 0) -> tuple[dict, int]:
    """Decode one document and return (doc, offset past it) — for
    walking OP_MSG sequences of concatenated documents."""
    return _decode_doc(memoryview(data), at)
