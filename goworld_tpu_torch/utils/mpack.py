"""MessagePack for the freeze files, storage, kvdb and packet payloads,
in plain Python.

The JAX package writes its snapshots with ``msgpack.packb(data,
use_bin_type=True)`` and reads them with ``msgpack.unpackb(raw,
raw=False, strict_map_key=False)``. The port needs no package for it:
these two functions encode the types a freeze record holds (None, bool,
int, float, str, bytes, list/tuple, dict) with the same choices, so a
file either package writes is byte for byte the file the other writes,
and each reads the other's.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb", "UnpackError"]


class UnpackError(ValueError):
    """The bytes are not one complete MessagePack object."""


# the packed form of short strings (the records' keys and type names)
_STR_CACHE: dict[str, bytes] = {}
_F64 = struct.Struct(">Bd").pack


def _head(n: int, out: bytearray, fix, fix_lim: int, wide) -> None:
    """A length header: the fix form below ``fix_lim``, else the 8-,
    16- or 32-bit form (None where the type has no such form)."""
    if fix is not None and n < fix_lim:
        out.append(fix | n)
    elif wide[0] is not None and n < 1 << 8:
        out += bytes((wide[0], n))
    elif n < 1 << 16:
        out += bytes((wide[1],)) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes((wide[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"object of length {n} is too large")


def _pack_str(s: str, out: bytearray) -> None:
    b = _STR_CACHE.get(s)
    if b is None:
        e = s.encode("utf-8")
        hd = bytearray()
        _head(len(e), hd, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        b = bytes(hd) + e
        if len(e) <= 16 and len(_STR_CACHE) < 4096:
            _STR_CACHE[s] = b
    out += b


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                               (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if v < 1 << lim:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too large")
    else:
        for code, fmt, lim in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << lim):
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too small")


def _pack(obj, out: bytearray) -> None:
    t = type(obj)
    if t is str:
        _pack_str(obj, out)
    elif t is dict:
        _head(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list or t is tuple:
        _head(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif t is float:
        out += _F64(0xCB, obj)
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += _F64(0xCB, float(obj))
    elif isinstance(obj, str):
        _pack_str(str(obj), out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _head(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), out)
    elif isinstance(obj, dict):
        _pack(dict(obj), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# (reader, width) of each fixed-width type, and (reader of the length,
# its width, kind) of each 8/16/32-bit length form
_FIXED = {c: (struct.Struct(f).unpack_from, struct.calcsize(f))
          for c, f in {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                       0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                       0xCA: ">f", 0xCB: ">d"}.items()}
_LEN = {c: (struct.Struct(f).unpack_from, struct.calcsize(f), k)
        for c, (f, k) in {0xD9: (">B", "str"), 0xDA: (">H", "str"),
                          0xDB: (">I", "str"), 0xC4: (">B", "bin"),
                          0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                          0xDC: (">H", "arr"), 0xDD: (">I", "arr"),
                          0xDE: (">H", "map"), 0xDF: (">I", "map")}.items()}


def _take(b: bytes, i: int, n: int) -> int:
    """The index after ``n`` bytes at ``i``, which must be there."""
    if i + n > len(b):
        raise UnpackError("truncated data")
    return i + n


def _str(b: bytes, i: int, n: int):
    j = _take(b, i, n)
    try:
        return b[i:j].decode("utf-8"), j
    except UnicodeDecodeError as exc:
        raise UnpackError(str(exc)) from exc


def _arr(b: bytes, i: int, n: int, strict: bool):
    out = []
    for _ in range(n):
        v, i = _unpack(b, i, strict)
        out.append(v)
    return out, i


def _map(b: bytes, i: int, n: int, strict: bool):
    out = {}
    for _ in range(n):
        k, i = _unpack(b, i, strict)
        if strict and type(k) not in (str, bytes):
            raise UnpackError(f"{type(k).__name__} is not allowed for map "
                              "key when strict_map_key=True")
        if isinstance(k, list):
            raise UnpackError("unhashable map key")
        out[k], i = _unpack(b, i, strict)
    return out, i


def _unpack(b: bytes, i: int, strict: bool):
    """(the object at ``b[i:]``, the index after it)."""
    if i >= len(b):
        raise UnpackError("truncated data")
    c = b[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c <= 0xBF:
        return _str(b, i, c & 0x1F)
    if 0x80 <= c <= 0x8F:
        return _map(b, i, c & 0x0F, strict)
    if 0x90 <= c <= 0x9F:
        return _arr(b, i, c & 0x0F, strict)
    if c == 0xC0:
        return None, i
    if c == 0xC2 or c == 0xC3:
        return c == 0xC3, i
    f = _FIXED.get(c)
    if f is not None:
        j = _take(b, i, f[1])
        return f[0](b, i)[0], j
    f = _LEN.get(c)
    if f is None:
        raise UnpackError(f"unsupported type byte 0x{c:02x}")
    j = _take(b, i, f[1])
    n = f[0](b, i)[0]
    kind = f[2]
    if kind == "str":
        return _str(b, j, n)
    if kind == "bin":
        return b[j:_take(b, j, n)], j + n
    if kind == "arr":
        return _arr(b, j, n, strict)
    return _map(b, j, n, strict)


def unpackb(raw: bytes, strict_map_key: bool = False):
    """``msgpack.unpackb(raw, raw=False, strict_map_key=...)``: one
    object, or :class:`UnpackError` when ``raw`` is not exactly one (or,
    with ``strict_map_key``, holds a map key that is not str or bytes,
    as msgpack's default refuses)."""
    raw = bytes(raw)
    obj, i = _unpack(raw, 0, strict_map_key)
    if i != len(raw):
        raise UnpackError(f"{len(raw) - i} extra bytes after the object")
    return obj
