"""Snappy codec: the block format (a C++ core and its Python twin) and
the public framing format.

The reference compresses gate<->client streams with snappy
(``ClientProxy.go:38-53`` via netconnutil's ``NewSnappyStream``). The
C++ core (``native/snappy_core.cpp``, built at first use by
:mod:`goworld_tpu_torch.native`) implements the public BLOCK format from
google/snappy's format_description.txt and CRC32C; ``py_compress``,
``py_uncompress`` and ``py_crc32c`` are the same algorithms in Python,
byte for byte (the plain versions the tests hold the core to). This
module adds the STREAM framing from framing_format.txt:

  stream identifier chunk: 0xff + 3B LE length(6) + "sNaPpY"
  compressed data chunk:   0x00 + 3B LE length + 4B masked CRC32C (of
                           the UNCOMPRESSED data) + snappy block
  uncompressed data chunk: 0x01 + 3B LE length + 4B masked CRC32C + raw
  (chunk payload <= 65536 bytes of uncompressed data; encoders emit the
  uncompressed form when compression would inflate)

so a framed stream produced here is readable by any conforming snappy
framing decoder and vice versa. The streams run on the C++ core; a
failed build or load of it raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

from goworld_tpu_torch import native

_MAX_CHUNK = 65536                 # framing: max uncompressed per chunk
_MASK_DELTA = 0xA282EAD8
_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"

_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_STREAM_ID = 0xFF
# 0x02..0x7f are unskippable reserved; 0x80..0xfd skippable padding


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("snappy_core")
    # c_char_p srcs: ctypes passes Python bytes by pointer with no
    # copy — this sits on the per-packet hot path
    lib.gw_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gw_crc32c.restype = ctypes.c_uint32
    lib.gw_snappy_max_compressed_length.argtypes = [ctypes.c_int64]
    lib.gw_snappy_max_compressed_length.restype = ctypes.c_int64
    lib.gw_snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    lib.gw_snappy_compress.restype = ctypes.c_int64
    lib.gw_snappy_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.gw_snappy_uncompress.restype = ctypes.c_int64
    return lib


class _Scratch(threading.local):
    """Reusable per-thread output buffer: the per-packet hot path must
    not pay a fresh zeroed allocation per chunk (the buffer grows
    geometrically and is zeroed only when (re)created)."""

    def __init__(self):
        self.buf = ctypes.create_string_buffer(80 * 1024)

    def at_least(self, n: int):
        if len(self.buf) < n:
            self.buf = ctypes.create_string_buffer(
                max(n, 2 * len(self.buf)))
        return self.buf


_scratch = _Scratch()


def available() -> bool:
    """True once the C++ core is built and loaded (raises otherwise)."""
    return _lib() is not None


# ------------------------------------------------------------ block API --

def compress(data: bytes) -> bytes:
    """Snappy BLOCK compress (C++ core)."""
    lib = _lib()
    cap = lib.gw_snappy_max_compressed_length(len(data))
    out = _scratch.at_least(cap)
    n = lib.gw_snappy_compress(bytes(data), len(data), out)
    return ctypes.string_at(out, n)


def uncompress(data: bytes, max_len: int = 1 << 27) -> bytes:
    """Snappy BLOCK decompress (C++ core; validates, raises ValueError
    on malformed input). ``max_len`` bounds the scratch buffer —
    framing callers pass the 64KB chunk cap, so the steady state
    allocates nothing."""
    lib = _lib()
    out = _scratch.at_least(max_len)
    n = lib.gw_snappy_uncompress(bytes(data), len(data), out, max_len)
    if n < 0:
        raise ValueError("malformed snappy block")
    return ctypes.string_at(out, n)


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data`` (C++ core)."""
    return int(_lib().gw_crc32c(bytes(data), len(data)))


# -------------------------------------------- the Python twin (plain) --

@functools.cache
def _crc_table() -> tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


def py_crc32c(data: bytes) -> int:
    """CRC32C of ``data``, bytewise (the C++ core slices by 8)."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v | 0x80) & 0xFF)
        v >>= 7
    out.append(v)
    return bytes(out)


def _literal(src: bytes) -> bytes:
    n = len(src) - 1
    if n < 60:
        head = bytes((n << 2,))
    else:
        nb = 1 if n < (1 << 8) else 2 if n < (1 << 16) \
            else 3 if n < (1 << 24) else 4
        head = bytes(((59 + nb) << 2,)) + n.to_bytes(nb, "little")
    return head + src


def _copy_le64(offset: int, length: int) -> bytes:
    if length < 12 and offset < 2048:
        return bytes((1 | ((length - 4) << 2) | ((offset >> 8) << 5),
                      offset & 0xFF))
    return bytes((2 | ((length - 1) << 2), offset & 0xFF,
                  (offset >> 8) & 0xFF))


def _copy(offset: int, length: int) -> bytes:
    out = bytearray()
    while length >= 68:
        out += _copy_le64(offset, 64)
        length -= 64
    if length > 64:
        out += _copy_le64(offset, 60)
        length -= 60
    return bytes(out + _copy_le64(offset, length))


def py_compress(data: bytes) -> bytes:
    """Snappy BLOCK compress, the C++ core's greedy 14-bit hash matcher
    step for step (so the output is the same bytes)."""
    src = bytes(data)
    n = len(src)
    out = bytearray(_varint(n))
    if n == 0:
        return bytes(out)
    if n < 16:
        return bytes(out + _literal(src))
    table = [-1] * (1 << 14)
    ip = lit_start = 0
    limit = n - 4
    while ip <= limit:
        word = int.from_bytes(src[ip:ip + 4], "little")
        h = ((word * 0x1E35A7BD) & 0xFFFFFFFF) >> 18
        cand = table[h]
        table[h] = ip
        if cand >= 0 and src[cand:cand + 4] == src[ip:ip + 4] \
                and ip - cand < 65536:
            mlen = 4
            while ip + mlen < n and src[cand + mlen] == src[ip + mlen]:
                mlen += 1
            if ip > lit_start:
                out += _literal(src[lit_start:ip])
            out += _copy(ip - cand, mlen)
            ip += mlen
            lit_start = ip
        else:
            ip += 1
    if lit_start < n:
        out += _literal(src[lit_start:])
    return bytes(out)


def py_uncompress(data: bytes, max_len: int = 1 << 27) -> bytes:
    """Snappy BLOCK decompress with the C++ core's checks (ValueError
    where it returns -1)."""
    src = bytes(data)
    n = len(src)
    ulen = shift = ip = 0
    while True:
        if ip >= n or shift > 28:
            raise ValueError("malformed snappy block")
        b = src[ip]
        ip += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if ulen > max_len:
        raise ValueError("malformed snappy block")
    out = bytearray()
    while ip < n:
        tag = src[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if ip + extra > n:
                    raise ValueError("malformed snappy block")
                length = int.from_bytes(src[ip:ip + extra], "little") + 1
                ip += extra
            if ip + length > n or len(out) + length > ulen:
                raise ValueError("malformed snappy block")
            out += src[ip:ip + length]
            ip += length
            continue
        if kind == 1:
            if ip >= n:
                raise ValueError("malformed snappy block")
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | src[ip]
            ip += 1
        else:
            width = 2 if kind == 2 else 4
            if ip + width > n:
                raise ValueError("malformed snappy block")
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[ip:ip + width], "little")
            ip += width
        if offset == 0 or offset > len(out) or len(out) + length > ulen:
            raise ValueError("malformed snappy block")
        # byte by byte: overlapping copies (offset < len) replicate
        for _ in range(length):
            out.append(out[-offset])
    if len(out) != ulen:
        raise ValueError("malformed snappy block")
    return bytes(out)


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------- framing API --

class StreamCompressor:
    """Incremental encoder for the snappy framing format: each
    ``compress(data)`` call returns framed chunk bytes (the stream
    identifier is prepended to the first output), mirroring the
    zlib-compressobj shape PacketConnection uses."""

    def __init__(self):
        self._started = False

    def compress(self, data: bytes) -> bytes:
        out = bytearray()
        if not self._started:
            out += _STREAM_ID
            self._started = True
        for off in range(0, len(data), _MAX_CHUNK):
            piece = data[off:off + _MAX_CHUNK]
            crc = _masked_crc(piece)
            comp = compress(piece)
            if len(comp) < len(piece):
                body_len = 4 + len(comp)
                out += bytes((_CHUNK_COMPRESSED,
                              body_len & 0xFF, (body_len >> 8) & 0xFF,
                              (body_len >> 16) & 0xFF))
                out += crc.to_bytes(4, "little")
                out += comp
            else:  # compression would inflate — emit raw (spec behavior)
                body_len = 4 + len(piece)
                out += bytes((_CHUNK_UNCOMPRESSED,
                              body_len & 0xFF, (body_len >> 8) & 0xFF,
                              (body_len >> 16) & 0xFF))
                out += crc.to_bytes(4, "little")
                out += piece
        return bytes(out)


class StreamDecompressor:
    """Incremental decoder: feed framed bytes, get uncompressed bytes.
    Buffers partial chunks across calls; raises ValueError on a corrupt
    stream (bad CRC, malformed block, reserved unskippable chunk)."""

    def __init__(self):
        self._buf = bytearray()

    def decompress(self, data: bytes, max_out: int | None = None) -> bytes:
        """``max_out`` bounds the decoded size DURING decode (a
        high-ratio stream of max-expansion chunks is the snappy shape
        of a decompression bomb — the check must not wait for the full
        allocation)."""
        self._buf += data
        out = bytearray()
        while True:
            if max_out is not None and len(out) > max_out:
                raise ValueError("snappy stream exceeds size bound")
            if len(self._buf) < 4:
                break
            ctype = self._buf[0]
            body_len = (self._buf[1] | (self._buf[2] << 8)
                        | (self._buf[3] << 16))
            if len(self._buf) < 4 + body_len:
                break
            body = bytes(self._buf[4:4 + body_len])
            del self._buf[:4 + body_len]
            if ctype == _CHUNK_STREAM_ID:
                if body != _STREAM_ID[4:]:
                    raise ValueError("bad snappy stream identifier")
                continue
            if ctype in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
                if body_len < 4:
                    raise ValueError("short snappy chunk")
                want_crc = int.from_bytes(body[:4], "little")
                piece = (uncompress(body[4:], _MAX_CHUNK + 1)
                         if ctype == _CHUNK_COMPRESSED else body[4:])
                if len(piece) > _MAX_CHUNK:
                    raise ValueError("oversized snappy chunk")
                if _masked_crc(piece) != want_crc:
                    raise ValueError("snappy chunk CRC mismatch")
                out += piece
                continue
            if 0x80 <= ctype <= 0xFE:
                continue  # skippable (0x80-0xfd reserved, 0xfe padding)
            raise ValueError(f"unskippable snappy chunk 0x{ctype:02x}")
        return bytes(out)
