"""Binary packet framing: pooled packets + asyncio stream codec.

Reference being rebuilt: ``engine/netutil/Packet.go`` (pooled little-endian
buffer with Append/Read for u16/u32/float32/EntityID/VarStr/VarBytes/Data)
and ``engine/netutil/PacketConnection.go`` (length-prefixed framing over
TCP). Wire format kept in the same spirit:

    [u32 payload_size][u16 msgtype][payload ...]        (little-endian)

EntityIDs are fixed 16 ASCII bytes (:mod:`goworld_tpu_torch.utils.ids`);
structured args are MessagePack (reference ``MsgPacker.go``), encoded by
:mod:`goworld_tpu_torch.utils.mpack` as ``msgpack.packb(obj,
use_bin_type=True)`` does and decoded as ``msgpack.unpackb(raw=False)``
does, non-str map keys refused; hot-path position
sync records are fixed 32-byte binary records — 16B entity id + 4×f32
x,y,z,yaw (reference ``proto.go:122`` SYNC_INFO_SIZE_PER_ENTITY plus the id
prefix) — batch-encoded by :mod:`goworld_tpu_torch.net.codec`.
"""

from __future__ import annotations

import asyncio
import struct
import zlib
from typing import Any

from goworld_tpu_torch.utils import faults, mpack, tracing
from goworld_tpu_torch.utils.ids import ENTITYID_LENGTH

MAX_PAYLOAD_LENGTH = 32 * 1024 * 1024  # defensive cap (reference 16M-ish)
_SIZE_FMT = struct.Struct("<I")
_TYPE_FMT = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
_F32 = struct.Struct("<f")
HEADER_SIZE = 4  # the u32 size prefix; msgtype counts into payload_size

# bit 15 of the u16 msgtype field marks a trace-context trailer: the
# last CTX_WIRE_SIZE bytes of the payload are a packed
# tracing.TraceContext, stripped before the handler sees the packet.
# Every real msgtype lives in the documented 0..2047 routing ranges
# (net/proto.py; guarded by tests/test_proto_invariants.py), so the bit
# can never collide — and untraced packets pay zero bytes (the framed
# stream is byte-identical to the pre-tracing wire).
TRACE_FLAG = 0x8000
# bit 14 marks a sync-age stamp trailer (utils/syncage.py): the 45-byte
# per-batch provenance record the sync fan-out legs carry from game to
# gate. Same contract as TRACE_FLAG — the routing ranges stop at 2047,
# so the bit never collides, unstamped packets are byte-identical to
# the pre-stamp wire, and the trailer is stripped into ``packet.age``
# before any handler sees the payload. When both trailers ride one
# packet the trace context is OUTERMOST (appended last, stripped
# first) — tracing wraps every other plane.
AGE_FLAG = 0x4000
MSGTYPE_MASK = 0x7FFF

_pool: list["Packet"] = []
_POOL_MAX = 256


class Packet:
    """A reusable binary message buffer (reference ``Packet.go``).

    Append-side builds `[u16 msgtype][payload]`; read-side walks the same
    bytes with a cursor. Use :func:`alloc` / :meth:`release` for pooling on
    hot paths; plain construction also works.
    """

    __slots__ = ("buf", "rpos", "trace", "age")

    def __init__(self, data: bytes | bytearray | None = None):
        self.buf = bytearray(data) if data is not None else bytearray()
        self.rpos = 0
        # attached tracing.TraceContext (or None): set by decode_wire on
        # traced inbound packets and by hops/new_packet on outbound ones;
        # applied to the wire as a flagged trailer by wire_payload
        self.trace = None
        # attached syncage.SyncAgeStamp (or None): set by decode_wire on
        # stamped inbound sync batches and by the game's fan-out flush
        # on outbound ones; the dispatcher patches its forward instant
        # into it before relaying (utils/syncage.py)
        self.age = None

    # -- lifecycle -------------------------------------------------------
    @staticmethod
    def alloc() -> "Packet":
        try:
            # list.pop is GIL-atomic; EAFP keeps this safe across the
            # logic + network threads without a lock
            return _pool.pop()
        except IndexError:
            return Packet()

    def release(self) -> None:
        self.trace = None  # never leak a context into a pooled reuse
        self.age = None
        if len(_pool) < _POOL_MAX:
            self.buf.clear()
            self.rpos = 0
            _pool.append(self)

    # -- append side -----------------------------------------------------
    def append_u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def append_bool(self, v: bool) -> None:
        self.buf.append(1 if v else 0)

    def append_u16(self, v: int) -> None:
        self.buf += _U16.pack(v & 0xFFFF)

    def append_u32(self, v: int) -> None:
        self.buf += _U32.pack(v & 0xFFFFFFFF)

    def append_f32(self, v: float) -> None:
        self.buf += _F32.pack(v)

    def append_bytes(self, b: bytes) -> None:
        self.buf += b

    def append_entity_id(self, eid: str) -> None:
        b = eid.encode("ascii")
        if len(b) != ENTITYID_LENGTH:
            raise ValueError(f"bad entity id {eid!r}")
        self.buf += b

    def append_var_str(self, s: str) -> None:
        self.append_var_bytes(s.encode("utf-8"))

    def append_var_bytes(self, b: bytes) -> None:
        self.append_u32(len(b))
        self.buf += b

    def append_data(self, obj: Any) -> None:
        """MessagePack-encode an arbitrary structure (reference
        ``AppendData``)."""
        self.append_var_bytes(mpack.packb(obj))

    def append_args(self, args: tuple | list) -> None:
        """Argument list: u16 count + one msgpack blob per arg (reference
        ``AppendArgs`` packs each arg separately so the receiver can lazily
        decode)."""
        self.append_u16(len(args))
        for a in args:
            self.append_data(a)

    # -- read side -------------------------------------------------------
    def _take(self, n: int) -> memoryview:
        if self.rpos + n > len(self.buf):
            raise EOFError("packet underrun")
        mv = memoryview(self.buf)[self.rpos:self.rpos + n]
        self.rpos += n
        return mv

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_bool(self) -> bool:
        return self._take(1)[0] != 0

    def read_u16(self) -> int:
        return _U16.unpack(self._take(2))[0]

    def read_u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def read_f32(self) -> float:
        return _F32.unpack(self._take(4))[0]

    def read_bytes(self, n: int) -> bytes:
        return bytes(self._take(n))

    def read_entity_id(self) -> str:
        return bytes(self._take(ENTITYID_LENGTH)).decode("ascii")

    def read_var_bytes(self) -> bytes:
        n = self.read_u32()
        return bytes(self._take(n))

    def read_var_str(self) -> str:
        return self.read_var_bytes().decode("utf-8")

    def read_data(self) -> Any:
        return mpack.unpackb(self.read_var_bytes(), strict_map_key=True)

    def read_args(self) -> list:
        n = self.read_u16()
        return [self.read_data() for _ in range(n)]

    def remaining(self) -> int:
        return len(self.buf) - self.rpos

    def payload(self) -> bytes:
        return bytes(self.buf)


def new_packet(msgtype: int) -> Packet:
    p = Packet.alloc()
    p.append_u16(msgtype)
    if tracing.active:
        # inside a traced hop (tracing.use/hop): outbound packets carry
        # the emitting span's context so the next hop parents to it
        ctx = tracing.current()
        if ctx is not None:
            p.trace = ctx
    return p


def wire_payload(p: Packet) -> bytes:
    """Payload bytes as they go on the wire: verbatim when untraced and
    unstamped; with TRACE_FLAG / AGE_FLAG set on the msgtype and the
    packed trailer(s) appended when attached. The age stamp goes on
    FIRST so the trace context stays outermost (decode strips in
    reverse)."""
    if p.trace is None and p.age is None:
        return bytes(p.buf)
    buf = bytearray(p.buf)
    if p.age is not None:
        buf[1] |= 0x40  # little-endian u16 msgtype: bit 14 in byte 1
        buf += p.age.pack()
    if p.trace is not None:
        buf[1] |= 0x80  # bit 15 lives in byte 1
        buf += p.trace.pack()
    return bytes(buf)


def decode_wire(body: bytes | bytearray) -> tuple[int, Packet]:
    """Inverse of :func:`wire_payload` + the msgtype read: returns the
    masked msgtype and a Packet positioned after it, with any trace
    trailer stripped into ``packet.trace`` (handlers see byte-identical
    payloads either way)."""
    p = Packet(body)
    msgtype = p.read_u16()
    if msgtype & TRACE_FLAG:
        msgtype &= MSGTYPE_MASK
        if len(p.buf) < 2 + tracing.CTX_WIRE_SIZE:
            raise ConnectionError("traced packet too short for trailer")
        p.trace = tracing.TraceContext.unpack(
            bytes(p.buf[-tracing.CTX_WIRE_SIZE:])
        )
        del p.buf[-tracing.CTX_WIRE_SIZE:]
        # clear the flag in the stored bytes too: handlers that forward
        # or copy the raw buffer (queue-while-blocked, broadcasts) must
        # see payload bytes identical to an untraced packet's — the
        # flag is re-applied by wire_payload iff a context is attached
        p.buf[1] &= 0x7F
    if msgtype & AGE_FLAG:
        from goworld_tpu_torch.utils import syncage

        msgtype &= ~AGE_FLAG
        if len(p.buf) < 2 + syncage.STAMP_WIRE_SIZE:
            raise ConnectionError("stamped packet too short for trailer")
        try:
            p.age = syncage.SyncAgeStamp.unpack(
                bytes(p.buf[-syncage.STAMP_WIRE_SIZE:])
            )
        except ValueError as exc:
            raise ConnectionError(f"bad sync-age stamp: {exc}") from exc
        del p.buf[-syncage.STAMP_WIRE_SIZE:]
        p.buf[1] &= 0xBF  # same re-apply contract as the trace flag
    return msgtype, p


def frame(p: Packet) -> bytes:
    """Wrap a packet's payload with the u32 size prefix for the wire."""
    payload = wire_payload(p)
    return _SIZE_FMT.pack(len(payload)) + payload


class PacketConnection:
    """Framed packet IO over an asyncio stream (reference
    ``PacketConnection.go``). Writes are buffered by the transport; reads
    return (msgtype, Packet-positioned-after-msgtype).

    ``compress=True`` runs one compression stream per direction over
    the connection — the cheap-stream-compression role snappy plays in
    the reference's client edge (``ClientProxy.go:38-53``).
    ``compress_codec`` picks the stream codec:

    * ``"snappy"`` (default) — the reference's codec, via the
      from-scratch framing-format implementation in
      :mod:`goworld_tpu_torch.net.snappy` (each packet is one or more
      framed chunks; the stream identifier leads the first send).
    * ``"zlib"`` — one zlib-1 stream with ``Z_SYNC_FLUSH`` at packet
      boundaries, byte for byte the JAX package's stream; its shared
      per-connection dictionary compresses the dominant small packets
      (heartbeats, 34-byte sync records) better than snappy's per-chunk
      framing, at more CPU per byte.

    Both ends must agree on flag AND codec, exactly like the
    reference's ini flag; a codec the environment cannot provide
    raises at construction (silent fallback would desync the peer)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        compress: bool = False,
        compress_codec: str = "snappy",
        edge: str = "",
    ):
        self.reader = reader
        self.writer = writer
        # fault-injection edge label ("game->dispatcher", ...): owners
        # set it so the seeded fault plane (utils/faults.py) can match
        # wire rules against this connection; "" = never injected
        self.edge = edge
        self.compress = compress
        if compress:
            if compress_codec == "snappy":
                from goworld_tpu_torch.net import snappy as _snappy

                _snappy.available()  # builds the core; raises on failure
                self._comp = _snappy.StreamCompressor()
                self._decomp = _snappy.StreamDecompressor()
                self._snappy = True
            elif compress_codec == "zlib":
                self._comp = zlib.compressobj(1)
                self._decomp = zlib.decompressobj()
                self._snappy = False
            else:
                raise ValueError(
                    f"compress_codec must be snappy|zlib, "
                    f"got {compress_codec!r}"
                )
        self._closed = False

    def send(self, p: Packet, release: bool = True) -> None:
        if self._closed:
            return
        try:
            if self.compress:
                raw = wire_payload(p)
                if self._snappy:
                    payload = self._comp.compress(raw)
                else:
                    payload = self._comp.compress(raw) \
                        + self._comp.flush(zlib.Z_SYNC_FLUSH)
                self.writer.write(_SIZE_FMT.pack(len(payload)) + payload)
            elif faults.active and self.edge \
                    and self._faulted_send(p):
                pass  # the fault consumed (or rewrote) the packet
            else:
                self.writer.write(frame(p))
        except (ConnectionError, RuntimeError):
            self._closed = True
        if release:
            p.release()

    def _faulted_send(self, p: Packet) -> bool:
        """Apply a seeded wire fault to this send, if one fires.
        Returns True when the fault handled the packet (the normal
        write must be skipped). Only the uncompressed path is injected:
        stream compression shares codec state with the peer, so
        byte-level tampering there models a codec bug, not a network
        fault."""
        mt = ((p.buf[0] | (p.buf[1] << 8)) & MSGTYPE_MASK
              if len(p.buf) >= 2 else 0)
        rule = faults.plane.wire_fault(self.edge, mt, trace_ctx=p.trace)
        if rule is None:
            return False
        if rule.kind == "drop":
            return True
        payload = wire_payload(p)
        data = _SIZE_FMT.pack(len(payload)) + payload
        if rule.kind == "dup":
            self.writer.write(data)
            self.writer.write(data)
            return True
        if rule.kind == "truncate":
            # a consistently-framed but cut-short payload: the peer's
            # decoder sees a malformed packet (size < 2 or a handler
            # underrun) and severs the connection — the corruption
            # recovery path, not a stream desync
            cut = payload[: len(payload) // 2]
            self.writer.write(_SIZE_FMT.pack(len(cut)) + cut)
            return True
        if rule.kind == "disconnect":
            self._closed = True
            try:
                self.writer.transport.abort()
            except (AttributeError, RuntimeError):
                self.writer.close()
            return True
        if rule.kind == "delay":
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return False  # no loop (unit context): send normally

            def _late_write(w=self.writer, d=data):
                try:
                    w.write(d)
                except (ConnectionError, RuntimeError):
                    pass

            loop.call_later(rule.delay_s, _late_write)
            return True
        return False

    async def drain(self) -> None:
        if not self._closed:
            try:
                await self.writer.drain()
            except ConnectionError:
                self._closed = True

    async def recv(self) -> tuple[int, Packet]:
        hdr = await self.reader.readexactly(HEADER_SIZE)
        (size,) = _SIZE_FMT.unpack(hdr)
        if size < 2 or size > MAX_PAYLOAD_LENGTH:
            raise ConnectionError(f"bad packet size {size}")
        body: bytes | bytearray = await self.reader.readexactly(size)
        if self.compress:
            if self._snappy:
                try:
                    # the bound is checked chunk-by-chunk during
                    # decode, so a bomb stream fails before allocation
                    body = self._decomp.decompress(
                        bytes(body), max_out=MAX_PAYLOAD_LENGTH
                    )
                except ValueError as exc:
                    raise ConnectionError(
                        f"bad compressed packet: {exc}")
            else:
                try:
                    # max_length caps output BEFORE allocation: a
                    # crafted high-ratio stream (decompression bomb)
                    # hits the limit and leaves unconsumed input
                    # instead of eating RAM
                    body = self._decomp.decompress(
                        bytes(body), MAX_PAYLOAD_LENGTH + 1
                    )
                except zlib.error as exc:
                    raise ConnectionError(f"bad compressed packet: {exc}")
                if self._decomp.unconsumed_tail \
                        or len(body) > MAX_PAYLOAD_LENGTH:
                    raise ConnectionError("decompressed packet too large")
            if len(body) < 2:
                raise ConnectionError("short decompressed packet")
        return decode_wire(body)

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass

    @property
    def closed(self) -> bool:
        return self._closed

    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None
