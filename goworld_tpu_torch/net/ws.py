"""Minimal RFC 6455 WebSocket transport (stdlib only).

The gate's websocket edge and the bot client's ``ws`` mode ride this
module: the API subset those two call sites use (``serve``/``connect``,
``send``/``recv``/``close``/``open``, ``async for`` message iteration),
implemented on asyncio streams. It speaks the same protocol as the
third-party ``websockets`` package, which the JAX package prefers where
it is installed; the port always uses this module, so a host without
that package serves websocket clients the same way.

Scope (all the engine needs — one framed engine packet per BINARY
message, matching the reference's websocket edge,
``GateService.go:121-168``):

* HTTP/1.1 upgrade handshake (Sec-WebSocket-Key -> SHA1/base64 accept);
* frame codec: FIN + opcode, 7/16/64-bit lengths, client->server
  masking (required by the RFC; servers send unmasked);
* text and binary data frames with continuation reassembly, ping ->
  pong, close -> echoed close;
* no extensions, no subprotocols, no TLS (the gate terminates TLS on
  its TCP listener; the ws edge is plaintext like the reference).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct

__all__ = ["WebSocket", "ConnectionClosed", "serve", "connect"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

# bound on a single message (continuations included): the engine's
# client-edge packets are far smaller; a hostile length header must
# not balloon the reassembly buffer
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


class ConnectionClosed(ConnectionError):
    """The peer closed (or the transport died) mid-conversation.
    Subclasses ConnectionError so every existing recv-loop handler
    (botclient, gate) catches it without naming this module."""


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _xor_mask(payload: bytes, key: bytes) -> bytes:
    """``payload[i] ^ key[i % 4]`` for the whole buffer as ONE big-int
    XOR (a per-byte Python loop on the gate's per-packet ingress path
    would cost seconds for a large frame and stall the event loop)."""
    n = len(payload)
    if not n:
        return payload
    stream = (key * ((n + 3) // 4))[:n]
    return (int.from_bytes(payload, "little")
            ^ int.from_bytes(stream, "little")).to_bytes(n, "little")


class WebSocket:
    """One established websocket; the object handed to server handlers
    and returned by :func:`connect`.

    ``await send(data)`` ships one message (bytes -> binary frame, str
    -> text frame); ``await recv()`` returns the next DATA message
    payload (control frames are handled internally); ``async for msg
    in ws`` iterates messages until close. ``open`` mirrors the
    legacy ``websockets`` attribute the call sites probe."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, mask_outgoing: bool):
        self._reader = reader
        self._writer = writer
        self._mask = mask_outgoing  # clients mask, servers don't
        self._send_lock = asyncio.Lock()
        self._closed = False

    @property
    def open(self) -> bool:
        return not self._closed

    # -- frame codec ----------------------------------------------------
    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._closed and opcode != OP_CLOSE:
            raise ConnectionClosed("websocket is closed")
        head = bytearray([0x80 | opcode])
        mask_bit = 0x80 if self._mask else 0
        n = len(payload)
        if n < 126:
            head.append(mask_bit | n)
        elif n < (1 << 16):
            head.append(mask_bit | 126)
            head += struct.pack(">H", n)
        else:
            head.append(mask_bit | 127)
            head += struct.pack(">Q", n)
        if self._mask:
            key = os.urandom(4)
            head += key
            payload = _xor_mask(payload, key)
        async with self._send_lock:
            try:
                self._writer.write(bytes(head) + payload)
                await self._writer.drain()
            except (ConnectionError, OSError) as exc:
                self._closed = True
                raise ConnectionClosed(str(exc)) from exc

    async def _read_frame(self) -> tuple[int, bool, bytes]:
        """(opcode, fin, unmasked payload); raises ConnectionClosed on
        EOF/transport death."""
        try:
            b0, b1 = await self._reader.readexactly(2)
            fin = bool(b0 & 0x80)
            opcode = b0 & 0x0F
            masked = bool(b1 & 0x80)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(
                    ">H", await self._reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack(
                    ">Q", await self._reader.readexactly(8))
            if n > MAX_MESSAGE_BYTES:
                raise ConnectionClosed(f"frame too large ({n} bytes)")
            key = await self._reader.readexactly(4) if masked else b""
            payload = await self._reader.readexactly(n) if n else b""
        except (asyncio.IncompleteReadError, ConnectionError,
                OSError) as exc:
            self._closed = True
            raise ConnectionClosed(str(exc)) from exc
        if masked:
            payload = _xor_mask(payload, key)
        return opcode, fin, payload

    # -- public API (the websockets-package subset) ---------------------
    async def send(self, data) -> None:
        if isinstance(data, str):
            await self._send_frame(OP_TEXT, data.encode("utf-8"))
        else:
            await self._send_frame(OP_BINARY, bytes(data))

    async def recv(self):
        """Next data message: bytes for binary, str for text."""
        buf = bytearray()
        first_op: int | None = None
        while True:
            if self._closed:
                raise ConnectionClosed("websocket is closed")
            opcode, fin, payload = await self._read_frame()
            if opcode == OP_PING:
                await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._closed = True
                try:
                    await self._send_frame(OP_CLOSE, payload[:2])
                except ConnectionClosed:
                    pass
                self._shut_transport()
                raise ConnectionClosed("peer sent close")
            if opcode in (OP_TEXT, OP_BINARY):
                first_op = opcode
                buf += payload
            elif opcode == OP_CONT and first_op is not None:
                buf += payload
            else:
                raise ConnectionClosed(f"bad opcode {opcode:#x}")
            if len(buf) > MAX_MESSAGE_BYTES:
                raise ConnectionClosed("message too large")
            if fin:
                data = bytes(buf)
                return data.decode("utf-8") if first_op == OP_TEXT \
                    else data

    def __aiter__(self) -> "WebSocket":
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    def _shut_transport(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass

    async def close(self, code: int = 1000) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            await self._send_frame(OP_CLOSE, struct.pack(">H", code))
        except ConnectionClosed:
            pass
        self._shut_transport()


# =======================================================================
# server side
# =======================================================================
async def _server_handshake(reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> bool:
    """Read the HTTP upgrade request and answer 101 (or 400)."""
    try:
        head = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout=10.0)
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
            asyncio.TimeoutError, ConnectionError, OSError):
        return False
    headers: dict[str, str] = {}
    for line in head.split(b"\r\n")[1:]:
        if b":" in line:
            k, _, v = line.partition(b":")
            headers[k.strip().lower().decode("latin-1")] = \
                v.strip().decode("latin-1")
    key = headers.get("sec-websocket-key")
    if key is None or "websocket" not in \
            headers.get("upgrade", "").lower():
        writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                     b"Content-Length: 0\r\n\r\n")
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass
        return False
    writer.write(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: "
        + _accept_key(key).encode("ascii") + b"\r\n\r\n"
    )
    try:
        await writer.drain()
    except (ConnectionError, OSError):
        return False
    return True


async def serve(handler, host: str, port: int) -> asyncio.AbstractServer:
    """``websockets.serve`` twin: start a TCP listener; each upgraded
    connection runs ``await handler(ws)``. Returns the asyncio server
    (``.close()`` to stop listening)."""

    async def _on_conn(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        ws = None
        try:
            if not await _server_handshake(reader, writer):
                writer.close()
                return
            ws = WebSocket(reader, writer, mask_outgoing=False)
            await handler(ws)
        except (ConnectionClosed, ConnectionError, OSError):
            pass
        finally:
            if ws is not None:
                await ws.close()
            else:
                try:
                    writer.close()
                except Exception:
                    pass

    return await asyncio.start_server(_on_conn, host, port)


# =======================================================================
# client side
# =======================================================================
async def connect(uri: str) -> WebSocket:
    """``websockets.connect`` twin for ``ws://host:port[/path]``."""
    if not uri.startswith("ws://"):
        raise ValueError(f"only ws:// URIs are supported (got {uri!r})")
    rest = uri[len("ws://"):]
    hostport, _, path = rest.partition("/")
    host, _, port_s = hostport.partition(":")
    port = int(port_s or 80)
    reader, writer = await asyncio.open_connection(host, port)
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    writer.write(
        (f"GET /{path} HTTP/1.1\r\n"
         f"Host: {hostport}\r\n"
         "Upgrade: websocket\r\n"
         "Connection: Upgrade\r\n"
         f"Sec-WebSocket-Key: {key}\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode("latin-1")
    )
    await writer.drain()
    try:
        head = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout=10.0)
    except (asyncio.IncompleteReadError, asyncio.TimeoutError) as exc:
        writer.close()
        raise ConnectionError(f"websocket handshake failed: {exc}") \
            from exc
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        writer.close()
        raise ConnectionError(
            f"websocket handshake rejected: {status.decode('latin-1')}")
    expect = _accept_key(key).encode("ascii")
    if expect not in head:
        writer.close()
        raise ConnectionError("websocket accept-key mismatch")
    return WebSocket(reader, writer, mask_outgoing=True)
