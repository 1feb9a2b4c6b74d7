"""Minimal RESP2 (REdis Serialization Protocol) client.

The port's copy of ``goworld_tpu/ext/db/resp.py``: the same frames,
slot hash and client.

The reference talks to redis through the redigo driver
(``engine/kvdb/backend/kvdbredis``, ``ext/db/gwredis.go``); the port
depends on neither a redis driver package nor a redis server, so the
wire protocol is implemented directly (it is small: five type
sigils over a TCP stream) and a compatible in-process server lives in
:mod:`goworld_tpu_torch.ext.db.miniredis` for tests and single-host deployments.
Any real redis endpoint speaks the same bytes.

Blocking, single-connection, thread-safe via an internal lock — matching
how the engine uses it: every storage/kvdb op already serializes on one
dedicated worker (``storage.py``/``kvdb.py``), so connection pooling would
buy nothing.
"""

from __future__ import annotations

import socket
import threading


class RespError(Exception):
    """Server-reported error reply (the ``-ERR ...`` line)."""


class RespConnectionError(ConnectionError):
    pass


def parse_addr(addr: str) -> tuple[str, int, int]:
    """``host:port`` or ``host:port/db`` -> (host, port, db)."""
    db = 0
    if "/" in addr:
        addr, db_s = addr.rsplit("/", 1)
        db = int(db_s or 0)
    host, _, port_s = addr.rpartition(":")
    return host or "127.0.0.1", int(port_s or 6379), db


# --- cluster-mode key hashing (shared by the kvdb cluster client and
# --- miniredis's cluster mode) ------------------------------------------

NUM_SLOTS = 16384


def crc16(data: bytes) -> int:
    """CRC16-CCITT (XModem) — redis cluster's key-slot hash."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def key_slot(key: bytes) -> int:
    """Redis cluster slot of a key, honoring ``{hashtag}`` semantics:
    if the key contains ``{...}`` with a NON-EMPTY tag, only the tag
    bytes hash (so ``{user1}.a`` and ``{user1}.b`` co-locate)."""
    lb = key.find(b"{")
    if lb != -1:
        rb = key.find(b"}", lb + 1)
        if rb != -1 and rb > lb + 1:
            key = key[lb + 1:rb]
    return crc16(key) % NUM_SLOTS


class RespClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, timeout: float = 10.0):
        self.host, self.port, self.db = host, port, db
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._rfile = None
        self._lock = threading.Lock()

    @classmethod
    def from_addr(cls, addr: str, **kw) -> "RespClient":
        host, port, db = parse_addr(addr)
        return cls(host, port, db, **kw)

    # -- connection -----------------------------------------------------
    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        if self.db:
            self._command_locked(b"SELECT", str(self.db).encode())

    def close(self) -> None:
        with self._lock:
            self._teardown()

    def _teardown(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    # -- protocol -------------------------------------------------------
    @staticmethod
    def _encode(args: tuple[bytes, ...]) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_reply(self):
        line = self._rfile.readline()
        if not line:
            raise RespConnectionError("connection closed by server")
        sigil, body = line[:1], line[1:-2]
        if sigil == b"+":
            return body.decode()
        if sigil == b"-":
            raise RespError(body.decode())
        if sigil == b":":
            return int(body)
        if sigil == b"$":
            n = int(body)
            if n == -1:
                return None
            data = self._rfile.read(n + 2)
            if len(data) != n + 2:
                raise RespConnectionError("short bulk read")
            return data[:-2]
        if sigil == b"*":
            n = int(body)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespConnectionError(f"bad RESP sigil {sigil!r}")

    def _command_locked(self, *args: bytes):
        self._sock.sendall(self._encode(args))
        return self._read_reply()

    def command(self, *args):
        """Run one command; args are str/bytes/int. One transparent
        reconnect+retry on connection failure (reference ``storageRoutine``
        reconnects on EOF, ``storage.go:141-262``)."""
        enc = tuple(
            a if isinstance(a, bytes) else str(a).encode() for a in args
        )
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    return self._command_locked(*enc)
                except (OSError, RespConnectionError):
                    self._teardown()
                    if attempt:
                        raise

    # -- convenience ----------------------------------------------------
    def ping(self) -> bool:
        return self.command("PING") == "PONG"

    def get(self, key) -> bytes | None:
        return self.command("GET", key)

    def set(self, key, val) -> None:
        self.command("SET", key, val)

    def setnx(self, key, val) -> bool:
        return bool(self.command("SETNX", key, val))

    def delete(self, *keys) -> int:
        return self.command("DEL", *keys)

    def exists(self, key) -> bool:
        return bool(self.command("EXISTS", key))

    def mget(self, keys: list) -> list[bytes | None]:
        if not keys:
            return []
        return self.command("MGET", *keys)

    def scan_keys(self, match: str) -> list[bytes]:
        """Full SCAN sweep (cursor loop) for keys matching ``match``.
        Deduplicated: redis's SCAN contract allows the same key to appear
        in multiple cursor iterations."""
        cursor = b"0"
        seen: dict[bytes, None] = {}
        while True:
            reply = self.command("SCAN", cursor, "MATCH", match,
                                 "COUNT", "512")
            cursor, chunk = reply[0], reply[1]
            for k in chunk:
                seen[k] = None
            if cursor in (b"0", "0", 0):
                return list(seen)
