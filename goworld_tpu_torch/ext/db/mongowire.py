"""MongoDB wire-protocol client (OP_MSG), from scratch.

The port's copy of ``goworld_tpu/ext/db/mongowire.py``: the same
messages and client.

The reference talks to MongoDB through the mgo driver; the port depends on
no driver or server, so the modern wire protocol is
implemented directly: every command rides an OP_MSG (opcode 2013)
message — a 16-byte standard header, uint32 flagBits (0), and one
kind-0 body section holding a single BSON command document. Replies
come back the same shape. This is the full protocol surface MongoDB
3.6+ requires for an auth-less deployment; the in-process test/dev
server lives in :mod:`goworld_tpu_torch.ext.db.minimongo` and any real
mongod speaks the same bytes.

Blocking, single-connection, thread-safe via an internal lock —
mirroring :mod:`goworld_tpu_torch.ext.db.resp`: storage/kvdb ops already
serialize on a dedicated worker.
"""

from __future__ import annotations

import socket
import struct
import threading

from goworld_tpu_torch.ext.db import bson

_HDR = struct.Struct("<iiii")  # messageLength, requestID, responseTo, opCode
OP_MSG = 2013


class MongoError(Exception):
    """Server-reported command failure ({ok: 0, errmsg, code})."""


class MongoConnectionError(ConnectionError):
    pass


def parse_mongo_addr(addr: str) -> tuple[str, int, str]:
    """``host:port`` or ``host:port/dbname`` -> (host, port, db);
    db defaults to "goworld" like the reference's _DEFAULT_DB_NAME."""
    db = "goworld"
    if "/" in addr:
        addr, db_s = addr.rsplit("/", 1)
        db = db_s or db
    host, _, port_s = addr.rpartition(":")
    return host or "127.0.0.1", int(port_s or 27017), db


class MongoClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 db: str = "goworld", timeout: float = 10.0):
        self.host, self.port, self.db = host, port, db
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._rid = 0
        self._lock = threading.Lock()

    @classmethod
    def from_addr(cls, addr: str, **kw) -> "MongoClient":
        host, port, db = parse_mongo_addr(addr)
        return cls(host, port, db, **kw)

    # -- wire ----------------------------------------------------------
    def _connect(self) -> None:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        chunks = []
        while n:
            b = self._sock.recv(n)
            if not b:
                raise MongoConnectionError("connection closed by server")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _roundtrip_locked(self, cmd_doc: dict) -> dict:
        if self._sock is None:
            self._connect()
        self._rid += 1
        body = bson.encode(cmd_doc)
        payload = struct.pack("<I", 0) + b"\x00" + body  # flags, kind 0
        msg = _HDR.pack(16 + len(payload), self._rid, 0, OP_MSG) + payload
        assert self._sock is not None
        self._sock.sendall(msg)
        hdr = self._recv_exact(16)
        length, _rid, _resp_to, opcode = _HDR.unpack(hdr)
        rest = self._recv_exact(length - 16)
        if opcode != OP_MSG:
            raise MongoConnectionError(f"unexpected opcode {opcode}")
        # flagBits(4) + kind byte(1) + body document
        if rest[4] != 0:
            raise MongoConnectionError("expected kind-0 reply section")
        return bson.decode(rest, 5)

    def command(self, cmd_doc: dict) -> dict:
        """Run one command against ``self.db``; raises MongoError on
        {ok: 0} AND on per-document ``writeErrors`` (mongod reports
        those with ok:1 — swallowing them would let the storage
        retry-forever queue count a failed entity save as done). One
        transparent reconnect+retry on connection failure (the
        reference's mgo session refreshes the same way)."""
        cmd_doc = dict(cmd_doc)
        cmd_doc.setdefault("$db", self.db)
        with self._lock:
            for attempt in (0, 1):
                try:
                    reply = self._roundtrip_locked(cmd_doc)
                    break
                except (OSError, MongoConnectionError):
                    self.close()
                    if attempt:
                        raise
            else:  # pragma: no cover
                raise MongoConnectionError("unreachable")
        if not reply.get("ok"):
            raise MongoError(
                f"{reply.get('codeName', '')} "
                f"{reply.get('errmsg', 'command failed')}".strip())
        werrs = reply.get("writeErrors")
        if werrs:
            first = werrs[0] if isinstance(werrs, list) and werrs else {}
            raise MongoError(
                f"write error (code {first.get('code')}): "
                f"{first.get('errmsg', 'write failed')}")
        return reply

    # -- commands ------------------------------------------------------
    def ping(self) -> bool:
        try:
            return bool(self.command({"ping": 1}).get("ok"))
        except (MongoError, ConnectionError):
            return False

    def insert(self, coll: str, docs: list[dict]) -> int:
        r = self.command({"insert": coll, "documents": docs})
        return int(r.get("n", 0))

    def upsert_id(self, coll: str, _id, doc: dict) -> None:
        """Reference ``UpsertId``: replace-or-insert the whole doc."""
        self.command({
            "update": coll,
            "updates": [{"q": {"_id": _id},
                         "u": dict(doc, _id=_id),
                         "upsert": True, "multi": False}],
        })

    def find(self, coll: str, filter: dict | None = None, *,
             projection: dict | None = None, sort: dict | None = None,
             limit: int = 0) -> list[dict]:
        """Full-result find: follows multi-batch cursors with getMore
        (a real mongod caps an unlimited find's firstBatch at 101
        documents — entity listings and KV range scans must not stop
        there)."""
        cmd: dict = {"find": coll, "filter": filter or {}}
        if projection:
            cmd["projection"] = projection
        if sort:
            cmd["sort"] = sort
        if limit:
            cmd["limit"] = limit
        r = self.command(cmd)
        cur = r.get("cursor", {})
        out = list(cur.get("firstBatch", []))
        cid = cur.get("id", 0)
        while cid:
            r = self.command({"getMore": cid, "collection": coll})
            cur = r.get("cursor", {})
            out.extend(cur.get("nextBatch", []))
            cid = cur.get("id", 0)
        return out

    def find_id(self, coll: str, _id) -> dict | None:
        got = self.find(coll, {"_id": _id}, limit=1)
        return got[0] if got else None

    def delete(self, coll: str, filter: dict, *, many: bool = True) -> int:
        r = self.command({
            "delete": coll,
            "deletes": [{"q": filter, "limit": 0 if many else 1}],
        })
        return int(r.get("n", 0))
