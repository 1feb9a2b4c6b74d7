"""In-process MongoDB server speaking real OP_MSG wire bytes.

The port's copy of ``goworld_tpu/ext/db/minimongo.py``: the same
replies, message cap and empty-command answer.

The role miniredis plays for the redis backends: the port depends on no
MongoDB server, so a compatible one is implemented over
the same from-scratch BSON/OP_MSG codecs the client uses — tests and
single-host deployments run the REAL wire protocol end to end, and
the storage/kvdb backends work unchanged against an actual mongod.

Supported commands (the surface the reference backends use):
``hello``/``isMaster``, ``ping``, ``insert``, ``update`` (upsert-by-q,
whole-doc replace), ``find`` (empty filter, by ``_id``, ``_id`` range
``$gte``/``$lt``/``$gt``/``$lte``, projection, sort on ``_id``,
limit), ``getMore`` (a first batch of 101 documents, or ``batchSize``,
as mongod's), ``delete``, ``drop``, ``listCollections``.
"""

from __future__ import annotations

import socketserver
import struct
import threading

from goworld_tpu_torch.ext.db import bson

_HDR = struct.Struct("<iiii")
OP_MSG = 2013
# real mongod caps messages at 48 MB (maxMessageSizeBytes); anything
# outside [16, cap] means the framing cannot be trusted — drop the
# connection instead of letting _recv_exact chew on garbage
MAX_MESSAGE_BYTES = 48 * 1024 * 1024


def _match(doc: dict, q: dict) -> bool:
    for k, cond in q.items():
        v = doc.get(k)
        if isinstance(cond, dict) and any(
                key.startswith("$") for key in cond):
            for op, rhs in cond.items():
                if op == "$gte":
                    if not (v is not None and v >= rhs):
                        return False
                elif op == "$gt":
                    if not (v is not None and v > rhs):
                        return False
                elif op == "$lte":
                    if not (v is not None and v <= rhs):
                        return False
                elif op == "$lt":
                    if not (v is not None and v < rhs):
                        return False
                elif op == "$eq":
                    if v != rhs:
                        return False
                else:
                    raise ValueError(f"minimongo: operator {op!r}")
        elif v != cond:
            return False
    return True


def _select(coll: dict, q: dict) -> list:
    """The documents of ``coll`` that match ``q``, in the collection's
    order. A filter of one plain ``_id`` value is a key lookup (a
    collection is keyed by its documents' ``_id``): the same documents
    as the scan, without a pass over the collection for each write and
    read of one entity."""
    if len(q) == 1 and "_id" in q:
        v = q["_id"]
        if isinstance(v, (str, bytes, int)) or v is None:
            d = coll.get(v)
            return [d] if d is not None and d.get("_id") == v else []
    return [d for d in coll.values() if _match(d, q)]


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            while True:
                hdr = self._recv_exact(16)
                if hdr is None:
                    return
                length, rid, _resp, opcode = _HDR.unpack(hdr)
                if length < 16 or length > MAX_MESSAGE_BYTES:
                    return  # untrustworthy framing: drop connection
                body = self._recv_exact(length - 16)
                if body is None:
                    return
                if opcode != OP_MSG or len(body) < 5 or body[4] != 0:
                    return  # unsupported legacy opcode: drop connection
                try:
                    cmd = bson.decode(body, 5)
                except ValueError:
                    return  # malformed BSON: drop connection
                reply = self._dispatch(cmd)
                rb = bson.encode(reply)
                payload = struct.pack("<I", 0) + b"\x00" + rb
                self.request.sendall(
                    _HDR.pack(16 + len(payload), 0, rid, OP_MSG)
                    + payload)
        except (ConnectionError, OSError):
            return

    def _recv_exact(self, n: int) -> bytes | None:
        chunks = []
        while n:
            b = self.request.recv(n)
            if not b:
                return None
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    # -- commands -------------------------------------------------------
    def _dispatch(self, cmd: dict) -> dict:
        srv: MiniMongo = self.server.owner  # type: ignore[attr-defined]
        if not cmd:
            # next(iter({})) would raise StopIteration and kill the
            # handler thread; answer like mongod answers nonsense
            return {"ok": 0.0, "errmsg": "empty command", "code": 59}
        name = next(iter(cmd))
        db = cmd.get("$db", "goworld")
        with srv.lock:
            try:
                if name in ("hello", "isMaster", "ismaster"):
                    return {"ok": 1.0, "isWritablePrimary": True,
                            "maxWireVersion": 17, "minWireVersion": 6}
                if name == "ping":
                    return {"ok": 1.0}
                if name == "insert":
                    coll = srv.colls.setdefault((db, cmd["insert"]), {})
                    n = 0
                    for d in cmd.get("documents", []):
                        if "_id" not in d:
                            d = dict(d, _id=f"auto{srv.next_id()}")
                        if d["_id"] in coll:
                            return {"ok": 1.0, "n": n, "writeErrors": [
                                {"index": n, "code": 11000,
                                 "errmsg": "duplicate key"}]}
                        coll[d["_id"]] = d
                        n += 1
                    return {"ok": 1.0, "n": n}
                if name == "update":
                    coll = srv.colls.setdefault((db, cmd["update"]), {})
                    n = mod = ups = 0
                    upserted = []
                    for u in cmd.get("updates", []):
                        q, repl = u.get("q", {}), u.get("u", {})
                        if any(k.startswith("$") for k in repl):
                            raise ValueError(
                                "minimongo: update operators not "
                                "supported (whole-doc replace only)")
                        hits = _select(coll, q)
                        if hits:
                            for d in hits if u.get("multi") else hits[:1]:
                                nd = dict(repl)
                                nd.setdefault("_id", d["_id"])
                                del coll[d["_id"]]
                                coll[nd["_id"]] = nd
                                n += 1
                                mod += 1
                        elif u.get("upsert"):
                            nd = dict(repl)
                            if "_id" not in nd:
                                nd["_id"] = q.get(
                                    "_id", f"auto{srv.next_id()}")
                            coll[nd["_id"]] = nd
                            n += 1
                            ups += 1
                            upserted.append(
                                {"index": len(upserted),
                                 "_id": nd["_id"]})
                    r = {"ok": 1.0, "n": n, "nModified": mod}
                    if upserted:
                        r["upserted"] = upserted
                    return r
                if name == "find":
                    coll = srv.colls.get((db, cmd["find"]), {})
                    out = _select(coll, cmd.get("filter", {}))
                    sort = cmd.get("sort")
                    if sort:
                        if list(sort) != ["_id"]:
                            raise ValueError(
                                "minimongo: sort on _id only")
                        out.sort(key=lambda d: d["_id"],
                                 reverse=int(sort["_id"]) < 0)
                    lim = int(cmd.get("limit", 0))
                    if lim:
                        out = out[:lim]
                    proj = cmd.get("projection")
                    if proj:
                        # real mongod also supports EXCLUSION
                        # projections; reject rather than silently
                        # answering like an empty inclusion (tests
                        # must not certify behavior mongod differs on)
                        if any(not v for k, v in proj.items()
                               if k != "_id"):
                            raise ValueError(
                                "minimongo: exclusion projections "
                                "not supported")
                        keep = {k for k, v in proj.items() if v}
                        keep.add("_id")
                        if proj.get("_id", 1) in (0, False):
                            keep.discard("_id")
                        out = [{k: d[k] for k in d if k in keep}
                               for d in out]
                    ns = f"{db}.{cmd['find']}"
                    # real mongod batches: firstBatch caps at 101 for
                    # an unlimited find, the rest rides getMore — so
                    # the client's cursor loop is actually exercised
                    batch = int(cmd.get("batchSize", 0)) or 101
                    first, rest = out[:batch], out[batch:]
                    cid = 0
                    if rest:
                        cid = srv.next_cursor()
                        srv.cursors[cid] = (ns, rest)
                    return {"ok": 1.0, "cursor": {
                        "id": cid, "ns": ns, "firstBatch": first}}
                if name == "getMore":
                    cid = cmd["getMore"]
                    ns, rest = srv.cursors.pop(
                        cid, (f"{db}.{cmd.get('collection', '')}", []))
                    batch = int(cmd.get("batchSize", 0)) or 101
                    nxt, rest = rest[:batch], rest[batch:]
                    new_id = 0
                    if rest:
                        new_id = srv.next_cursor()
                        srv.cursors[new_id] = (ns, rest)
                    return {"ok": 1.0, "cursor": {
                        "id": new_id, "ns": ns, "nextBatch": nxt}}
                if name == "delete":
                    coll = srv.colls.get((db, cmd["delete"]), {})
                    n = 0
                    for dl in cmd.get("deletes", []):
                        q = dl.get("q", {})
                        lim = int(dl.get("limit", 0))
                        hits = [d["_id"] for d in _select(coll, q)]
                        if lim:
                            hits = hits[:lim]
                        for _id in hits:
                            del coll[_id]
                            n += 1
                    return {"ok": 1.0, "n": n}
                if name == "drop":
                    srv.colls.pop((db, cmd["drop"]), None)
                    return {"ok": 1.0}
                if name == "listCollections":
                    names = sorted(c for d, c in srv.colls if d == db)
                    return {"ok": 1.0, "cursor": {
                        "id": 0, "ns": f"{db}.$cmd.listCollections",
                        "firstBatch": [
                            {"name": n, "type": "collection"}
                            for n in names]}}
                return {"ok": 0.0, "errmsg": f"no such command: "
                                             f"'{name}'", "code": 59}
            except ValueError as e:
                return {"ok": 0.0, "errmsg": str(e), "code": 2}


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class MiniMongo:
    """``srv = MiniMongo(); srv.start()`` -> ``srv.port`` / ``srv.addr``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        # (db, collection) -> {_id: document}
        self.colls: dict[tuple[str, str], dict] = {}
        self.lock = threading.Lock()
        self._ctr = 0
        # open multi-batch cursors: id -> (ns, remaining docs)
        self.cursors: dict[int, tuple[str, list]] = {}
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None

    def next_id(self) -> int:
        self._ctr += 1
        return self._ctr

    def next_cursor(self) -> int:
        self._ctr += 1
        return self._ctr

    def start(self) -> "MiniMongo":
        self._server = _Server((self.host, self.port), _Handler)
        self._server.owner = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="minimongo",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def __enter__(self) -> "MiniMongo":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
