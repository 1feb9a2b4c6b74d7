"""Async document-store wrapper for user game code.

The port's copy of ``goworld_tpu/ext/db/gwmongo.py``; documents are
MessagePack at the store seam by :mod:`goworld_tpu_torch.utils.mpack`,
byte for byte as the JAX package packs them.

Reference being rebuilt: ``ext/db/gwmongo.go:31-355`` — an mgo session
owned by one async group exposing ``InsertOne/FindOne/UpdateId/Count/...``
per (db, collection), every reply posted back to the logic thread.

The document API rides a pluggable :class:`DocStore`.
:class:`MongoDocStore` (``connect_mongodb``) is the reference shape:
native BSON documents per (db, collection) over the from-scratch
OP_MSG wire client (:mod:`goworld_tpu_torch.ext.db.mongowire`) — a real
mongod or the in-process :mod:`goworld_tpu_torch.ext.db.minimongo` both
speak it. :class:`RedisDocStore` (``connect_redis``) keeps MessagePack
documents in any redis-compatible endpoint under
``doc:<db>:<collection>:<id>`` keys. The ASYNC API — what user code
actually programs against — matches the reference's shape either way.
"""

from __future__ import annotations

from typing import Callable

from goworld_tpu_torch.ext.db.resp import RespClient
from goworld_tpu_torch.utils import ids, mpack
from goworld_tpu_torch.utils.asyncwork import AsyncWorkers

_GROUP = "_gwmongo"  # dedicated worker group (reference gwmongo.go:31)


def _unpack(raw: bytes):
    """``msgpack.unpackb(raw, raw=False)`` as the JAX package calls it
    (msgpack's default refuses map keys other than str and bytes)."""
    return mpack.unpackb(raw, strict_map_key=True)


class DocStore:
    """Minimal KV the document layer needs (swap for a real driver)."""

    def put(self, key: str, blob: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def query(self, db: str, col: str, flt: dict,
              limit: int = 0) -> "list[dict] | None":
        """OPTIONAL server-side filtered find. None = unsupported (the
        caller falls back to a keys()+get() scan); stores with a real
        query engine (MongoDocStore) answer in ONE round trip instead
        of 1 + N."""
        return None

    def close(self) -> None: ...


class RedisDocStore(DocStore):
    def __init__(self, addr: str):
        self._c = RespClient.from_addr(addr)

    def put(self, key, blob):
        self._c.set(key, blob)

    def get(self, key):
        return self._c.get(key)

    def delete(self, key):
        return bool(self._c.delete(key))

    def keys(self, prefix):
        return sorted(k.decode() for k in self._c.scan_keys(prefix + "*"))

    def close(self):
        self._c.close()


class MongoDocStore(DocStore):
    """The REAL thing: documents live as native BSON in their
    ``(db, collection)`` with ``_id``, via the from-scratch OP_MSG wire
    client — readable by any mongo tooling, no msgpack envelope. The
    DocStore key convention (``doc:<db>:<col>:<id>``) is parsed back
    into its parts; blobs are msgpack only at the interface seam (the
    GWMongo layer packs them) and are unpacked to store natively."""

    def __init__(self, addr: str):
        from goworld_tpu_torch.ext.db.mongowire import MongoClient

        self._c = MongoClient.from_addr(addr)

    @staticmethod
    def _parse(key: str) -> tuple[str, str, str]:
        _, db, col, doc_id = key.split(":", 3)
        return db, col, doc_id

    def _coll(self, db: str, col: str) -> str:
        # one client bound to one wire-level $db; namespace by prefixing
        # the db part into the collection when it differs
        return col if db == self._c.db else f"{db}.{col}"

    def put(self, key, blob):
        db, col, doc_id = self._parse(key)
        doc = _unpack(blob)
        self._c.upsert_id(self._coll(db, col), doc_id, doc)

    def get(self, key):
        db, col, doc_id = self._parse(key)
        doc = self._c.find_id(self._coll(db, col), doc_id)
        if doc is None:
            return None
        return mpack.packb(doc)

    def delete(self, key):
        db, col, doc_id = self._parse(key)
        return self._c.delete(self._coll(db, col), {"_id": doc_id}) > 0

    def keys(self, prefix):
        # prefix is always "doc:<db>:<col>:" (the GWMongo key scheme)
        db, col, _ = self._parse(prefix + "\x00")
        docs = self._c.find(self._coll(db, col), {},
                            projection={"_id": 1})
        return sorted(f"doc:{db}:{col}:{d['_id']}" for d in docs)

    def query(self, db, col, flt, limit=0):
        # server-side filter: one round trip instead of a 1 + N
        # key-scan (the flat-equality filters GWMongo supports are
        # valid mongo filters verbatim)
        return self._c.find(self._coll(db, col), flt, limit=limit)

    def close(self):
        self._c.close()


def _matches(doc: dict, query: dict) -> bool:
    """Flat equality filter (the subset the reference's examples use)."""
    return all(doc.get(k) == v for k, v in query.items())


class GWMongo:
    """``m = GWMongo(store, workers)``; all callbacks get ``(res, err)``
    on the logic thread."""

    def __init__(self, store: DocStore, workers: AsyncWorkers):
        self._store = store
        self._workers = workers

    @classmethod
    def connect_redis(cls, addr: str, workers: AsyncWorkers) -> "GWMongo":
        return cls(RedisDocStore(addr), workers)

    @classmethod
    def connect_mongodb(cls, addr: str,
                        workers: AsyncWorkers) -> "GWMongo":
        """The reference shape: a real MongoDB endpoint (or the
        in-process minimongo) over the from-scratch wire client."""
        return cls(MongoDocStore(addr), workers)

    @staticmethod
    def _key(db: str, col: str, doc_id: str) -> str:
        return f"doc:{db}:{col}:{doc_id}"

    def _submit(self, job: Callable, cb: Callable | None) -> None:
        self._workers.submit(_GROUP, job, cb)

    # -- document ops (reference gwmongo.go Insert/Find/Update/Remove) ---
    def insert_one(self, db: str, col: str, doc: dict,
                   cb: Callable | None = None) -> str:
        """Returns the document id immediately; the write lands async."""
        doc_id = str(doc.get("_id") or ids.gen_entity_id())
        doc = dict(doc, _id=doc_id)

        def job():
            self._store.put(
                self._key(db, col, doc_id),
                mpack.packb(doc),
            )
            return doc_id

        self._submit(job, cb)
        return doc_id

    def find_id(self, db: str, col: str, doc_id: str,
                cb: Callable) -> None:
        def job():
            raw = self._store.get(self._key(db, col, doc_id))
            return None if raw is None else _unpack(raw)

        self._submit(job, cb)

    def find_one(self, db: str, col: str, query: dict,
                 cb: Callable) -> None:
        def job():
            native = self._store.query(db, col, query, limit=1)
            if native is not None:
                return native[0] if native else None
            for key in self._store.keys(f"doc:{db}:{col}:"):
                raw = self._store.get(key)
                if raw is None:
                    continue
                doc = _unpack(raw)
                if _matches(doc, query):
                    return doc
            return None

        self._submit(job, cb)

    def find_all(self, db: str, col: str, query: dict,
                 cb: Callable) -> None:
        def job():
            native = self._store.query(db, col, query)
            if native is not None:
                return native
            out = []
            for key in self._store.keys(f"doc:{db}:{col}:"):
                raw = self._store.get(key)
                if raw is None:
                    continue
                doc = _unpack(raw)
                if _matches(doc, query):
                    out.append(doc)
            return out

        self._submit(job, cb)

    def update_id(self, db: str, col: str, doc_id: str, fields: dict,
                  cb: Callable | None = None) -> None:
        """Merge ``fields`` into the document (reference ``UpdateId`` with
        a ``$set`` document)."""

        def job():
            key = self._key(db, col, doc_id)
            raw = self._store.get(key)
            doc = {} if raw is None else _unpack(raw)
            doc.update(fields)
            doc["_id"] = doc_id
            self._store.put(key, mpack.packb(doc))

        self._submit(job, cb)

    def remove_id(self, db: str, col: str, doc_id: str,
                  cb: Callable | None = None) -> None:
        self._submit(
            lambda: self._store.delete(self._key(db, col, doc_id)), cb
        )

    def count(self, db: str, col: str, cb: Callable) -> None:
        self._submit(
            lambda: len(self._store.keys(f"doc:{db}:{col}:")), cb
        )

    def close(self) -> None:
        self._store.close()
