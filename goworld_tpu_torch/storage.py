"""Async entity persistence with pluggable backends.

Reference being rebuilt: ``engine/storage`` (``storage.go``): a background
worker consumes a queue of save/load/exists/list requests against an
``EntityStorage`` backend (``storage_common.go:5-13``); saves retry forever
(entity data must not be lost), callbacks are posted back to the logic
thread, and a queue-length monitor warns on backlog (``:102-110``).

Backends here: ``mongodb`` (the reference's primary backend,
``backend/mongodb/mongodb.go:27-136``: one collection per entity type
with ``_id`` = EntityID and the attrs under ``data``, over the BSON +
OP_MSG client :mod:`goworld_tpu_torch.ext.db.mongowire`; a real mongod or
the in-process :mod:`goworld_tpu_torch.ext.db.minimongo`), ``redis``
(RESP; key scheme ``gw:<type>:<eid>``), ``filesystem`` (one directory per
entity type, one MessagePack file per entity) and ``memory`` (tests).
Every MessagePack blob is written by :mod:`goworld_tpu_torch.utils.mpack`
byte for byte as the JAX package writes it, so either package reads the
other's store.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from goworld_tpu_torch.utils import consts, faults, log, metrics, mpack, \
    opmon, overload

logger = log.get("storage")

SAVE_RETRY_DELAY = 1.0    # backoff base: saves retry FOREVER (entity
SAVE_RETRY_MAX = 30.0     # data must not be lost), but with capped
                          # exponential backoff so a dead backend is not
                          # hammered once per second for hours
READ_RETRY_ATTEMPTS = 3   # loads/exists/lists retry transient errors a
READ_RETRY_DELAY = 0.05   # bounded number of times before reporting None
WARN_QUEUE_LEN = 100  # reference storage.go:102-110
_TRANSIENT = (ConnectionError, TimeoutError, OSError)


class EntityStorageBackend:
    """Backend interface (reference ``EntityStorage``)."""

    def write(self, type_name: str, eid: str, data: dict) -> None:
        raise NotImplementedError

    def read(self, type_name: str, eid: str) -> dict | None:
        raise NotImplementedError

    def exists(self, type_name: str, eid: str) -> bool:
        raise NotImplementedError

    def list_entity_ids(self, type_name: str) -> list[str]:
        raise NotImplementedError

    def close(self) -> None: ...


class MemoryStorage(EntityStorageBackend):
    def __init__(self):
        self._data: dict[tuple[str, str], dict] = {}

    def write(self, type_name, eid, data):
        self._data[(type_name, eid)] = data

    def read(self, type_name, eid):
        return self._data.get((type_name, eid))

    def exists(self, type_name, eid):
        return (type_name, eid) in self._data

    def list_entity_ids(self, type_name):
        return [e for t, e in self._data if t == type_name]


class FilesystemStorage(EntityStorageBackend):
    """``<root>/<type>/<eid>.mp`` — atomic replace via temp file."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, type_name: str, eid: str) -> str:
        return os.path.join(self.root, type_name, f"{eid}.mp")

    def write(self, type_name, eid, data):
        d = os.path.join(self.root, type_name)
        os.makedirs(d, exist_ok=True)
        path = self._path(type_name, eid)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(mpack.packb(data))
        os.replace(tmp, path)

    def read(self, type_name, eid):
        try:
            with open(self._path(type_name, eid), "rb") as f:
                return mpack.unpackb(f.read(), strict_map_key=True)
        except FileNotFoundError:
            return None

    def exists(self, type_name, eid):
        return os.path.exists(self._path(type_name, eid))

    def list_entity_ids(self, type_name):
        d = os.path.join(self.root, type_name)
        if not os.path.isdir(d):
            return []
        return [f[:-3] for f in os.listdir(d) if f.endswith(".mp")]


class RedisStorage(EntityStorageBackend):
    """Networked backend over the RESP wire protocol (reference persists
    to MongoDB, one collection per type with ``_id`` = EntityID,
    ``backend/mongodb/mongodb.go:27-136``; the key scheme here is the
    redis equivalent: ``gw:<type>:<eid>`` -> msgpack attr blob). Works
    against any redis-compatible endpoint, including the in-process
    :mod:`goworld_tpu_torch.ext.db.miniredis`."""

    PREFIX = "gw"

    def __init__(self, addr: str):
        from goworld_tpu_torch.ext.db.resp import RespClient

        self._c = RespClient.from_addr(addr)

    def _key(self, type_name: str, eid: str) -> str:
        return f"{self.PREFIX}:{type_name}:{eid}"

    def write(self, type_name, eid, data):
        self._c.set(self._key(type_name, eid),
                    mpack.packb(data))

    def read(self, type_name, eid):
        raw = self._c.get(self._key(type_name, eid))
        return None if raw is None else mpack.unpackb(
            raw, strict_map_key=True)

    def exists(self, type_name, eid):
        return self._c.exists(self._key(type_name, eid))

    def list_entity_ids(self, type_name):
        pre = f"{self.PREFIX}:{type_name}:"
        return sorted(
            k.decode()[len(pre):]
            for k in self._c.scan_keys(pre + "*")
        )

    def close(self):
        self._c.close()


class MongoDBStorage(EntityStorageBackend):
    """The reference's primary backend
    (``backend/mongodb/mongodb.go:27-136``), byte-compatible layout:
    one collection per entity type, ``_id`` = EntityID, attrs under
    ``data`` (``col.UpsertId(entityID, bson.M{"data": data})``). Rides
    the from-scratch BSON/OP_MSG client
    (:mod:`goworld_tpu_torch.ext.db.mongowire`) — no driver needed; any
    mongod or the in-process minimongo speaks the wire."""

    def __init__(self, addr: str):
        from goworld_tpu_torch.ext.db.mongowire import MongoClient

        self._c = MongoClient.from_addr(addr)

    def write(self, type_name, eid, data):
        self._c.upsert_id(type_name, eid, {"data": data})

    def read(self, type_name, eid):
        doc = self._c.find_id(type_name, eid)
        return None if doc is None else doc.get("data")

    def exists(self, type_name, eid):
        return bool(self._c.find(type_name, {"_id": eid},
                                 projection={"_id": 1}, limit=1))

    def list_entity_ids(self, type_name):
        return sorted(
            d["_id"] for d in self._c.find(
                type_name, {}, projection={"_id": 1})
        )

    def close(self):
        self._c.close()


def open_backend(kind: str, location: str = "") -> EntityStorageBackend:
    if kind == "memory":
        return MemoryStorage()
    if kind == "filesystem":
        return FilesystemStorage(location or "entity_storage")
    if kind == "redis":
        return RedisStorage(location or "127.0.0.1:6379")
    if kind == "mongodb":
        return MongoDBStorage(location or "127.0.0.1:27017/goworld")
    raise ValueError(f"unknown storage backend {kind!r}")


class Storage:
    """The async storage front-end attached to a World
    (``world.storage = Storage(backend, world.post_q.post)``)."""

    def __init__(self, backend: EntityStorageBackend,
                 post: Callable[[Callable], None]):
        self.backend = backend
        self._post = post
        self._q: list[tuple] = []
        self._cv = threading.Condition()
        self._closed = False
        self.op_count = 0
        # /metrics shim beside the opmon rows: latency histogram per op
        # kind + a queue-depth gauge a scraper can alarm on
        self._hists = {
            op: metrics.histogram("storage_op_ms", op=op,
                                  help="storage backend op latency")
            for op in ("save", "load", "exists", "list")
        }
        self._m_queue = metrics.gauge(
            "storage_queue_depth", help="pending storage ops")
        self._m_retry = metrics.counter(
            "storage_retry_total",
            help="storage ops retried after a backend error")
        self._m_err = metrics.counter(
            "storage_op_errors_total",
            help="non-save storage ops that exhausted retries")
        # circuit breaker around the backend: reads fail FAST while
        # open (a dead backend must not stack 3-attempt retry sleeps
        # per op); saves never give up — they wait out the open window
        # and ride the half-open probe when it comes
        self.breaker = overload.register_breaker(overload.CircuitBreaker(
            "storage",
            failure_threshold=consts.CIRCUIT_FAILURE_THRESHOLD,
            reset_timeout=consts.CIRCUIT_RESET_TIMEOUT,
        ))
        self._m_circuit_rejected = metrics.counter(
            "storage_circuit_rejected_total",
            help="storage ops failed fast while the circuit was open")
        self._thread = threading.Thread(
            target=self._run, name="storage", daemon=True
        )
        self._thread.start()

    # -- public API (reference storage.go:60-100) -----------------------
    def save(self, type_name: str, eid: str, data: dict,
             cb: Callable[[], None] | None = None) -> None:
        self._enqueue(("save", type_name, eid, data, cb))

    def load(self, type_name: str, eid: str,
             cb: Callable[[dict | None], None]) -> None:
        self._enqueue(("load", type_name, eid, None, cb))

    def exists(self, type_name: str, eid: str,
               cb: Callable[[bool], None]) -> None:
        self._enqueue(("exists", type_name, eid, None, cb))

    def list_entity_ids(self, type_name: str,
                        cb: Callable[[list[str]], None]) -> None:
        self._enqueue(("list", type_name, "", None, cb))

    def queue_len(self) -> int:
        with self._cv:
            return len(self._q)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain then stop (reference ``Shutdown`` waits for queue empty).
        Idempotent: freeze and process teardown may both call it."""
        with self._cv:
            if self._closed:
                return
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q and time.monotonic() < deadline:
                self._cv.wait(0.1)
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        self.backend.close()

    # -- worker ----------------------------------------------------------
    def _enqueue(self, op: tuple) -> None:
        with self._cv:
            if self._closed:
                logger.error("storage closed; dropping %s", op[0])
                return
            self._q.append(op)
            self._m_queue.set(len(self._q))
            if len(self._q) > WARN_QUEUE_LEN:
                logger.warning("storage queue backlog: %d", len(self._q))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q and self._closed:
                    return
                op = self._q.pop(0)
                self._cv.notify_all()
            self._execute(op)

    def _execute(self, op: tuple) -> None:
        kind, type_name, eid, data, cb = op
        attempt = 0
        t0 = time.perf_counter()
        while True:
            if not self.breaker.allow():
                self._m_circuit_rejected.inc()
                if kind == "save":
                    # saves never give up: wait out the open window,
                    # then the half-open probe (one real attempt)
                    # decides whether the backend is back
                    time.sleep(min(self.breaker.reset_timeout,
                                   SAVE_RETRY_MAX))
                    continue
                logger.error(
                    "storage %s %s.%s rejected fast (circuit open)",
                    kind, type_name, eid,
                )
                res = None
                break
            # per-ATTEMPT timing (like the kvdb shim): folding the
            # retry backoff sleeps into storage_op_ms would report
            # injected wait, not backend latency
            t0 = time.perf_counter()
            try:
                faults.maybe_op_fault("storage", kind)
                if kind == "save":
                    self.backend.write(type_name, eid, data)
                    res: Any = None
                elif kind == "load":
                    res = self.backend.read(type_name, eid)
                elif kind == "exists":
                    res = self.backend.exists(type_name, eid)
                else:
                    res = self.backend.list_entity_ids(type_name)
                self.breaker.record_success()
                break
            except Exception as exc:
                self.breaker.record_failure()
                attempt += 1
                if kind == "save":
                    # saves retry forever: losing entity data is worse
                    # than blocking the queue (reference storageRoutine)
                    # — but back off exponentially (capped) so a dead
                    # backend isn't hammered at a fixed cadence
                    self._m_retry.inc()
                    delay = min(SAVE_RETRY_MAX,
                                SAVE_RETRY_DELAY * 2 ** (attempt - 1))
                    logger.exception(
                        "save %s.%s failed (attempt %d); retrying in "
                        "%.1fs", type_name, eid, attempt, delay,
                    )
                    time.sleep(delay)
                    continue
                # reads: a TRANSIENT blip gets a bounded number of
                # quick retries before the op reports failure — a load
                # that fails on one dropped TCP segment would otherwise
                # boot the player with a fresh entity
                if isinstance(exc, _TRANSIENT) \
                        and attempt < READ_RETRY_ATTEMPTS:
                    self._m_retry.inc()
                    logger.warning(
                        "storage %s %s.%s transient error (%s); "
                        "retry %d", kind, type_name, eid, exc, attempt,
                    )
                    time.sleep(READ_RETRY_DELAY * 2 ** (attempt - 1))
                    continue
                self._m_err.inc()
                logger.exception("storage %s %s.%s failed",
                                 kind, type_name, eid)
                res = None
                break
        self.op_count += 1
        dt = time.perf_counter() - t0
        opmon.monitor.record(f"storage.{kind}", dt)
        self._hists[kind].observe(dt * 1e3)
        self._m_queue.set(self.queue_len())
        if cb is not None:
            if kind == "save":
                self._post(cb)
            else:
                self._post(lambda cb=cb, res=res: cb(res))
