"""Global async key-value store (account->avatar maps, mail ids, ...).

Reference being rebuilt: ``engine/kvdb`` (``kvdb.go:42-200``): a cluster-
global KV store with pluggable backends, all ops running on a dedicated
async group (``_kvdb``) with callbacks posted to the logic thread:
``Get/Put/GetOrPut/GetRange/NextLargerKey``. Backends here (matching the
reference's backend iface, ``kvdb/types/kvdb_types.go``): ``memory``,
``filesystem`` (a single MessagePack file with ordered keys, written by
:mod:`goworld_tpu_torch.utils.mpack` byte for byte as the JAX package
writes it), ``redis`` (RESP, reference ``kvdb/backend/kvdbredis``),
``redis_cluster`` (slot map + MOVED/ASK redirects, the
``kvdbrediscluster`` role) and ``mongodb`` (BSON/OP_MSG, the
``kvdb_mongodb`` layout), over the port's wire clients in
:mod:`goworld_tpu_torch.ext.db`, the keys and values as the JAX
package's backends store them. Transient
backend errors are retried with capped exponential backoff before the
error reaches the caller's callback (``kvdb_retry_total`` counts
retries).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Callable

from goworld_tpu_torch.utils import consts, faults, log, metrics, mpack, \
    opmon, overload
from goworld_tpu_torch.utils.asyncwork import AsyncWorkers

logger = log.get("kvdb")

_GROUP = "_kvdb"  # dedicated worker group (reference kvdb.go:42)

# transient-error retry policy for backend ops: bounded attempts under a
# wall-clock budget with exponential backoff — a blip on the redis/mongo
# link must not surface as an op error, but a dead backend must fail the
# callback instead of wedging the single _kvdb worker forever
RETRY_ATTEMPTS = 3
RETRY_BASE_DELAY = 0.05
RETRY_DEADLINE = 5.0
_TRANSIENT = (ConnectionError, TimeoutError, OSError)


class KVDBBackend:
    def get(self, key: str) -> str | None:
        raise NotImplementedError

    def put(self, key: str, val: str) -> None:
        raise NotImplementedError

    def get_range(self, begin: str, end: str) -> list[tuple[str, str]]:
        """Items with begin <= key < end, ascending."""
        raise NotImplementedError

    def close(self) -> None: ...


class MemoryKVDB(KVDBBackend):
    def __init__(self):
        self._d: dict[str, str] = {}

    def get(self, key):
        return self._d.get(key)

    def put(self, key, val):
        self._d[key] = val

    def get_range(self, begin, end):
        keys = sorted(k for k in self._d if begin <= k < end)
        return [(k, self._d[k]) for k in keys]


class FilesystemKVDB(KVDBBackend):
    """Append-friendly single-file store; full rewrite on flush (small
    cluster metadata workloads, not bulk data)."""

    def __init__(self, path: str):
        self.path = path
        self._d: dict[str, str] = {}
        self._lock = threading.Lock()
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            if raw:
                self._d = mpack.unpackb(raw, strict_map_key=True)

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(mpack.packb(self._d))
        os.replace(tmp, self.path)

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def put(self, key, val):
        with self._lock:
            self._d[key] = val
            self._flush()

    def get_range(self, begin, end):
        with self._lock:
            keys = sorted(k for k in self._d if begin <= k < end)
            return [(k, self._d[k]) for k in keys]


class RedisKVDB(KVDBBackend):
    """Networked backend over RESP (reference ``kvdb/backend/kvdbredis``;
    keys are namespaced ``kv:<key>`` so one redis db can host both the
    kvdb and entity storage). Range queries sweep SCAN and filter/sort
    client-side — the same shape the reference's redis backend uses
    (redis has no ordered keyspace)."""

    PREFIX = "kv:"

    def __init__(self, addr: str):
        from goworld_tpu_torch.ext.db.resp import RespClient

        self._c = RespClient.from_addr(addr)

    def get(self, key):
        raw = self._c.get(self.PREFIX + key)
        return None if raw is None else raw.decode()

    def put(self, key, val):
        self._c.set(self.PREFIX + key, val)

    def get_range(self, begin, end):
        return _range_on(self._c, begin, end)

    def close(self):
        self._c.close()


def _range_on(client, begin: str, end: str) -> list[tuple[str, str]]:
    """SCAN-sweep one redis endpoint and return the [begin, end) window,
    values fetched in a single MGET round-trip."""
    pre = RedisKVDB.PREFIX
    keys = sorted(
        k.decode()[len(pre):] for k in client.scan_keys(pre + "*")
    )
    lo = bisect.bisect_left(keys, begin)
    hi = bisect.bisect_left(keys, end)
    sel = keys[lo:hi]
    vals = client.mget([pre + k for k in sel])
    return [(k, v.decode()) for k, v in zip(sel, vals) if v is not None]


class RedisClusterKVDB(KVDBBackend):
    """Redis CLUSTER-MODE client (the reference's
    ``kvdb/backend/kvdbrediscluster`` role: horizontal kvdb capacity),
    from scratch over the RESP client:

    * On connect it asks any reachable node ``CLUSTER SLOTS`` and
      builds the 16384-entry slot map; keys route by
      ``CRC16(key) % 16384`` with ``{hashtag}`` semantics — hashing
      the FULL key as sent (prefix included), so routing agrees with
      the server's own hash.
    * ``-MOVED slot host:port`` repairs the slot map and retries at
      the new owner (new nodes are dialed on demand, so the client
      follows resharding it was never told about); ``-ASK`` sends
      ``ASKING`` then retries once at the target WITHOUT a map update,
      per the migration protocol. Redirect chains are bounded.
    * Nodes that have cluster support disabled (plain redis/miniredis)
      fall back to LEGACY client-side sharding:
      ``CRC16 % len(nodes)`` over the configured endpoints — the
      pre-round-5 behavior, kept so independent-node deployments work
      unchanged.

    Range queries fan out to every known node and merge (same
    architecture as the reference's scan-across-shards)."""

    _MAX_REDIRECTS = 5

    def __init__(self, addrs: list[str]):
        from goworld_tpu_torch.ext.db import resp

        if not addrs:
            raise ValueError("redis-cluster needs at least one node")
        self._resp = resp
        self._clients: dict[str, resp.RespClient] = {
            a: resp.RespClient.from_addr(a) for a in addrs
        }
        self._seed_addrs = list(addrs)
        # slot -> addr; None = legacy (cluster support disabled)
        self._slot_map: list[str] | None = None
        self._refresh_slot_map()

    # -- topology ------------------------------------------------------
    def _refresh_slot_map(self) -> None:
        from goworld_tpu_torch.ext.db.resp import NUM_SLOTS, RespError

        transient: Exception | None = None
        for addr in list(self._clients):
            try:
                entries = self._clients[addr].command(
                    b"CLUSTER", b"SLOTS")
            except RespError as e:
                msg = str(e).lower()
                if "cluster support disabled" in msg \
                        or "unknown command" in msg:
                    # definitively a NON-cluster node -> legacy
                    # client-side sharding over the seed endpoints
                    self._slot_map = None
                    return
                # transient (-LOADING, permissions, ...): a cluster
                # node that cannot answer RIGHT NOW must not silently
                # demote the client to legacy routing — try the next
                # node, fail loud if none answers
                transient = e
                continue
            except ConnectionError as e:
                transient = e
                continue
            m: list[str | None] = [None] * NUM_SLOTS
            for lo, hi, node, *_ in entries:
                host = node[0].decode()
                naddr = f"{host}:{int(node[1])}"
                for s in range(int(lo), int(hi) + 1):
                    m[s] = naddr
            # unassigned slots route to the seed we asked (they will
            # MOVED-correct themselves)
            self._slot_map = [s or addr for s in m]
            return
        raise ConnectionError(
            f"no redis-cluster node could serve CLUSTER SLOTS "
            f"(last error: {transient})"
        )

    def _client_for(self, addr: str):
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = self._resp.RespClient.from_addr(addr)
        return c

    def _route(self, full_key: bytes, bare_key: bytes):
        from goworld_tpu_torch.ext.db.resp import crc16, key_slot

        if self._slot_map is None:
            # legacy mode hashes the BARE key, exactly like the
            # pre-cluster-protocol client — an existing independent-
            # node deployment keeps finding its data on the same nodes
            nodes = [self._clients[a] for a in self._seed_addrs]
            return nodes[crc16(bare_key) % len(nodes)]
        return self._client_for(self._slot_map[key_slot(full_key)])

    def _command(self, full_key: bytes, bare_key: bytes, *args):
        """Run one keyed command with MOVED/ASK redirect handling."""
        from goworld_tpu_torch.ext.db.resp import RespError, key_slot

        client = self._route(full_key, bare_key)
        asking = False
        for _ in range(self._MAX_REDIRECTS):
            try:
                if asking:
                    client.command(b"ASKING")
                    asking = False
                return client.command(*args)
            except RespError as e:
                words = str(e).split()
                if len(words) == 3 and words[0] in ("MOVED", "ASK"):
                    slot, addr = int(words[1]), words[2]
                    client = self._client_for(addr)
                    if words[0] == "MOVED" and self._slot_map is not None:
                        self._slot_map[slot] = addr
                    asking = words[0] == "ASK"
                    continue
                raise
        raise ConnectionError(
            f"redis-cluster redirect chain exceeded "
            f"{self._MAX_REDIRECTS} for slot {key_slot(full_key)}"
        )

    # -- KVDB backend --------------------------------------------------
    def get(self, key):
        bk = key.encode()
        fk = RedisKVDB.PREFIX.encode() + bk
        raw = self._command(fk, bk, b"GET", fk)
        return None if raw is None else raw.decode()

    def put(self, key, val):
        bk = key.encode()
        fk = RedisKVDB.PREFIX.encode() + bk
        self._command(fk, bk, b"SET", fk,
                      val.encode() if isinstance(val, str) else val)

    def get_range(self, begin, end):
        from goworld_tpu_torch.ext.db.resp import key_slot

        out: list[tuple[str, str]] = []
        if self._slot_map is None:
            for addr in self._seed_addrs:
                out.extend(_range_on(self._clients[addr], begin, end))
            out.sort()
            return out
        # cluster mode: SCAN is node-local (allowed), but MGET must be
        # SAME-SLOT only (real cluster redis rejects cross-slot MGET
        # with -CROSSSLOT) — group each node's matches by slot and
        # fetch per group through the redirect-capable path, so a
        # group mid-migration follows its MOVED/ASK. Merge through a
        # dict keyed by k: during a live slot migration the source and
        # target node can BOTH report the same key, and the reader must
        # not see it twice
        pre = RedisKVDB.PREFIX
        lo_b, hi_b = begin.encode(), end.encode()
        merged: dict[str, str] = {}
        for addr in sorted(set(self._slot_map)):
            node = self._client_for(addr)
            keys = [k[len(pre):] for k in node.scan_keys(pre + "*")]
            sel = sorted(k for k in keys if lo_b <= k < hi_b)
            groups: dict[int, list[bytes]] = {}
            for k in sel:
                fk = pre.encode() + k
                groups.setdefault(key_slot(fk), []).append(k)
            for ks in groups.values():
                fks = [pre.encode() + k for k in ks]
                vals = self._command(fks[0], ks[0], b"MGET", *fks)
                merged.update(
                    (k.decode(), v.decode())
                    for k, v in zip(ks, vals) if v is not None
                )
        return sorted(merged.items())

    def close(self):
        for c in self._clients.values():
            c.close()


class MongoKVDB(KVDBBackend):
    """The reference's mongo kvdb engine
    (``kvdb/backend/kvdb_mongodb/mongodb.go``), same document layout:
    one collection, ``_id`` = key, value under ``"_"`` (its
    ``_VAL_KEY``); Put = UpsertId, Get = FindId, Find = range query
    ``{"_id": {"$gte": begin, "$lt": end}}``. Collection ``__kv__``
    (the name the reference's own backend test uses). Rides the
    from-scratch BSON/OP_MSG wire client — works against a real
    mongod or the in-process minimongo."""

    COLLECTION = "__kv__"

    def __init__(self, addr: str):
        from goworld_tpu_torch.ext.db.mongowire import MongoClient

        self._c = MongoClient.from_addr(addr)

    def get(self, key):
        doc = self._c.find_id(self.COLLECTION, key)
        return None if doc is None else doc.get("_")

    def put(self, key, val):
        self._c.upsert_id(self.COLLECTION, key, {"_": val})

    def get_range(self, begin, end):
        docs = self._c.find(
            self.COLLECTION, {"_id": {"$gte": begin, "$lt": end}},
            sort={"_id": 1},
        )
        return [(d["_id"], d["_"]) for d in docs]

    def close(self):
        self._c.close()


def open_kvdb_backend(kind: str, location: str = "") -> KVDBBackend:
    if kind == "memory":
        return MemoryKVDB()
    if kind == "filesystem":
        return FilesystemKVDB(location or "kvdb_data.mp")
    if kind == "redis":
        return RedisKVDB(location or "127.0.0.1:6379")
    if kind in ("redis_cluster", "redis-cluster"):
        return RedisClusterKVDB(
            [a.strip() for a in location.split(",") if a.strip()]
        )
    if kind == "mongodb":
        return MongoKVDB(location or "127.0.0.1:27017/goworld")
    raise ValueError(f"unknown kvdb backend {kind!r}")


def next_larger_key(key: str) -> str:
    """The smallest key strictly greater than every key prefixed by
    ``key`` is not needed — the reference's ``NextLargerKey`` returns
    ``key + "\\x00"``, the immediate successor (``kvdb.go:196-200``)."""
    return key + "\x00"


class KVDB:
    """Async facade (``world.kvdb = KVDB(backend, workers)``); callbacks
    run on the logic thread via the worlds's post queue. Every op runs
    through a timing shim that feeds both the metrics registry
    (``kvdb_op_ms{op=...}`` histogram on ``/metrics``) and the existing
    :data:`opmon.monitor` table (``kvdb.<op>`` rows on ``/ops``)."""

    def __init__(self, backend: KVDBBackend, workers: AsyncWorkers):
        self.backend = backend
        self.workers = workers
        self._hists = {
            op: metrics.histogram("kvdb_op_ms", op=op,
                                  help="kvdb backend op latency")
            for op in ("get", "put", "get_or_put", "get_range")
        }
        self._m_retry = {
            op: metrics.counter("kvdb_retry_total", op=op,
                                help="kvdb ops retried after a "
                                     "transient backend error")
            for op in ("get", "put", "get_or_put", "get_range")
        }
        self._m_err = metrics.counter(
            "kvdb_op_errors_total",
            help="kvdb ops that exhausted retries")
        # circuit breaker around the backend (docs/ROBUSTNESS.md
        # "Overload & degradation"): after the failure budget the
        # breaker opens and every op fails FAST through the callback —
        # a dead backend degrades kvdb service instead of stacking
        # retry sleeps on the single _kvdb worker; a half-open probe
        # per reset window closes it again when the backend recovers
        self.breaker = overload.register_breaker(overload.CircuitBreaker(
            "kvdb",
            failure_threshold=consts.CIRCUIT_FAILURE_THRESHOLD,
            reset_timeout=consts.CIRCUIT_RESET_TIMEOUT,
        ))
        self._m_circuit_rejected = metrics.counter(
            "kvdb_circuit_rejected_total",
            help="kvdb ops failed fast while the circuit was open")

    def _timed(self, op: str, fn: Callable):
        """Timing + bounded-retry shim around one backend op. Transient
        errors (ConnectionError/TimeoutError/OSError — including
        injected ``err:kvdb.*`` faults) retry with exponential backoff
        until RETRY_ATTEMPTS or the RETRY_DEADLINE budget runs out, then
        surface through the callback like any other op error."""
        hist = self._hists[op]
        retry = self._m_retry[op]

        def job():
            if not self.breaker.allow():
                # open circuit: fail fast WITHOUT touching the backend
                # or burning retry sleeps on the single _kvdb worker
                self._m_circuit_rejected.inc()
                raise overload.CircuitOpenError(
                    f"kvdb circuit open; {op} rejected fast"
                )
            deadline = time.perf_counter() + RETRY_DEADLINE
            # the histogram records PER-ATTEMPT backend latency (the
            # last attempt's, success or final failure) — folding the
            # backoff sleeps in would make kvdb_op_ms report injected
            # wait, not backend behavior
            t0 = time.perf_counter()
            try:
                for attempt in range(RETRY_ATTEMPTS):
                    t0 = time.perf_counter()
                    try:
                        faults.maybe_op_fault("kvdb", op)
                        res = fn()
                        self.breaker.record_success()
                        return res
                    except _TRANSIENT as exc:
                        self.breaker.record_failure()
                        delay = RETRY_BASE_DELAY * (2 ** attempt)
                        if attempt + 1 >= RETRY_ATTEMPTS \
                                or time.perf_counter() + delay > deadline \
                                or self.breaker.state \
                                == overload.CircuitBreaker.OPEN:
                            self._m_err.inc()
                            logger.error(
                                "kvdb %s failed after %d attempts: %s",
                                op, attempt + 1, exc,
                            )
                            raise
                        retry.inc()
                        logger.warning("kvdb %s transient error (%s); "
                                       "retry %d", op, exc, attempt + 1)
                        time.sleep(delay)
                    except Exception:
                        # NON-transient failure (protocol garbage, a
                        # bug): still settle the breaker's half-open
                        # probe — leaving it unrecorded would pin the
                        # breaker HALF_OPEN with its one probe slot
                        # consumed, failing every later op forever
                        self.breaker.record_failure()
                        raise
            finally:
                dt = time.perf_counter() - t0
                hist.observe(dt * 1e3)
                opmon.monitor.record(f"kvdb.{op}", dt)

        return job

    def get(self, key: str,
            cb: Callable[[str | None, Exception | None], None]) -> None:
        self.workers.submit(
            _GROUP, self._timed("get", lambda: self.backend.get(key)), cb
        )

    def put(self, key: str, val: str,
            cb: Callable[[None, Exception | None], None] | None = None,
            ) -> None:
        self.workers.submit(
            _GROUP,
            self._timed("put", lambda: self.backend.put(key, val)), cb,
        )

    def get_or_put(self, key: str, val: str,
                   cb: Callable[[str | None, Exception | None], None],
                   ) -> None:
        """Atomic read-else-write (reference ``GetOrPut``): returns the
        existing value (put skipped) or None (val written). Atomicity holds
        because all kvdb ops serialize on the single ``_kvdb`` worker."""

        def job():
            old = self.backend.get(key)
            if old is None:
                self.backend.put(key, val)
            return old

        self.workers.submit(_GROUP, self._timed("get_or_put", job), cb)

    def get_range(self, begin: str, end: str,
                  cb: Callable[[list, Exception | None], None]) -> None:
        self.workers.submit(
            _GROUP,
            self._timed("get_range",
                        lambda: self.backend.get_range(begin, end)), cb,
        )
