"""Global async key-value store (account->avatar maps, mail ids, ...).

Reference being rebuilt: ``engine/kvdb`` (``kvdb.go:42-200``): a cluster-
global KV store with pluggable backends, all ops running on a dedicated
async group (``_kvdb``) with callbacks posted to the logic thread:
``Get/Put/GetOrPut/GetRange/NextLargerKey``. Backends here (matching the
reference's backend iface, ``kvdb/types/kvdb_types.go``): ``memory`` and
``filesystem`` (a single MessagePack file with ordered keys, written by
:mod:`goworld_tpu_torch.utils.mpack` byte for byte as the JAX package
writes it). The JAX package's ``redis``, ``redis_cluster`` and
``mongodb`` backends ride its ``ext/db`` clients, which the port does not
have yet: they raise ``NotImplementedError`` naming ROADMAP.md. Transient
backend errors are retried with capped exponential backoff before the
error reaches the caller's callback (``kvdb_retry_total`` counts
retries).
"""

from __future__ import annotations

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


def open_kvdb_backend(kind: str, location: str = "") -> KVDBBackend:
    if kind == "memory":
        return MemoryKVDB()
    if kind == "filesystem":
        return FilesystemKVDB(location or "kvdb_data.mp")
    if kind in ("redis", "redis_cluster", "redis-cluster", "mongodb"):
        raise NotImplementedError(
            f"kvdb kind {kind!r}: the ext/db clients are not ported yet; "
            "see ROADMAP.md Queue A")
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
