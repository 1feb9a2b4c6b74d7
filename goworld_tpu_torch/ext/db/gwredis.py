"""Async redis wrapper for user game code.

The port's copy of ``goworld_tpu/ext/db/gwredis.py``.

Reference being rebuilt: ``ext/db/gwredis.go`` — a redigo connection owned
by one async group, exposing a generic command call whose reply is posted
back to the logic thread. Usage mirrors the reference::

    r = GWRedis("127.0.0.1:6379", workers)
    r.command(lambda reply, err: ..., "SET", "k", "v")
    r.get("k", lambda val, err: ...)

All ops serialize on the ``_gwredis`` worker group; callbacks run on the
logic thread via the world's post queue (the same contract as
:mod:`goworld_tpu_torch.kvdb`).
"""

from __future__ import annotations

from typing import Callable

from goworld_tpu_torch.ext.db.resp import RespClient
from goworld_tpu_torch.utils.asyncwork import AsyncWorkers

_GROUP = "_gwredis"  # dedicated worker group (reference gwredis.go)


class GWRedis:
    def __init__(self, addr: str, workers: AsyncWorkers):
        self._c = RespClient.from_addr(addr)
        self._workers = workers

    def command(self, cb: Callable | None, *args) -> None:
        """Generic command (reference's ``redis.Do`` pass-through)."""
        self._workers.submit(_GROUP, lambda: self._c.command(*args), cb)

    # convenience wrappers over the generic call
    def get(self, key, cb: Callable) -> None:
        self.command(cb, "GET", key)

    def set(self, key, val, cb: Callable | None = None) -> None:
        self.command(cb, "SET", key, val)

    def delete(self, key, cb: Callable | None = None) -> None:
        self.command(cb, "DEL", key)

    def close(self) -> None:
        self._c.close()
