"""Named async worker groups — blocking work off the logic thread.

Reference being rebuilt: ``engine/async`` (``async.go:39-109``): named
groups, each one goroutine + a 10K-slot channel; ``AppendAsyncJob`` queues a
job whose result is posted back to the main loop; ``WaitClear`` drains all
groups at terminate/freeze time.

Here each group is one daemon thread + queue; completions post back through
a caller-supplied ``post`` callable (the world's PostQueue), preserving the
single-threaded logic model.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

from goworld_tpu_torch.utils import log

logger = log.get("async")

QUEUE_CAP = 10_000  # reference consts.go:96


class _Group:
    def __init__(self, name: str, post: Callable[[Callable], None]):
        self.name = name
        self.post = post
        self.q: "queue.Queue" = queue.Queue(maxsize=QUEUE_CAP)
        self.idle = threading.Event()
        self.idle.set()
        self.thread = threading.Thread(
            target=self._run, name=f"async-{name}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        while True:
            job, cb = self.q.get()
            if job is None:  # shutdown sentinel
                self.q.task_done()
                return
            self.idle.clear()
            try:
                res, err = job(), None
            except Exception as e:  # job errors go to the callback
                res, err = None, e
            if cb is not None:
                self.post(lambda cb=cb, res=res, err=err: cb(res, err))
            self.q.task_done()
            if self.q.empty():
                self.idle.set()

    def submit(self, job: Callable[[], Any],
               cb: Callable[[Any, Exception | None], None] | None) -> None:
        self.q.put((job, cb))


class AsyncWorkers:
    """All async groups of one process (reference package-level state)."""

    def __init__(self, post: Callable[[Callable], None]):
        self._post = post
        self._groups: dict[str, _Group] = {}
        self._lock = threading.Lock()

    def submit(self, group: str, job: Callable[[], Any],
               cb: Callable[[Any, Exception | None], None] | None = None,
               ) -> None:
        with self._lock:
            g = self._groups.get(group)
            if g is None:
                g = self._groups[group] = _Group(group, self._post)
        g.submit(job, cb)

    def wait_clear(self, timeout: float = 30.0) -> bool:
        """Block until every group's queue drains (reference ``WaitClear``;
        called before terminate/freeze)."""
        import time

        deadline = time.monotonic() + timeout
        for g in list(self._groups.values()):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if not g.idle.wait(remaining):
                return False
            g.q.join()
        return True
