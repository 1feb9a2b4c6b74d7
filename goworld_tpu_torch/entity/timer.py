"""Timers, post queue, and crontab — the single-threaded runtime
utilities; the port's copy of ``goworld_tpu/entity/timer.py``.

Reference being rebuilt:
* ``engine/post`` (``post.go:21-45``): a callback queue drained at the end
  of each main-loop iteration ("defer to end of frame").
* goTimer heap timers ticked from the main loop (``GameService.go:174``);
  entity timers wrap them with migration-safe serialization
  (``Entity.go:271-418`` ``AddCallback``/``AddTimer``/``dumpTimers``/
  ``restoreTimers``).
* ``engine/crontab`` (``crontab.go:95-185``): minute-resolution cron where
  negative values mean "every N".

All of it is single-threaded: the world loop calls :meth:`TimerQueue.tick`
once per host tick, matching the reference's one-goroutine logic model
(``SURVEY.md#1`` threading model).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Any, Callable

from goworld_tpu_torch.utils import log

logger = log.get("timer")


class PostQueue:
    """Reference ``engine/post``: run callbacks after the current frame."""

    def __init__(self):
        self._q: deque[Callable[[], None]] = deque()

    def post(self, cb: Callable[[], None]) -> None:
        self._q.append(cb)

    def tick(self) -> int:
        """Drain everything queued so far (not callbacks queued while
        draining — those run next frame, like the reference's swap)."""
        n = len(self._q)
        for _ in range(n):
            cb = self._q.popleft()
            try:
                cb()
            except Exception:
                logger.exception("post callback failed")
        return n

    def __len__(self) -> int:
        return len(self._q)


@dataclasses.dataclass
class _Timer:
    tid: int
    fire_at: float
    interval: float  # 0 => one-shot (AddCallback), >0 => repeat (AddTimer)
    cb: Callable | None  # plain callable, or None when method-based
    method: str | None  # entity method name (migration/freeze-safe form)
    args: tuple
    cancelled: bool = False


class TimerQueue:
    """Heap of timers driven by the world loop.

    ``clock`` is injectable for deterministic tests and virtual time; the
    default is wall clock like the reference's goTimer.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._heap: list[tuple[float, int, _Timer]] = []
        self._timers: dict[int, _Timer] = {}
        self._seq = itertools.count(1)

    def add(
        self,
        delay: float,
        cb: Callable | None = None,
        *,
        interval: float = 0.0,
        method: str | None = None,
        args: tuple = (),
    ) -> int:
        t = _Timer(
            tid=next(self._seq),
            fire_at=self.clock() + delay,
            interval=interval,
            cb=cb,
            method=method,
            args=args,
        )
        self._timers[t.tid] = t
        heapq.heappush(self._heap, (t.fire_at, t.tid, t))
        return t.tid

    def cancel(self, tid: int) -> bool:
        t = self._timers.pop(tid, None)
        if t is None:
            return False
        t.cancelled = True
        # the dead heap entry sits until its fire_at (lazy deletion);
        # drop the callback closure NOW — it typically holds the owning
        # entity (e.g. the 300 s save timer), which must be refcount-
        # reclaimable the moment it's destroyed (the gc.freeze boot
        # discipline exempts boot objects from cycle collection)
        t.cb = None
        t.args = ()
        return True

    def tick(self, fire: Callable[[_Timer], None]) -> int:
        """Fire every due timer through ``fire`` (the owner resolves
        method-based timers against live entities)."""
        now = self.clock()
        fired = 0
        while self._heap and self._heap[0][0] <= now:
            _, _, t = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            if t.interval > 0:
                t.fire_at = now + t.interval
                heapq.heappush(self._heap, (t.fire_at, t.tid, t))
            else:
                self._timers.pop(t.tid, None)
            try:
                fire(t)
            except Exception:
                logger.exception("timer %s fired with error", t.tid)
            fired += 1
        return fired

    # -- freeze / migration support (reference dumpTimers/restoreTimers) --
    def dump(self, tids: list[int], now: float | None = None) -> list[dict]:
        """Serialize the given timers relative to now (method-based only —
        closures can't migrate, same restriction as the reference)."""
        now = self.clock() if now is None else now
        out = []
        for tid in tids:
            t = self._timers.get(tid)
            if t is None or t.cancelled or t.method is None:
                continue
            out.append({
                "remain": max(0.0, t.fire_at - now),
                "interval": t.interval,
                "method": t.method,
                "args": list(t.args),
            })
        return out

    def restore(self, dumped: list[dict]) -> list[int]:
        return [
            self.add(
                d["remain"],
                interval=d["interval"],
                method=d["method"],
                args=tuple(d["args"]),
            )
            for d in dumped
        ]

    def __len__(self) -> int:
        return len(self._timers)


class Crontab:
    """Minute-resolution cron (reference ``crontab.go:95-185``).

    ``register(minute, hour, day, month, dow, cb)`` — each field matches
    exactly, or any value when -1, or "every N" when < -1 (reference's
    negative convention: -N means every N units).
    """

    def __init__(self):
        self._entries: list[tuple[tuple[int, int, int, int, int], Callable]] = []
        self._last_minute = -1

    def register(
        self, minute: int, hour: int, day: int, month: int, dow: int,
        cb: Callable[[], None],
    ) -> None:
        self._entries.append(((minute, hour, day, month, dow), cb))

    @staticmethod
    def _match(spec: int, val: int) -> bool:
        if spec == -1:
            return True
        if spec < -1:
            return val % (-spec) == 0
        return spec == val

    def tick(self, now: float | None = None) -> int:
        """Call from the world loop; fires at most once per wall minute."""
        now = time.time() if now is None else now
        lt = time.localtime(now)
        minute_stamp = int(now // 60)
        if minute_stamp == self._last_minute:
            return 0
        self._last_minute = minute_stamp
        fired = 0
        # day-of-week follows the reference's Go time.Weekday convention
        # (Sunday=0, and 7 also means Sunday — crontab.go); Python's
        # tm_wday is Monday=0, so convert
        dow_now = (lt.tm_wday + 1) % 7
        for (mi, h, d, mo, dw), cb in self._entries:
            if (
                self._match(mi, lt.tm_min)
                and self._match(h, lt.tm_hour)
                and self._match(d, lt.tm_mday)
                and self._match(mo, lt.tm_mon)
                and self._match(dw % 7 if dw > 0 else dw, dow_now)
            ):
                try:
                    cb()
                except Exception:
                    logger.exception("crontab callback failed")
                fired += 1
        return fired
