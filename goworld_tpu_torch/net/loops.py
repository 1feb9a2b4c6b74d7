"""Shared asyncio-loop teardown for the network threads.

Every process role (game net thread, cluster harness, CLI runners) ends
the same way: cancel the loop's tasks, AWAIT the cancellations, stop the
loop, join its thread, close the loop. Stopping the loop in the same
callback that cancels (the old pattern) left half-cancelled coroutines to
be finalized against a dead loop — the "coroutine ignored GeneratorExit"
/ "Event loop is closed" unraisable warnings every suite run used to end
with.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Callable

from goworld_tpu_torch.utils import log

logger = log.get("net")


def drain_and_close(
    loop: asyncio.AbstractEventLoop | None,
    thread: threading.Thread | None,
    pre_stop: Callable[[], None] | None = None,
    timeout: float = 5.0,
) -> None:
    """Gracefully tear down a loop running in ``thread``.

    Idempotent: calling again after the loop is closed is a no-op.
    ``pre_stop`` runs on the loop first (e.g. DispatcherCluster.stop);
    its failure cannot prevent the loop from stopping.
    """
    if loop is None or loop.is_closed():
        return

    async def _drain() -> None:
        try:
            if pre_stop is not None:
                try:
                    pre_stop()
                except Exception:
                    logger.exception("pre_stop failed during teardown")
            tasks = [
                t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()
            ]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        finally:
            loop.stop()

    if loop.is_running():
        coro = _drain()
        try:
            asyncio.run_coroutine_threadsafe(coro, loop)
        except RuntimeError:
            coro.close()  # loop stopped in the race window
        if thread is not None:
            thread.join(timeout=timeout)
    else:
        # loop stopped but open (e.g. its thread died during boot):
        # nothing can schedule there — finalize the orphan tasks inline
        # so close() doesn't discard half-cancelled coroutines
        try:
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
        except RuntimeError:
            pass
        if thread is not None:
            thread.join(timeout=timeout)
    if not loop.is_running() and not loop.is_closed():
        loop.close()
