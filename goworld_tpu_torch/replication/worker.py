"""The bounded replication worker, the port's copy of
``goworld_tpu/replication/worker.py``: chain diffs, disk chain writes
and stream frame sends, all OFF the tick thread.

Written synchronously, the quantized/delta SnapshotChain runs its
quantize+diff+write on the tick thread. This worker moves it off. The
tick thread's cost is now ONE cheap capture (host records with
deferred plane refs — ``SnapshotChain.capture``);
everything slow — the device fetch, the quantize/diff, msgpack, the
atomic disk write, the stream frame send — runs here, on one daemon
thread, so chain state (the in-memory keyframe) stays single-threaded.

Backpressure is the point, not an accident: the queue is BOUNDED
(default 4 captures). When it is full — slow disk, slow standby link,
a wedged consumer — ``submit()`` drops the capture, bumps the loud
``replication_captures_dropped_total`` counter, and arms
``force_keyframe``: the NEXT accepted capture builds a full keyframe
instead of a delta. A backlogged stream therefore degrades to
keyframe cadence (each accepted frame self-contained, the standby
re-anchors on it) instead of wedging the primary's tick or silently
accumulating unbounded deltas the consumer can never catch up on.
Same collapse when a standby attaches or reports a torn stream
(``request_keyframe``).

The audit plane's bounded worker (utils/audit.py AuditPlane) is the
in-repo precedent for the queue discipline; this one additionally
OWNS mutable state (the chain keyframe), which is why jobs never run
inline on overflow — they are dropped whole.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from goworld_tpu_torch.utils import log, metrics

logger = log.get("replication")


class ReplicationWorker:
    """One worker per primary game. ``submit()`` is called from the
    tick thread with a ``SnapshotChain.capture()`` tuple; the worker
    completes the capture, builds the chain record, optionally writes
    the disk chain files, and hands each framed record to ``send_fn``
    (installed by the game when a standby subscribes; None = disk
    only)."""

    def __init__(self, chain, *, game_id: int, queue_max: int = 4,
                 send_fn: "Callable[[bytes, str, int], None] | None" = None):
        if queue_max < 1:
            raise ValueError(
                f"queue_max must be >= 1, got {queue_max!r}")
        from goworld_tpu_torch.replication.frames import StreamEncoder

        self.chain = chain
        self.game_id = int(game_id)
        self.send_fn = send_fn
        self.encoder = StreamEncoder()
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_max))
        self._force_key = threading.Event()
        # the chain's current keyframe was built by a stream-only job
        self._key_off_disk = False
        self._closed = False
        self.frames_sent = 0
        self.bytes_sent = 0
        self.disk_writes = 0
        self.errors = 0
        self.last_kind: str | None = None
        self.last_tick: int = -1
        self._m_dropped = metrics.counter(
            "replication_captures_dropped_total",
            help="tick-thread captures dropped on a full replication "
                 "worker queue (stream degrades to keyframe cadence)",
            game=str(self.game_id))
        self._m_frames = metrics.counter(
            "replication_frames_total",
            help="replication frames built by the worker",
            game=str(self.game_id))
        self._m_bytes = metrics.counter(
            "replication_stream_bytes_total",
            help="framed replication bytes handed to the stream send",
            game=str(self.game_id))
        # the worker fetches the captured planes: on a card it runs on
        # the World's device (resolved here, on the tick thread, when
        # the World names the card without an index), so its copy
        # stream and events live there
        self._device = None
        dev = getattr(getattr(chain, "world", None), "device", None)
        if getattr(dev, "type", None) == "cuda":
            import torch

            self._device = dev if dev.index is not None else torch.device(
                "cuda", torch.cuda.current_device())
        self._t = threading.Thread(
            target=self._run, name=f"repl-{self.game_id}", daemon=True)
        self._t.start()

    # -- tick-thread API ------------------------------------------------
    def submit(self, captured: tuple, *, to_disk: bool = True,
               to_stream: bool = True) -> bool:
        """Enqueue one capture; NEVER blocks. False = dropped (queue
        full): the drop is counted loudly and the next accepted
        capture is forced to a keyframe (backlog collapse)."""
        if self._closed:
            return False
        try:
            self._q.put_nowait(("job", captured, to_disk, to_stream))
            return True
        except queue.Full:
            self._m_dropped.inc()
            self._force_key.set()
            return False

    def request_keyframe(self) -> None:
        """Force the next built frame to a keyframe (standby attach /
        torn-stream resync)."""
        self._force_key.set()

    def dropped_total(self) -> int:
        return int(self._m_dropped.value)

    def stats(self) -> dict:
        return {
            "frames_sent": self.frames_sent,
            "bytes_sent": self.bytes_sent,
            "disk_writes": self.disk_writes,
            "captures_dropped": self.dropped_total(),
            "errors": self.errors,
            "last_kind": self.last_kind,
            "last_tick": self.last_tick,
            "queue_depth": self._q.qsize(),
        }

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued job has been PROCESSED (tests and
        clean freeze paths; join() semantics need per-job accounting,
        so a sentinel round-trips the queue)."""
        done = threading.Event()
        try:
            self._q.put(("sync", done, None, None), timeout=timeout)
        except queue.Full:
            return False
        return done.wait(timeout)

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        try:
            self._q.put_nowait(("stop", None, None, None))
        except queue.Full:
            # the worker will see _closed after the backlog drains;
            # drop one queued job to make room for the stop marker
            try:
                self._q.get_nowait()
                self._q.put_nowait(("stop", None, None, None))
            except (queue.Empty, queue.Full):
                pass
        self._t.join(timeout)

    # -- worker thread --------------------------------------------------
    def _run(self) -> None:
        if self._device is not None:
            import torch

            torch.cuda.set_device(self._device)
        while True:
            kind, payload, to_disk, to_stream = self._q.get()
            if kind == "stop":
                return
            if kind == "sync":
                payload.set()
                continue
            try:
                self._process(payload, to_disk, to_stream)
            except Exception:
                # a failed build/write must not kill replication for
                # the process lifetime: count, resync, keep consuming
                self.errors += 1
                self._force_key.set()
                logger.exception(
                    "game%d: replication job failed", self.game_id)
            finally:
                if self._closed and self._q.empty():
                    return

    def _process(self, captured, to_disk: bool, to_stream: bool) -> None:
        data, tick = self.chain.complete_capture(captured)
        force = self._force_key.is_set()
        if force:
            self._force_key.clear()
        if to_disk and self._key_off_disk:
            # the chain files must resolve: a delta on disk needs its
            # keyframe on disk, and the chain's keyframe was built for
            # the stream alone (ROADMAP.md Queue C11; the JAX package's
            # worker writes that delta against a keyframe its files
            # never held)
            force = True
        rec_kind, rec = self.chain.build(data, force_key=force)
        if rec_kind == "key":
            self._key_off_disk = not to_disk
        self._m_frames.inc()
        self.last_kind = rec_kind
        self.last_tick = tick
        if to_disk:
            self.chain.write_record(rec_kind, rec)
            self.disk_writes += 1
        send = self.send_fn
        if to_stream and send is not None:
            blob = self.encoder.encode(tick, rec_kind, rec)
            send(blob, rec_kind, tick)
            self.frames_sent += 1
            self.bytes_sent += len(blob)
            self._m_bytes.inc(len(blob))
