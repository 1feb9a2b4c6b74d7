"""Serve-loop residency plane, the port of ``goworld_tpu/utils/residency.py``:
what does the serving tick pay besides the device step?

* **bubble_ms** — host wall time between consecutive device dispatches
  covered by NEITHER useful host work (staging flush, decode/fan-out,
  pump) NOR the blocking output fetch NOR the serve loop's intentional
  pacing sleep: frame time the device sits idle for no reason.
* **alloc churn** — per-tick deltas of the device allocator's stats
  sampled every N ticks, plus a residency census that fingerprints
  every lane of the ``SpaceState`` carry by ``tensor.data_ptr()``
  across sampled ticks: a lane whose address changes between samples is
  re-allocated each tick; a lane whose address never moves keeps its
  storage (the World's ``resident=True`` carry).
* **serve_gap** — measured serve-loop ms/tick (inter-dispatch p50) over
  a reference tick cost: ``set_scan_marginal_ms()`` when a caller
  provides one, else the tracker's own device-step p50 (dispatch +
  blocking fetch), stamped as ``serve_gap_ref``.

Phase lanes (``residency_phase_ms{phase=...}``; instants are host
``perf_counter`` marks riding the tick's existing structure, no device
sync):

================  =====================================================
``pre_dispatch``  tick begin -> device dispatch (timers + staging
                  flush; useful host work)
``device_wait``   fetch begin -> outputs host-visible (the blocking
                  ``_dget``)
``decode_fanout`` outputs host-visible -> host decode done
``host_other``    covered host work declared by the serve loop between
                  dispatches (sync fan-out flush, pump, ...)
``idle``          intentional pacing sleep declared by the serve loop
``bubble``        the residual: inter-dispatch gap minus all covered
                  and idle time, clamped at zero
================  =====================================================

Plus a ``gc``-callback pause tracker for the tick thread: ONE
process-global ``gc.callbacks`` entry (installed at most once) that
dispatches to a weak set of subscribed trackers, each counting only
collections that ran on its bound tick thread.

Where torch differs from the reference: a tensor has no donated and
deleted buffer, so ``census_skipped_deleted`` stays in the snapshot and
reads 0; and the memory stats are the PyTorch caching allocator's
(:meth:`ResidencyTracker.sample_memory`), which counts its own blocks,
not what XLA's allocator counts.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
import weakref
from typing import Any

import torch

from goworld_tpu_torch.utils import metrics
from goworld_tpu_torch.utils.syncage import ptiles

__all__ = [
    "ResidencyTracker", "GcPauseTracker", "PHASES",
    "DEFAULT_SAMPLE_EVERY", "DEFAULT_BUBBLE_BUDGET_MS", "register",
    "unregister", "snapshot_all", "reset", "gc_callback_count",
]

PHASES = ("pre_dispatch", "device_wait", "decode_fanout", "host_other",
          "idle", "bubble")

# census + memory_stats cadence (ticks); the timing lanes are always-on
DEFAULT_SAMPLE_EVERY = 16
# bubble budget for the pass verdict + the flight-recorder trigger:
# a quarter of the paper's 16.7 ms frame sitting idle is a regression
DEFAULT_BUBBLE_BUDGET_MS = 4.0


# sentinel for a DELETED leaf: a torch tensor has none (no buffer is
# donated and deleted), so the census never meets it; kept so the
# census counts and snapshot keys stay the reference's
_DELETED = object()


def _leaf_pointer(leaf):
    """Device address of one tensor lane (``data_ptr()``); None when the
    lane is not a tensor. Reads the address only — no transfer, no
    sync."""
    if isinstance(leaf, torch.Tensor):
        return int(leaf.data_ptr())
    return None


def _state_lanes(state, prefix: str = ""):
    """(name, lane) of every field of a state dataclass, nested
    dataclasses (the Verlet cache) as ``cache.lane``; None fields are
    left out, as an absent subtree is in the reference."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            yield from _state_lanes(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v


# =======================================================================
# gc pause tracking: ONE process-global callback, weakly-subscribed
# trackers. gc.callbacks entries live for the process; appending a bound
# method per tracker would both stack callbacks under test churn and pin
# every discarded tracker forever.
# =======================================================================
_gc_lock = threading.Lock()
_gc_subscribers: "weakref.WeakSet[GcPauseTracker]" = weakref.WeakSet()
_gc_installed = False


def _gc_dispatch(phase: str, info: dict) -> None:
    for t in list(_gc_subscribers):
        try:
            t._on_gc(phase)
        except Exception:
            pass  # observability must never break collection


def _gc_subscribe(tracker: "GcPauseTracker") -> None:
    global _gc_installed
    with _gc_lock:
        _gc_subscribers.add(tracker)
        if not _gc_installed:
            gc.callbacks.append(_gc_dispatch)
            _gc_installed = True


def _gc_unsubscribe(tracker: "GcPauseTracker") -> None:
    global _gc_installed
    with _gc_lock:
        _gc_subscribers.discard(tracker)
        if _gc_installed and not len(_gc_subscribers):
            try:
                gc.callbacks.remove(_gc_dispatch)
            except ValueError:
                pass
            _gc_installed = False


def gc_callback_count() -> int:
    """How many entries this module holds in ``gc.callbacks`` (tests
    assert it never exceeds 1 no matter how many trackers churn)."""
    return sum(1 for cb in gc.callbacks if cb is _gc_dispatch)


class GcPauseTracker:
    """Collector-pause accounting for ONE thread (the tick thread).
    ``install()``/``uninstall()`` are idempotent — repeated installs
    subscribe once; the module-global ``gc.callbacks`` entry is shared
    by every tracker and removed when the last one unsubscribes."""

    def __init__(self, name: str = "game"):
        self.name = name
        self._h = metrics.histogram(
            "residency_gc_pause_ms",
            help="stop-the-world gc pauses observed on the tick thread",
            tracker=name)
        self._thread: int | None = None
        self._t0: float | None = None
        self._installed = False
        self.pauses = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def bind_thread(self, ident: int | None = None) -> None:
        """Only collections running on this thread count: gc callbacks
        fire on whichever thread triggered the collection, and a pause
        on an io thread never stalls the tick."""
        self._thread = threading.get_ident() if ident is None else ident

    def install(self) -> None:
        if not self._installed:
            _gc_subscribe(self)
            self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            _gc_unsubscribe(self)
            self._installed = False

    def _on_gc(self, phase: str) -> None:
        if self._thread is not None \
                and threading.get_ident() != self._thread:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif phase == "stop" and self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._t0 = None
            self.pauses += 1
            self.total_ms += ms
            self.max_ms = max(self.max_ms, ms)
            self._h.observe(ms)

    def snapshot(self) -> dict[str, Any]:
        return {
            "pauses": self.pauses,
            "total_ms": round(self.total_ms, 3),
            "max_ms": round(self.max_ms, 3),
        }


class ResidencyTracker:
    """Per-World serve-loop residency accumulator.

    The instrumented tick calls the marks in order —
    ``tick_begin`` -> ``mark_dispatch`` -> ``mark_fetch`` ->
    ``mark_visible`` -> ``mark_decode_done`` — and the serve loop
    declares its own covered work (``add_host``) and pacing sleep
    (``add_idle``) between dispatches. ``mark_dispatch`` closes the
    previous inter-dispatch gap: whatever the declared covered + idle
    time does not explain is the bubble. All marks are
    ``perf_counter`` reads + histogram inserts; nothing touches the
    device.
    """

    def __init__(self, name: str = "game", *,
                 sample_every: int = DEFAULT_SAMPLE_EVERY,
                 bubble_budget_ms: float = DEFAULT_BUBBLE_BUDGET_MS):
        sample_every = int(sample_every)
        if sample_every < 1:
            raise ValueError(
                f"residency_sample_every must be >= 1, got "
                f"{sample_every} (1 samples the census/memory stats "
                f"every tick; large values only stretch the cadence)")
        self.name = name
        self.sample_every = sample_every
        self.bubble_budget_ms = float(bubble_budget_ms)
        self._h_tick = metrics.histogram(
            "residency_tick_ms",
            help="serve-loop inter-dispatch gap (measured ms/tick)",
            tracker=name)
        self._h_bubble = metrics.histogram(
            "residency_bubble_ms",
            help="inter-dispatch host time covered by neither useful "
                 "host work nor device wait nor intentional idle",
            tracker=name)
        self._h_devstep = metrics.histogram(
            "residency_device_step_ms",
            help="dispatch + blocking fetch per tick (production "
                 "proxy for the device marginal)",
            tracker=name)
        self._h_phase = {
            p: metrics.histogram(
                "residency_phase_ms",
                help="serve-loop phase residence per tick",
                tracker=name, phase=p)
            for p in PHASES
        }
        self.gc = GcPauseTracker(name)
        self._lock = threading.Lock()
        # per-gap accumulators (tick thread only)
        self._t_begin: float | None = None
        self._t_dispatch: float | None = None
        self._t_fetch: float | None = None
        self._t_visible: float | None = None
        self._covered_ms = 0.0
        self._host_other_ms = 0.0
        self._idle_ms = 0.0
        self._gc_bound = False
        self.ticks = 0
        self.last_bubble_ms: float | None = None
        self.last_tick_ms: float | None = None
        # serve_gap reference
        self.scan_marginal_ms: float | None = None
        # alloc churn (sampled)
        self._mem_prev: tuple[int, dict] | None = None  # (tick, stats)
        self._mem: dict[str, Any] | None = None
        self._mem_err: str | None = None
        # buffer census (sampled)
        self._census_prev: dict[str, int] | None = None
        self._census_changes: dict[str, int] = {}
        self._census_opaque: set[str] = set()
        self._census_samples = 0
        # lanes seen deleted: the reference's donated buffers; a torch
        # lane never is one, so this stays 0
        self._census_skipped_deleted = 0
        # window mark for the flight-recorder regression trigger
        self._win_mark: list[int] | None = None

    # -- per-tick marks (called from World._tick_phases) -----------------
    def tick_begin(self) -> None:
        self._t_begin = time.perf_counter()
        if not self._gc_bound:
            # first tick on the serving thread: bind + install (idempotent)
            self.gc.bind_thread()
            self.gc.install()
            self._gc_bound = True

    def mark_dispatch(self) -> None:
        t = time.perf_counter()
        pre_ms = 0.0
        if self._t_begin is not None:
            pre_ms = (t - self._t_begin) * 1e3
            self._h_phase["pre_dispatch"].observe(pre_ms)
        if self._t_dispatch is not None:
            gap_ms = (t - self._t_dispatch) * 1e3
            covered = self._covered_ms + pre_ms
            bubble = max(0.0, gap_ms - covered - self._idle_ms)
            self._h_tick.observe(gap_ms)
            self._h_bubble.observe(bubble)
            self._h_phase["host_other"].observe(self._host_other_ms)
            self._h_phase["idle"].observe(self._idle_ms)
            self._h_phase["bubble"].observe(bubble)
            self.last_tick_ms = gap_ms
            self.last_bubble_ms = bubble
            self.ticks += 1
        self._t_dispatch = t
        self._t_begin = None
        self._covered_ms = 0.0
        self._host_other_ms = 0.0
        self._idle_ms = 0.0

    def mark_fetch(self) -> None:
        self._t_fetch = time.perf_counter()

    def mark_visible(self) -> None:
        t = time.perf_counter()
        if self._t_fetch is not None:
            ms = (t - self._t_fetch) * 1e3
            self._h_phase["device_wait"].observe(ms)
            self._covered_ms += ms
            self._t_fetch = None
        self._t_visible = t

    def mark_decode_done(self) -> None:
        t = time.perf_counter()
        if self._t_visible is not None:
            ms = (t - self._t_visible) * 1e3
            self._h_phase["decode_fanout"].observe(ms)
            self._covered_ms += ms
            self._t_visible = None

    def add_host(self, seconds: float) -> None:
        """Covered useful host work between dispatches (serve-loop
        fan-out flush, input pump, governor, recorder, ...)."""
        if seconds > 0:
            ms = seconds * 1e3
            self._covered_ms += ms
            self._host_other_ms += ms

    def add_idle(self, seconds: float) -> None:
        """Intentional pacing sleep — idle by design, never a bubble."""
        if seconds > 0:
            self._idle_ms += seconds * 1e3

    def observe_device_step(self, seconds: float) -> None:
        # fed from the World's existing device_step_s measurement
        # (dispatch + blocking fetch); note: tick_begin->mark_visible
        # time is already covered via the phase marks, this series only
        # backs the serve_gap reference
        self._h_devstep.observe(seconds * 1e3)

    def set_scan_marginal_ms(self, ms: float) -> None:
        """Pin the serve_gap reference to a measured bare tick cost
        (without it the reference is the device-step p50)."""
        self.scan_marginal_ms = float(ms)

    # -- sampled churn (every sample_every ticks) ------------------------
    def should_sample(self, tick: int) -> bool:
        return tick % self.sample_every == 0

    def sample_memory(self, device, tick: int) -> None:
        """Allocator churn from ``torch.cuda.memory_stats(device)``
        deltas. These count the PyTorch caching allocator's blocks:
        ``allocated_bytes.all.current`` (bytes in tensors now) and
        ``allocation.all.allocated`` (allocations handed out since the
        process began), stored under the reference's names
        ``bytes_in_use`` and ``num_allocs`` and, beside them, under
        their own. They are not what XLA's allocator counts: a block
        the cache hands out again is one more allocation here and no
        device call. Honest absence: a CPU device serves no stats —
        recorded as ``unavailable``, never a zero pretending to be
        measured."""
        device = torch.device(device)
        if device.type != "cuda":
            self._mem_err = "memory_stats unavailable on this backend"
            return
        try:
            stats = torch.cuda.memory_stats(device)
        except Exception as exc:
            self._mem_err = f"memory_stats failed: {exc}"[:120]
            return
        if not stats:
            self._mem_err = "memory_stats unavailable on this backend"
            return
        cur = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
        }
        with self._lock:
            prev = self._mem_prev
            self._mem_prev = (tick, dict(cur))
            mem: dict[str, Any] = dict(cur)
            mem["allocated_bytes.all.current"] = cur["bytes_in_use"]
            mem["allocation.all.allocated"] = cur["num_allocs"]
            mem["allocated_bytes.all.peak"] = cur["peak_bytes_in_use"]
            mem["source"] = "torch.cuda.memory_stats (caching allocator)"
            if prev is not None and tick > prev[0]:
                dt = tick - prev[0]
                mem["bytes_per_tick"] = round(
                    (cur["bytes_in_use"] - prev[1]["bytes_in_use"]) / dt)
                mem["allocs_per_tick"] = round(
                    (cur["num_allocs"] - prev[1]["num_allocs"]) / dt, 2)
            self._mem = mem
            self._mem_err = None

    def sample_census(self, state) -> None:
        """Residency census: fingerprint every lane of the carry (the
        ``SpaceState`` dataclass's tensor fields, by name) by its
        storage address. Lanes whose address changes between samples
        are re-allocated each tick; stable addresses keep their storage.
        Address reads only — no transfer, no sync. With the caching
        allocator a replaced lane may be handed the address it just
        freed, so "stable" is proven only where the carry is written in
        place (``resident=True``)."""
        ptrs: dict[str, int] = {}
        skipped = 0
        for lane, leaf in _state_lanes(state):
            p = _leaf_pointer(leaf)
            if p is _DELETED:
                skipped += 1
            elif p is None:
                self._census_opaque.add(lane)
            else:
                ptrs[lane] = p
        with self._lock:
            self._census_skipped_deleted += skipped
            prev, self._census_prev = self._census_prev, ptrs
            if prev is None:
                return
            self._census_samples += 1
            for lane, p in ptrs.items():
                q = prev.get(lane)
                if q is None:
                    continue
                self._census_changes.setdefault(lane, 0)
                if p != q:
                    self._census_changes[lane] += 1

    # -- reading ---------------------------------------------------------
    @staticmethod
    def _edges_counts(h: metrics.Histogram) -> tuple[list, list]:
        snap = h.snapshot()
        edges = [u for u, _c in snap["buckets"]]
        counts = [c for _u, c in snap["buckets"]] + [snap["inf"]]
        return edges, counts

    def window_verdict(self) -> tuple[float | None, int]:
        """(bubble p99 over the observations since the previous call,
        sample count): the windowed-delta grammar of
        ``syncage.AgeTracker.window_verdict``."""
        edges, counts = self._edges_counts(self._h_bubble)
        with self._lock:
            mark, self._win_mark = self._win_mark, list(counts)
        if mark is None or len(mark) != len(counts):
            return None, 0
        delta = [max(0, a - b) for a, b in zip(counts, mark)]
        n = sum(delta)
        if n <= 0:
            return None, 0
        from goworld_tpu_torch.utils import devprof

        p99 = devprof.hist_quantile_interp(edges, delta, 0.99)
        return (None if p99 != p99 else p99), n

    def census_snapshot(self) -> dict[str, Any]:
        with self._lock:
            changes = dict(self._census_changes)
            samples = self._census_samples
            opaque = sorted(self._census_opaque)
            skipped = self._census_skipped_deleted
        return {
            "samples": samples,
            "lanes": len(changes),
            "realloc": sorted(l for l, c in changes.items() if c > 0),
            "aliased": sorted(l for l, c in changes.items() if c == 0),
            "opaque": opaque,
            "skipped_deleted": skipped,
            "changes": {l: c for l, c in sorted(changes.items())},
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``/residency`` payload: raw count vectors (mergeable via
        ``Histogram.add_counts``) plus the three verdicts."""
        edges, tick_counts = self._edges_counts(self._h_tick)
        _, bubble_counts = self._edges_counts(self._h_bubble)
        tick_p = ptiles(edges, tick_counts)
        bubble_p = ptiles(edges, bubble_counts)
        phases: dict[str, Any] = {}
        phase_counts: dict[str, list] = {}
        for p in PHASES:
            pe, pc = self._edges_counts(self._h_phase[p])
            phases[p] = ptiles(pe, pc)
            phase_counts[p] = pc
        out: dict[str, Any] = {
            "ticks": self.ticks,
            "edges_ms": edges,
            "tick": tick_p,
            "tick_counts": tick_counts,
            "bubble": bubble_p,
            "bubble_counts": bubble_counts,
            "bubble_budget_ms": self.bubble_budget_ms,
            "phases": phases,
            "phase_counts": phase_counts,
            "gc": self.gc.snapshot(),
            "sample_every": self.sample_every,
        }
        # alloc churn: measured, or an honest absence
        with self._lock:
            mem, mem_err = self._mem, self._mem_err
        if mem is not None:
            out["alloc"] = dict(mem)
        else:
            out["alloc"] = {
                "unavailable": mem_err or "not sampled yet"}
        out["census"] = self.census_snapshot()
        # serve_gap: measured serve ms/tick over the scan-marginal
        # reference (honest about which reference backed it)
        serve_ms = tick_p.get("p50_ms")
        if self.scan_marginal_ms is not None:
            ref, ref_name = self.scan_marginal_ms, "scan_marginal"
        else:
            de, dc = self._edges_counts(self._h_devstep)
            ref = ptiles(de, dc).get("p50_ms")
            ref_name = "device_step_p50"
        if isinstance(serve_ms, (int, float)) \
                and isinstance(ref, (int, float)) and ref > 0:
            out["serve_ms_per_tick"] = serve_ms
            out["serve_gap"] = round(serve_ms / ref, 3)
            out["serve_gap_ref"] = ref_name
            out["serve_gap_ref_ms"] = round(ref, 3)
        p99 = bubble_p.get("p99_ms")
        if isinstance(p99, (int, float)):
            out["pass"] = bool(p99 <= self.bubble_budget_ms)
        return out

    def close(self) -> None:
        """Detach the gc subscription (idempotent)."""
        self.gc.uninstall()


# =======================================================================
# process-local registry (the ``/residency`` payload). Weak values: the
# tracker belongs to its World and a discarded world must not be pinned
# by the registry.
# =======================================================================
_reg_lock = threading.Lock()
_trackers: "weakref.WeakValueDictionary[str, ResidencyTracker]" = \
    weakref.WeakValueDictionary()


def register(name: str, tracker: ResidencyTracker) -> ResidencyTracker:
    with _reg_lock:
        _trackers[name] = tracker
    return tracker


def unregister(name: str) -> None:
    with _reg_lock:
        _trackers.pop(name, None)


def snapshot_all() -> dict:
    """``/residency``: every registered tracker's snapshot, or an
    honest absence."""
    with _reg_lock:
        trackers = dict(_trackers)
    if not trackers:
        return {"error": "no residency tracker in this process"}
    return {name: t.snapshot() for name, t in sorted(trackers.items())}


def reset() -> None:
    """Drop registered trackers (tests)."""
    with _reg_lock:
        _trackers.clear()
