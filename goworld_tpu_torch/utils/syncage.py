"""End-to-end sync-age plane: how stale is a position update when it
leaves a gate toward a client? (The port's copy of
``goworld_tpu/utils/syncage.py``, with trackers of its own.)

Every SLO verdict before this module measured only the DEVICE tick
(``tick_latency_ms`` / the bench scan-marginal). But the paper's target
— "AOI-sync p99 < 16 ms" — is about what a *client* observes, and
between the device tick that computed a position and the gate flushing
it to a socket sit four host-side hops: output fetch + decode, the
game's per-gate encode, the dispatcher forward, and the gate's
per-client regroup/flush. This module makes that whole path legible:

* :class:`SyncAgeStamp` — a fixed 45-byte per-BATCH stamp (one per
  sync fan-out packet, never per record) carrying the device-tick
  epoch that produced the batch (a per-tick monotonic ``seq`` plus a
  host wall anchor captured at the tick's EXISTING fetch-outputs
  transfer — zero extra device syncs) and one wall instant per hop
  boundary. It rides the wire as a flagged trailer exactly like the
  tracing context (``net/packet.py`` ``AGE_FLAG``): packets without a
  stamp are byte-identical to the pre-stamp wire.
* :class:`AgeTracker` — the gate-side accumulator: at flush time it
  turns a stamp + delivery instant into AGE-AT-DELIVERY observations
  in fixed-bucket histograms — ``sync_age_ms`` (end-to-end) plus one
  ``sync_age_hop_ms{hop=...}`` lane per hop — weighted by the number
  of records delivered (a 10K-record batch arriving late is 10K stale
  updates, not one).

Hop lanes (each pair of adjacent instants; they sum EXACTLY to the
end-to-end age by construction):

====================  ==================================================
``device_tick``       tick start -> outputs host-visible (device step +
                      the blocking fetch; under ``pipeline_decode`` the
                      anchors follow the outputs one tick back, so the
                      lane honestly includes the pipeline skew)
``drain_decode``      outputs host-visible -> sync flush begins (host
                      decode + AOI fan-out staging)
``encode``            flush begins -> packet handed to the socket
                      (per-gate concat + batch/delta encode)
``dispatcher``        game send -> dispatcher forward (wire leg + any
                      dispatcher pend-queue residence)
``gate_flush``        dispatcher forward -> gate per-client send (wire
                      leg + delta decode + per-client regroup)
====================  ==================================================

Clock honesty: instants are ``time.time()`` microseconds from three
processes. On one host (every test/bench deployment) they share a
clock; across hosts the deployment aggregator
(``tools/obs_aggregate.py``) measures pairwise wall offsets through
the existing ``/clock`` anchors and stamps the worst skew next to its
verdict, so cross-process ages are never silently trusted. A lane that
comes out negative (clock warp) clamps to zero and is counted in
``sync_age_clock_warp_total`` instead of poisoning a histogram.

Jax-free; shared by net/game, net/dispatcher, net/gate, debug_http
(``/syncage``), bench.py and the aggregator.
"""

from __future__ import annotations

import struct
import threading
import time
import weakref
from typing import Any

from goworld_tpu_torch.utils import metrics

__all__ = [
    "SyncAgeStamp", "AgeTracker", "HOPS", "STAMP_WIRE_SIZE",
    "DEFAULT_TARGET_MS", "now_us", "ptiles", "register",
    "unregister", "snapshot_all", "reset",
]

# the paper's headline target: AOI-sync p99 < 16 ms @ 60 Hz
DEFAULT_TARGET_MS = 16.0

HOPS = ("device_tick", "drain_decode", "encode", "dispatcher",
        "gate_flush")

_STAMP = struct.Struct("<BIQQQQQ")  # version, seq, 5 wall-us instants
STAMP_WIRE_SIZE = _STAMP.size       # 45 bytes per BATCH packet
STAMP_VERSION = 1


def now_us() -> int:
    return int(time.time() * 1e6)


def ptiles(edges, counts) -> dict[str, Any]:
    """Reduce a count vector to ``{samples, p50/p90/p99_ms}`` with the
    interpolated estimator (non-finite quantiles stringify as
    ``"inf"``). The ONE home for the percentile convention — shared by
    :class:`AgeTracker`, the deployment aggregator
    (``tools/obs_aggregate.py``) and the bench ``sync_age`` block."""
    from goworld_tpu_torch.utils import devprof

    total = sum(counts)
    if total <= 0:
        return {"samples": 0}
    out: dict[str, Any] = {"samples": int(total)}
    for name, q in (("p50_ms", 0.50), ("p90_ms", 0.90),
                    ("p99_ms", 0.99)):
        v = devprof.hist_quantile_interp(edges, counts, q)
        out[name] = round(v, 3) if v == v and v != float("inf") \
            else "inf"
    return out


class SyncAgeStamp:
    """One sync fan-out batch's provenance: the device-tick epoch that
    produced it plus a wall instant per hop boundary. ``t_disp_us`` is
    zero until the dispatcher forwards the packet (it patches its own
    instant in); a zero dispatcher instant folds that hop into
    ``gate_flush`` so the lane sum stays exact."""

    __slots__ = ("seq", "t_tick_us", "t_fetch_us", "t_stage_us",
                 "t_send_us", "t_disp_us")

    def __init__(self, seq: int, t_tick_us: int, t_fetch_us: int,
                 t_stage_us: int = 0, t_send_us: int = 0,
                 t_disp_us: int = 0):
        self.seq = int(seq)
        self.t_tick_us = int(t_tick_us)
        self.t_fetch_us = int(t_fetch_us)
        self.t_stage_us = int(t_stage_us)
        self.t_send_us = int(t_send_us)
        self.t_disp_us = int(t_disp_us)

    def pack(self) -> bytes:
        return _STAMP.pack(STAMP_VERSION, self.seq & 0xFFFFFFFF,
                           self.t_tick_us, self.t_fetch_us,
                           self.t_stage_us, self.t_send_us,
                           self.t_disp_us)

    @classmethod
    def unpack(cls, b: bytes) -> "SyncAgeStamp":
        if len(b) != STAMP_WIRE_SIZE:
            raise ValueError(
                f"sync-age stamp must be {STAMP_WIRE_SIZE} bytes, "
                f"got {len(b)}")
        ver, seq, t_tick, t_fetch, t_stage, t_send, t_disp = \
            _STAMP.unpack(b)
        if ver != STAMP_VERSION:
            raise ValueError(f"sync-age stamp version {ver} unsupported")
        return cls(seq, t_tick, t_fetch, t_stage, t_send, t_disp)

    def lanes_us(self, t_deliver_us: int) -> tuple[dict[str, int], int]:
        """Per-hop residence times in microseconds at delivery instant
        ``t_deliver_us``. Returns ``(lanes, warped)`` where ``warped``
        counts boundary pairs that came out negative (cross-process
        clock skew) and were clamped to zero. The clamped lanes still
        sum to ``max(0, t_deliver - t_tick)`` exactly: each boundary is
        first made monotone, then adjacent differences are taken."""
        t_disp = self.t_disp_us or self.t_send_us
        raw = [self.t_tick_us, self.t_fetch_us, self.t_stage_us,
               self.t_send_us, t_disp, int(t_deliver_us)]
        warped = 0
        mono = [raw[0]]
        for v in raw[1:]:
            if v < mono[-1]:
                warped += 1
                v = mono[-1]
            mono.append(v)
        lanes = {hop: mono[i + 1] - mono[i]
                 for i, hop in enumerate(HOPS)}
        return lanes, warped


class AgeTracker:
    """Gate-side sync-age accumulator: fixed-bucket histograms for the
    end-to-end age and every hop lane, record-weighted, plus a
    windowed p99 reader for the flight-recorder breach trigger. All
    series live in the process metrics registry (scraped at
    ``/metrics``); :meth:`snapshot` serves the raw count vectors at
    ``/syncage`` so the deployment aggregator can merge histograms
    exactly (``Histogram.add_counts``) instead of re-parsing
    Prometheus text."""

    def __init__(self, target_ms: float = DEFAULT_TARGET_MS,
                 name: str = "gate"):
        # series are labeled by tracker name: registry families dedup
        # by (name, labels), so two trackers in one process (multi-gate
        # tests, embedded harnesses) must not silently share buckets
        self.target_ms = float(target_ms)
        self.name = name
        self._h_e2e = metrics.histogram(
            "sync_age_ms",
            help="age of sync records at gate delivery, device-tick "
                 "epoch to per-client flush (record-weighted)",
            gate=name)
        self._h_hop = {
            hop: metrics.histogram(
                "sync_age_hop_ms",
                help="per-hop share of the sync age at delivery",
                gate=name, hop=hop)
            for hop in HOPS
        }
        self._m_warp = metrics.counter(
            "sync_age_clock_warp_total",
            help="sync-age boundary pairs clamped for negative "
                 "(cross-process clock skew) residence",
            gate=name)
        self._m_batches = metrics.counter(
            "sync_age_batches_total",
            help="stamped sync batches aged at delivery",
            gate=name)
        # freshest observation, for tests and the /syncage payload —
        # exact microsecond lanes, before any bucketing
        self.last_lanes_ms: dict[str, float] | None = None
        self.last_e2e_ms: float | None = None
        self.last_seq: int | None = None
        # window mark for the flush-cadence breach trigger: e2e count
        # vector at the previous window_verdict() call
        self._win_mark: list[int] | None = None
        self._lock = threading.Lock()

    def observe(self, stamp: SyncAgeStamp, t_deliver_us: int,
                n_records: int) -> None:
        if n_records <= 0:
            return
        lanes, warped = stamp.lanes_us(t_deliver_us)
        e2e_us = sum(lanes.values())
        self._h_e2e.observe_n(e2e_us / 1e3, n_records)
        for hop, us in lanes.items():
            self._h_hop[hop].observe_n(us / 1e3, n_records)
        if warped:
            self._m_warp.inc(warped)
        self._m_batches.inc()
        self.last_lanes_ms = {h: v / 1e3 for h, v in lanes.items()}
        self.last_e2e_ms = e2e_us / 1e3
        self.last_seq = stamp.seq

    # -- reading ---------------------------------------------------------
    @staticmethod
    def _edges_counts(h: metrics.Histogram) -> tuple[list, list]:
        snap = h.snapshot()
        edges = [u for u, _c in snap["buckets"]]
        counts = [c for _u, c in snap["buckets"]] + [snap["inf"]]
        return edges, counts

    _ptiles = staticmethod(ptiles)

    def window_verdict(self) -> tuple[float | None, int]:
        """(e2e p99 over the observations since the previous call,
        sample count). ``None`` p99 on an empty window. Drives the
        gate's flight-recorder ``sync_age_breach`` frames."""
        edges, counts = self._edges_counts(self._h_e2e)
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

    def snapshot(self) -> dict:
        """The ``/syncage`` payload: raw count vectors (mergeable via
        ``Histogram.add_counts``) plus derived percentiles and the
        e2e verdict against this tracker's target."""
        edges, e2e_counts = self._edges_counts(self._h_e2e)
        e2e = self._ptiles(edges, e2e_counts)
        hops: dict[str, Any] = {}
        hop_counts: dict[str, list] = {}
        for hop in HOPS:
            he, hc = self._edges_counts(self._h_hop[hop])
            hops[hop] = self._ptiles(he, hc)
            hop_counts[hop] = hc
        out = {
            "target_ms": self.target_ms,
            "edges_ms": edges,
            "e2e": e2e,
            "e2e_counts": e2e_counts,
            "hops": hops,
            "hop_counts": hop_counts,
            "clock_warp_total": int(self._m_warp.value),
            "batches": int(self._m_batches.value),
        }
        p99 = e2e.get("p99_ms")
        if isinstance(p99, (int, float)):
            out["pass"] = bool(p99 <= self.target_ms)
        return out


# =======================================================================
# process-local registry (served by debug_http /syncage). Weak values:
# the tracker belongs to its GateService and a discarded gate must not
# be pinned by the registry (the flightrec/devprof convention).
# =======================================================================
_reg_lock = threading.Lock()
_trackers: "weakref.WeakValueDictionary[str, AgeTracker]" = \
    weakref.WeakValueDictionary()


def register(name: str, tracker: AgeTracker) -> AgeTracker:
    with _reg_lock:
        _trackers[name] = tracker
    return tracker


def unregister(name: str) -> None:
    with _reg_lock:
        _trackers.pop(name, None)


def snapshot_all() -> dict:
    """``/syncage``: every registered tracker's snapshot, or an honest
    absence (a game/dispatcher process serves the endpoint but ages
    nothing — the aggregator skips it silently)."""
    with _reg_lock:
        trackers = dict(_trackers)
    if not trackers:
        return {"error": "no sync-age tracker in this process"}
    return {name: t.snapshot() for name, t in sorted(trackers.items())}


def reset() -> None:
    """Drop registered trackers (tests)."""
    with _reg_lock:
        _trackers.clear()
