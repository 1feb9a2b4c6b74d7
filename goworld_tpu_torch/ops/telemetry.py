"""Device telemetry lanes: per-tick histograms of the tick's health
signals, kept on the device, the port of ``goworld_tpu/ops/telemetry.py``.

The serving ``World`` folds every tick's outputs into a fixed-bucket
histogram accumulator that stays on the card, with no host sync, and
drains it inside the tick's one existing fetch. Lanes (per-tick signals
from :class:`~goworld_tpu_torch.core.step.TickOutputs`):

* ``tick_ms`` — the modeled per-tick latency ``base_ms + rebuilt *
  delta_ms`` on the live metrics ladder (:data:`metrics.DEFAULT_MS_BUCKETS`);
  the live World passes 0 for both, so every tick lands in bucket 0;
* ``sync_n`` / ``enter_n`` / ``leave_n`` — event volumes;
* ``over_k_rows`` / ``over_cap_cells`` — AOI saturation gauges;
* ``rebuilt`` — the Verlet rebuild bit;
* ``skin_slack`` — headroom before the next displacement rebuild, as a
  fraction of skin/2 (only where the skin is live);
* the megaspace comms lanes ``halo_demand`` / ``migrate_demand`` /
  ``migrate_dropped``, and the live path's per-shard ``occupancy``.

Bucketing is ``bisect_left`` on upper edges, as
:class:`goworld_tpu_torch.utils.metrics.Histogram` buckets, with a
+Inf tail; :func:`host_histogram` is its numpy recompute.

**The accumulator** (:func:`telemetry_init`) is the JAX package's dict
of lanes — one int32 count vector per lane, ``tick_ms_sum`` and, with
occupancy, ``occ_last`` — held as a :class:`TelemetryAcc`: the count
vectors are views of one int32 buffer, and the edges of every lane are
one float32 ``[rows, E]`` tensor padded with +inf (a value past a lane's
last edge lands in its +Inf bucket either way), made once at init. A
fold updates the accumulator IN PLACE: the signals are reduced on the
device (:func:`live_signals`, :func:`mega_signals`), concatenated into
one float32 vector, bucketed by one ``torch.searchsorted`` (float32,
``right=False``: ``jnp.searchsorted``'s ``side="left"``) and added by
one ``index_add_`` of ones (duplicate indices add). No ``.item()``, no
``.cpu()``, no ``nonzero``, no host-to-device copy.

**Bits.** The reference's jitted fold divides the slack by a constant
``half_skin``, which XLA rewrites into a multiply by the float32
reciprocal; the port multiplies by the same reciprocal. Volumes go from
int to float32 as the reference casts them (exact below 2^24).

:func:`workload_signature` folds drained lanes into the stable
signature record a governor consumes (this layer recommends; it does
not hot-swap).
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from goworld_tpu_torch.utils.metrics import DEFAULT_MS_BUCKETS

__all__ = [
    "TICK_MS_EDGES", "COUNT_EDGES", "SLACK_EDGES", "REBUILD_EDGES",
    "TelemetryAcc", "lane_edges", "telemetry_init", "telemetry_update",
    "telemetry_drain", "host_histogram", "TRACE_COUNTS", "make_fold",
    "mega_signals", "telemetry_update_mega",
    "live_signals", "telemetry_update_live",
    "lanes_delta", "workload_signature", "RECOMMENDATION_KEYS",
]

# Every [gameN] ini knob name a workload_signature recommendation can
# emit (the JAX package's contract: each is a GameConfig field).
RECOMMENDATION_KEYS = ("aoi_skin", "aoi_sort_impl", "aoi_cell_cap",
                       "aoi_k", "sync_delta")

# one ladder with the live metrics plane: a bench SLO and a serve-loop
# SLO bucket identically
TICK_MS_EDGES = tuple(DEFAULT_MS_BUCKETS)
# event volumes / saturation gauges: 0 and powers of 4 up past the caps
COUNT_EDGES = (0.0, 1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
               16384.0, 65536.0, 262144.0, 1048576.0)
# Verlet skin slack as a fraction of skin/2 (1.0 = untouched headroom)
SLACK_EDGES = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# the rebuild bit: buckets <=0 (reuse) and <=1 (rebuild)
REBUILD_EDGES = (0.0, 1.0)

_COUNT_LANES = ("sync_n", "enter_n", "leave_n", "over_k_rows",
                "over_cap_cells")
# megaspace comms-demand lanes (per-tick mesh maxima/sums)
_MEGA_LANES = ("halo_demand", "migrate_demand", "migrate_dropped")
# the order in which a fold's values meet the edge rows: the shared
# lanes, then the skin and megaspace lanes, then one occupancy row per
# tile (last, so a fold without occupancy takes a prefix of the rows)
_ROW_ORDER = ("tick_ms", "rebuilt") + _COUNT_LANES + ("skin_slack",) \
    + _MEGA_LANES

# calls of the live fold's builder (:func:`make_fold`); the JAX package
# counts traces of its jitted folds under the same keys, and
# "telemetry_update" counts its bench scan's, which is not ported
TRACE_COUNTS: dict = {"telemetry_update": 0, "telemetry_update_live": 0}


def lane_edges(skin_on: bool, mega: bool = False,
               occupancy: bool = False) -> dict[str, tuple]:
    """Static bucket edges per lane for a config (lane set depends only
    on whether the Verlet skin is live, plus the megaspace comms lanes
    when ``mega`` and the per-shard/per-tile ``occupancy`` lane carried
    by the live serving path)."""
    lanes = {"tick_ms": TICK_MS_EDGES, "rebuilt": REBUILD_EDGES}
    for nm in _COUNT_LANES:
        lanes[nm] = COUNT_EDGES
    if skin_on:
        lanes["skin_slack"] = SLACK_EDGES
    if mega:
        for nm in _MEGA_LANES:
            lanes[nm] = COUNT_EDGES
    if occupancy:
        lanes["occupancy"] = COUNT_EDGES
    return lanes


class TelemetryAcc(dict):
    """The accumulator: ``{lane: i32[len(edges)+1]}`` plus
    ``tick_ms_sum`` (f32 0-d) and, with occupancy, ``occ_last``
    (i32[n_tiles]), as the JAX package lays it out. The count vectors
    are views of :attr:`counts`; :attr:`bounds` holds each fold row's
    edges (padded with +inf), :attr:`offsets` each row's first bucket in
    :attr:`counts`, :attr:`ones` the scatter's addends. Folds write it
    in place."""

    __slots__ = ("counts", "bounds", "offsets", "ones")


def telemetry_init(skin_on: bool, mega: bool = False,
                   occupancy: bool = False, n_tiles: int = 1,
                   device="cuda") -> TelemetryAcc:
    """Zeroed accumulator on ``device`` (the card unless the caller asks
    for the CPU): one int32 count vector per lane (len(edges)+1, last =
    +Inf) plus the tick_ms running sum; with ``occupancy`` also
    ``occ_last``, the last tick's per-shard alive counts. The edges
    enter the device here, once."""
    from goworld_tpu_torch.core.state import resolve_device

    dev = resolve_device(device)
    lanes = lane_edges(skin_on, mega, occupancy)
    offset, starts = 0, {}
    for nm, e in lanes.items():
        starts[nm] = offset
        offset += len(e) + 1
    acc = TelemetryAcc()
    acc.counts = torch.zeros(offset, dtype=torch.int32, device=dev)
    for nm, e in lanes.items():
        acc[nm] = acc.counts[starts[nm]:starts[nm] + len(e) + 1]
    acc["tick_ms_sum"] = torch.zeros((), dtype=torch.float32, device=dev)
    if occupancy:
        acc["occ_last"] = torch.zeros(n_tiles, dtype=torch.int32,
                                      device=dev)
    rows = [nm for nm in _ROW_ORDER if nm in lanes]
    if occupancy:
        rows += ["occupancy"] * n_tiles
    width = max(len(e) for e in lanes.values())
    bounds = np.full((len(rows), width), np.inf, np.float32)
    for r, nm in enumerate(rows):
        bounds[r, :len(lanes[nm])] = lanes[nm]
    acc.bounds = torch.from_numpy(bounds).to(dev)
    acc.offsets = torch.tensor([starts[nm] for nm in rows],
                               dtype=torch.int64, device=dev)
    acc.ones = torch.ones(len(rows), dtype=torch.int32, device=dev)
    return acc


def telemetry_clone(acc: TelemetryAcc) -> TelemetryAcc:
    """A copy of ``acc`` whose counts, running sum and ``occ_last`` are
    fresh device tensors (one clone each; the edges, offsets and addends
    shared, since no fold writes them): a fold into the copy leaves
    ``acc`` as it was."""
    out = TelemetryAcc()
    out.counts = acc.counts.clone()
    base = acc.counts.data_ptr()
    size = acc.counts.element_size()
    for nm, v in acc.items():
        if nm in ("tick_ms_sum", "occ_last"):
            out[nm] = v.clone()
        else:
            off = (v.data_ptr() - base) // size
            out[nm] = out.counts[off:off + v.numel()]
    out.bounds, out.offsets, out.ones = acc.bounds, acc.offsets, acc.ones
    return out


def _bucket_add_vec(acc_vec, edges, values):
    """Add one sample to ``acc_vec`` for every element of ``values``
    (``edges`` a float32 tensor of upper edges; duplicates add)."""
    i = torch.searchsorted(edges, values.to(torch.float32).reshape(-1))
    acc_vec.index_add_(0, i, torch.ones_like(i, dtype=acc_vec.dtype))
    return acc_vec


def _bucket_add(acc_vec, edges, value):
    """One sample of a scalar ``value``: :func:`_bucket_add_vec` of one
    element (a fold buckets all its rows in one such call)."""
    return _bucket_add_vec(acc_vec, edges, value)


def _fold_rows(acc: TelemetryAcc, tick_ms, values: list) -> None:
    """Bucket ``values`` (device tensors, in :data:`_ROW_ORDER` order,
    occupancy last) into ``acc`` in place, and add ``tick_ms`` (f32,
    one element) to the running sum."""
    v = torch.cat([x.reshape(-1) for x in values]).to(torch.float32)
    n = v.shape[0]
    i = torch.searchsorted(acc.bounds[:n], v.unsqueeze(1)).reshape(-1)
    acc.counts.index_add_(0, i + acc.offsets[:n], acc.ones[:n])
    acc["tick_ms_sum"].add_(tick_ms.reshape(()))


def _signal_values(acc, sig, base_ms: float, delta_ms: float,
                   half_skin: float) -> tuple:
    """(tick_ms, the shared lanes' values in row order) of one tick's
    reduced signals ``sig``."""
    rebuilt = sig.aoi_rebuilt
    if rebuilt is None:
        rebuilt = torch.ones((), dtype=torch.int32,
                             device=sig.sync_n.device)
    r = rebuilt.to(torch.float32)
    # python floats of float32 values: the ops round as the jitted
    # reference's float32 constants do
    tick_ms = r * float(np.float32(delta_ms)) + float(np.float32(base_ms))
    values = [tick_ms, r, sig.sync_n, sig.enter_n, sig.leave_n,
              sig.aoi_over_k_rows, sig.aoi_over_cap_cells]
    if "skin_slack" in acc:
        slack = sig.aoi_skin_slack
        if slack is None:
            slack = torch.zeros((), dtype=torch.float32,
                                device=sig.sync_n.device)
        if half_skin > 0:
            # XLA folds the reference's divide by the constant into a
            # multiply by its float32 reciprocal
            slack = slack * float(np.float32(1.0)
                                  / np.float32(half_skin))
        values.append(slack)
    return tick_ms, values


def telemetry_update(acc, out, base_ms: float, delta_ms: float,
                     half_skin: float = 0.0):
    """Fold one tick's reduced signals (a :class:`TickOutputs` of one
    Space, or :func:`live_signals`) into the accumulator, in place.
    ``base_ms``/``delta_ms`` are the host-measured tick-cost model
    constants and ``half_skin`` (= skin/2) normalizes the slack.
    Returns ``acc``."""
    tick_ms, values = _signal_values(acc, out, base_ms, delta_ms,
                                     half_skin)
    _fold_rows(acc, tick_ms, values)
    return acc


def mega_signals(mouts):
    """Reduce one tick's :class:`MegaTickOutputs` (leading [n_dev]
    lanes) to the scalar per-mesh signals the lanes histogram: event
    volumes SUM across tiles, saturation/demand gauges take the MAX."""
    b = mouts.base
    return types.SimpleNamespace(
        sync_n=b.sync_n.sum(),
        enter_n=b.enter_n.sum(),
        leave_n=b.leave_n.sum(),
        aoi_over_k_rows=b.aoi_over_k_rows.max(),
        aoi_over_cap_cells=b.aoi_over_cap_cells.max(),
        aoi_rebuilt=None,  # the megaspace is skinless: rebuilt is 1
        aoi_skin_slack=None,
        halo_demand=mouts.halo_demand.max(),
        migrate_demand=mouts.migrate_demand.max(),
        migrate_dropped=mouts.migrate_dropped.sum(),
    )


def _mega_values(acc, mouts, base_ms: float) -> tuple:
    sig = mega_signals(mouts)
    tick_ms, values = _signal_values(acc, sig, base_ms, 0.0, 0.0)
    return tick_ms, values + [getattr(sig, nm) for nm in _MEGA_LANES]


def telemetry_update_mega(acc, mouts, base_ms: float):
    """Fold one megaspace tick's outputs into the accumulator, in
    place: the shared lanes on the mesh-reduced signals plus the comms
    lanes (halo/migrate demand, dropped arrivals). Returns ``acc``."""
    tick_ms, values = _mega_values(acc, mouts, base_ms)
    _fold_rows(acc, tick_ms, values)
    return acc


def live_signals(base):
    """Reduce one tick's :class:`TickOutputs` with a leading [S] shard
    axis to the scalar signals the lanes histogram — volumes SUM across
    shards, saturation gauges take the shard MAX, the rebuild bit is
    "any shard rebuilt" and the slack is the worst headroom."""
    rebuilt = base.aoi_rebuilt
    slack = base.aoi_skin_slack
    return types.SimpleNamespace(
        sync_n=base.sync_n.sum(),
        enter_n=base.enter_n.sum(),
        leave_n=base.leave_n.sum(),
        aoi_over_k_rows=base.aoi_over_k_rows.max(),
        aoi_over_cap_cells=base.aoi_over_cap_cells.max(),
        aoi_rebuilt=None if rebuilt is None else rebuilt.max(),
        aoi_skin_slack=None if slack is None else slack.min(),
    )


def telemetry_update_live(acc, outs, *, mega: bool = False,
                          base_ms: float = 0.0, delta_ms: float = 0.0,
                          half_skin: float = 0.0):
    """Fold one serving tick's device outputs into the live
    accumulator, in place, in one bucketing and one scatter: ``outs``
    is the World's step output (TickOutputs with a leading [S] axis) or
    MegaTickOutputs when ``mega``. Adds the per-shard ``occupancy``
    lane from ``alive_count`` (one sample per shard) and tracks
    ``occ_last``. Returns ``acc``."""
    base = getattr(outs, "base", outs)
    if mega:
        tick_ms, values = _mega_values(acc, outs, base_ms)
    else:
        tick_ms, values = _signal_values(acc, live_signals(base),
                                         base_ms, delta_ms, half_skin)
    if "occupancy" in acc:
        occ = base.alive_count
        values.append(occ)
        acc["occ_last"].copy_(occ.reshape(acc["occ_last"].shape))
    _fold_rows(acc, tick_ms, values)
    return acc


def make_fold(*, mega: bool = False, base_ms: float = 0.0,
              delta_ms: float = 0.0, half_skin: float = 0.0):
    """The live fold a World runs every tick, ``fold(acc, outs) ->
    acc``, with its constants bound (the port's counterpart of the
    reference's jitted fold; nothing is compiled). Counts one call of
    this builder in :data:`TRACE_COUNTS`."""
    TRACE_COUNTS["telemetry_update_live"] += 1

    def fold(acc, outs):
        return telemetry_update_live(
            acc, outs, mega=mega, base_ms=base_ms, delta_ms=delta_ms,
            half_skin=half_skin)

    return fold


def telemetry_drain(acc, skin_on: bool, half_skin: float = 0.0,
                    mega: bool = False) -> dict:
    """The lanes as ``{lane: {"edges": [...], "counts": [...]}}`` plus
    the tick_ms mean, from a host copy of the accumulator (the live
    World's rides the tick's one fetch) or from device tensors (copied
    here). ``half_skin`` documents the skin_slack lane's unit. An
    ``occupancy`` accumulator also exports ``per_tile`` — the last
    tick's per-shard alive counts."""
    fetched = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v) for k, v in acc.items()}
    out: dict = {}
    for nm, edges in lane_edges(skin_on, mega,
                                occupancy="occupancy" in fetched).items():
        out[nm] = {
            "edges": [float(e) for e in edges],
            "counts": [int(c) for c in fetched[nm]],
        }
    if skin_on and half_skin > 0:
        out["skin_slack"]["unit"] = f"fraction of skin/2 ({half_skin:g})"
    if "occ_last" in fetched:
        out["occupancy"]["per_tile"] = [
            int(c) for c in fetched["occ_last"]
        ]
    n = sum(out["tick_ms"]["counts"])
    if n:
        out["tick_ms"]["mean_ms"] = round(
            float(fetched["tick_ms_sum"]) / n, 3)
    return out


def host_histogram(values, edges) -> np.ndarray:
    """Numpy recompute of the device bucketing (bisect_left on upper
    edges, +Inf tail) — the parity oracle for the accumulator."""
    edges = np.asarray(edges, np.float32)
    counts = np.zeros(len(edges) + 1, np.int64)
    for v in np.asarray(values, np.float32).ravel():
        counts[int(np.searchsorted(edges, v, side="left"))] += 1
    return counts


# =======================================================================
# workload signature (host only; the reducer a governor consumes)
# =======================================================================
def lanes_delta(cur: dict, prev: dict | None) -> dict:
    """Drained-lane WINDOW delta: per-lane ``cur.counts - prev.counts``
    (the lanes are cumulative; the signature wants the recent window,
    not process-lifetime averages). ``prev=None`` returns ``cur``
    as-is. Point-in-time extras (``per_tile``) come from ``cur``."""
    if prev is None:
        return cur
    out: dict = {}
    for nm, lane in cur.items():
        if not isinstance(lane, dict) or "counts" not in lane:
            out[nm] = lane
            continue
        d = dict(lane)
        pl = prev.get(nm)
        if isinstance(pl, dict) and len(pl.get("counts", ())) == \
                len(lane["counts"]):
            d["counts"] = [max(int(a) - int(b), 0) for a, b in
                           zip(lane["counts"], pl["counts"])]
        out[nm] = d
    return out


def _lane_frac_nonzero(lane: dict) -> float:
    """Fraction of samples above the first (<= 0) bucket."""
    total = sum(lane["counts"])
    if total <= 0:
        return 0.0
    return 1.0 - lane["counts"][0] / total


def _lane_q(lane: dict, q: float) -> float:
    from goworld_tpu_torch.utils.devprof import hist_quantile

    return hist_quantile(lane["edges"], lane["counts"], q)


# event-volume ladder (p90 of per-tick enter+leave demand, bucket
# upper bounds on COUNT_EDGES)
_EVENT_CLASSES = ((1.0, "quiet"), (64.0, "low"), (4096.0, "moderate"))
# per-tile occupancy skew (max/mean) thresholds for the mesh classes
_SKEW_CLASSES = ((1.5, "balanced"), (3.0, "skewed"))


def workload_signature(lanes: dict, config: dict | None = None) -> dict:
    """Fold drained (window-delta) telemetry lanes into the stable
    workload-signature record:

    * ``churn`` — ``flock_like`` (the Verlet cache holds: rebuild rate
      < 0.5) vs ``teleport_like`` (the skin is defeated) vs
      ``skinless`` (no skin lane: every tick rebuilds by construction);
    * ``density`` — ``exact`` / ``over_k`` / ``over_cap`` (the loudest
      degradation wins);
    * ``events`` — quiet/low/moderate/heavy by p90 per-tick
      enter+leave demand;
    * ``skew`` — per-tile occupancy max/mean for multi-shard worlds.

    ``recommendation`` maps the classes onto the ``[gameN]`` kernel
    knobs — a recommendation line, not a hot swap. Returns
    ``{"error": ...}`` when the lanes carry no samples."""
    if not isinstance(lanes, dict) or "rebuilt" not in lanes:
        return {"error": "no telemetry lanes"}
    ticks = sum(lanes["rebuilt"]["counts"])
    if ticks <= 0:
        return {"error": "no samples in window"}
    out: dict = {"ticks": int(ticks)}

    # churn: rebuild duty cycle + skin headroom
    rebuild_rate = _lane_frac_nonzero(lanes["rebuilt"])
    out["rebuild_rate"] = round(rebuild_rate, 4)
    if "skin_slack" in lanes and sum(lanes["skin_slack"]["counts"]):
        slack_p50 = _lane_q(lanes["skin_slack"], 0.5)
        # non-finite quantiles stamp as None (JSON has no Infinity)
        out["skin_slack_p50"] = round(slack_p50, 4) \
            if math.isfinite(slack_p50) else None
        out["churn"] = ("flock_like" if rebuild_rate < 0.5
                        else "teleport_like")
    else:
        out["churn"] = "skinless"

    # density: overflow-gauge duty cycles
    over_k = _lane_frac_nonzero(lanes.get("over_k_rows",
                                          {"counts": [ticks]}))
    over_cap = _lane_frac_nonzero(lanes.get("over_cap_cells",
                                            {"counts": [ticks]}))
    out["over_k_frac"] = round(over_k, 4)
    out["over_cap_frac"] = round(over_cap, 4)
    out["density"] = ("over_cap" if over_cap > 0
                      else "over_k" if over_k > 0 else "exact")

    # event volume: p90 of per-tick interest-migration demand
    ev = None
    if "enter_n" in lanes and sum(lanes["enter_n"]["counts"]):
        ev = _lane_q(lanes["enter_n"], 0.9) \
            + _lane_q(lanes["leave_n"], 0.9)
        out["enter_leave_p90"] = round(ev, 1) if math.isfinite(ev) \
            else None
    out["events"] = "heavy"
    for bound, cls in _EVENT_CLASSES:
        if ev is not None and ev <= 2 * bound:
            out["events"] = cls
            break
    if ev is None:
        out["events"] = "quiet"
    if "sync_n" in lanes and sum(lanes["sync_n"]["counts"]):
        p50 = _lane_q(lanes["sync_n"], 0.5)
        out["sync_p50"] = round(p50, 1) if math.isfinite(p50) else None

    # per-tile skew (multi-shard/mesh worlds; the re-tiling trigger)
    occ = (lanes.get("occupancy") or {}).get("per_tile")
    if occ and len(occ) > 1 and sum(occ) > 0:
        mean = sum(occ) / len(occ)
        skew = max(occ) / mean if mean > 0 else 1.0
        out["tiles"] = len(occ)
        out["occupancy_per_tile"] = [int(c) for c in occ]
        out["tile_skew"] = round(skew, 3)
        out["skew"] = "hotspot"
        for bound, cls in _SKEW_CLASSES:
            if skew <= bound:
                out["skew"] = cls
                break

    # the [gameN] kernel-config recommendation (ini knob names; "keep"
    # = no change advised)
    rec: dict = {}
    if out["churn"] == "teleport_like":
        rec["aoi_skin"] = 0
    elif out["churn"] == "flock_like":
        rec["aoi_skin"] = "keep"
    rec["aoi_sort_impl"] = ("counting" if out["density"] != "exact"
                            else "keep")
    if out["density"] == "over_cap":
        rec["aoi_cell_cap"] = "raise"
    if out["density"] in ("over_k", "over_cap") and over_k > 0:
        rec["aoi_k"] = "raise"
    # delta-compressed sync fan-out pays off where the dirty fraction
    # is low: quiet worlds and flock-like motion (gated on the sync
    # lane's p50 when it exists)
    low_dirty = True
    if out.get("sync_p50") is not None:
        low_dirty = out["sync_p50"] <= 64.0
    if low_dirty and out["churn"] != "teleport_like" \
            and (out["churn"] == "flock_like"
                 or out["events"] == "quiet"):
        # teleport-like churn excluded: every jump overflows the int16
        # delta range, so the stream would be all keyframes anyway
        rec["sync_delta"] = 1
    out["recommendation"] = rec

    parts = [f"churn={out['churn']}", f"density={out['density']}",
             f"events={out['events']}"]
    if "skew" in out:
        parts.append(f"skew={out['skew']}")
    out["sig"] = "|".join(parts)
    if config:
        out["config"] = dict(config)
    return out
