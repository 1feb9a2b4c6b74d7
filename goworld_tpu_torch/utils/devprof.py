"""Device-plane observability, the port of ``goworld_tpu/utils/devprof.py``.

* :class:`CostReport` / :func:`cost_report` — the step's cost report with
  the reference's fields and config key. The reference lowers an XLA
  executable and reads its cost and memory analysis; a torch step has
  neither, so the port's report is built from its own counts, from
  shapes alone (no device sync): the bytes and operations of the stages
  the hand-written kernels compute (:func:`step_stage_costs`, counted
  as ``chip_smoke.py`` counts them for its bounds, but at the candidate
  window's capacity where the script counts the run's data), the
  roofline hand model's bytes for the whole step, and the byte sums of
  the state, inputs and outputs for the memory fields.
* :func:`roofline_model_bytes` — the reference's hand model (its
  ``docs/ROOFLINE.md``), copied as it is; :func:`roofline_audit` prices
  it at the H100's HBM rate (:data:`H100_HBM_GBPS`).
* :func:`grid_config_key` — the resolved kernel stamps of a GridSpec,
  the key every report and workload signature is stamped with.
* The SLO plane — :func:`hist_quantile` / :func:`hist_quantile_interp`
  / :func:`slo_from_histogram` turn a fixed-bucket histogram (the
  telemetry lanes of :mod:`goworld_tpu_torch.ops.telemetry`, or the live
  ``tick_latency_ms`` metric) into a {target_ms, p50/p90/p99, pass}
  verdict.
* A process-local registry of cost reports, lazy report providers and
  the last SLO verdict (the ``/costs`` payload of the debug endpoints,
  which are not ported yet).

The multichip models (``roofline_*_multichip``) wait for the World on a
mesh (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable

__all__ = [
    "CostReport", "cost_report", "step_stage_costs", "output_bytes",
    "roofline_model_bytes", "roofline_audit", "H100_HBM_GBPS",
    "artifact_headline",
    "grid_config_key", "hist_quantile", "hist_quantile_interp",
    "slo_from_histogram", "register_report", "register_provider",
    "record_slo", "snapshot", "set_slo_target", "reset",
    "DEFAULT_SLO_TARGET_MS",
]

# the paper's AOI-sync latency target (p99 < 16 ms at the 1M/60 Hz
# headline shape) — the default SLO budget everywhere
DEFAULT_SLO_TARGET_MS = 16.0

# one NVIDIA H100 SXM's HBM rate (NVIDIA's data sheet), the rate the
# roofline model is priced at here
H100_HBM_GBPS = 3350.0


def grid_config_key(grid) -> dict:
    """Resolved kernel stamps for a GridSpec — the per-config key every
    cost report and workload signature shares."""
    return {
        "sweep_impl": grid.sweep_impl,
        "topk_impl": grid.topk_impl,
        "sort_impl": grid.sort_impl,
        "skin": grid.skin,
        "k": grid.k,
        "cell_cap": grid.cell_cap,
        "precision": getattr(grid, "precision", "off"),
    }


def artifact_headline(doc: dict) -> dict | None:
    """The stamped artifact record of one BENCH_r*.json (driver
    ``{"parsed": ...}`` wrapper or bare), or None when the round
    recorded no usable headline."""
    rec = doc.get("parsed") if "parsed" in doc else doc
    if not isinstance(rec, dict) or not rec.get("value"):
        return None
    return rec


# =======================================================================
# CostReport: the step's cost report
# =======================================================================
@dataclasses.dataclass
class CostReport:
    """The cost and memory report of one step, with the reference's
    fields. In the port: ``flops`` sums the operations of the step's
    kernel stages at their shapes (:func:`step_stage_costs`),
    ``bytes_accessed`` is the
    roofline hand model's bytes for the whole step (its ``aoi``,
    ``move`` and ``collect`` phases, every Space), ``output_bytes`` and
    ``output_size`` the outputs' bytes plus the carry's,
    ``argument_size`` the state's, the inputs' and the policy's,
    ``alias_size``/``donation_applied`` the carry's bytes when the
    World keeps it resident (written into its own storage), and
    ``peak_hbm_bytes`` arguments plus outputs less the aliased carry (a
    floor: the step's temporaries are not counted, ``temp_size`` None).
    ``config`` carries the resolved kernel stamps."""

    name: str
    flops: float | None = None
    bytes_accessed: float | None = None
    output_bytes: float | None = None
    argument_size: int | None = None
    output_size: int | None = None
    temp_size: int | None = None
    peak_hbm_bytes: int | None = None
    generated_code_size: int | None = None
    alias_size: int | None = None
    donation_applied: int | None = None
    donation_reclaimable: int | None = None
    n: int | None = None
    n_devices: int | None = None
    platform: str | None = None
    config: dict | None = None
    error: str | None = None

    @property
    def key(self) -> str:
        """Compact per-config key (autotune-log style)."""
        cfg = self.config or {}
        return ",".join(f"{k}={cfg[k]}" for k in sorted(cfg)) or "default"

    def as_dict(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}
        d["key"] = self.key
        return d


def _nbytes(obj) -> int:
    """Bytes of every tensor lane of a dataclass of lanes (nested
    dataclasses included); metadata only, no device read."""
    if obj is None:
        return 0
    total = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            total += _nbytes(v)
        else:
            total += v.numel() * v.element_size()
    return total


def output_bytes(cfg, n_spaces: int = 1) -> int:
    """Bytes of one step's outputs (``core.step.TickOutputs``) from the
    config's caps: the event lists, sync and attr records, their counts
    and the nine 0-d gauges, each Space's."""
    ec, lc = cfg.enter_cap, cfg.leave_cap
    sc, ac = cfg.sync_cap, cfg.attr_sync_cap
    per = 4 * (2 * ec + 2 * lc + 2 * sc + 4 * sc + 3 * ac) + 4 * 12
    return per * n_spaces


def step_stage_costs(cfg, n_spaces: int = 1,
                     hidden: int | None = None) -> dict[str, tuple]:
    """(bytes, operations) of the step's stages that hand-written
    kernels compute on the card, at their shapes, whichever impl the
    config picks (the function's work, counted as ``chip_smoke.py``
    counts each kernel's): the AOI back half (each input read and each
    output written once, its window read at capacity: 14 operations a
    candidate lane and ``k log2 k`` compares a row; at the Verlet
    rebuild's k with a skin), the cell sort (``12 n`` bytes, 12
    operations an element a radix pass) and, with a policy of
    ``hidden`` units, the policy's forward pass."""
    from goworld_tpu_torch.ops.sort import radix_plan

    g = cfg.grid
    n = cfg.capacity * n_spaces
    cc = g.cell_cap
    k = g.verlet_cap_eff if g.skin > 0 else g.k
    nbytes = (12 * (n + 3 * cc * n_spaces) + 24 * n + 12 * n + 4 * n
              + 4 * k * n + 4 * n)
    out = {"aoi_sweep": (float(nbytes),
                         float(14 * 9 * cc * n
                               + n * k * math.log2(max(k, 2))))}
    n_rows = (g.cells_x + 2) * (g.cells_z + 2)
    passes = radix_plan((n_spaces * (n_rows + 1) - 1).bit_length())[0]
    out["aoi_sort"] = (float(12 * n), float(passes * 12 * n))
    if hidden:
        h = hidden
        out["npc_mlp"] = (float(n * 13 * 4 + 2 * (10 * h + h + h * h + h
                                                   + 3 * h + 3)),
                          float(2 * (10 * h + h * h + 3 * h) * n))
    return out


def cost_report(cfg, n_spaces: int, state, *, policy=None,
                resident: bool = True, name: str = "tick",
                config: dict | None = None,
                n: int | None = None,
                migrate_cap: int | None = None) -> CostReport:
    """The :class:`CostReport` of the step of ``cfg`` over ``state``
    (stacked ``[n_spaces, ...]`` lanes) with ``policy``, from shapes
    alone: nothing here reads the device or waits for it. A mesh or
    megaspace step (``migrate_cap`` given) also takes the migration
    requests (two i32 lanes a slot) and gives the arrival records (two
    i32 lanes of ``n_spaces * migrate_cap`` a shard, and four counts a
    shard). Failures are folded into ``report.error`` instead of
    raising — a cost audit must never kill a measurement run."""
    rep = CostReport(name=name, config=config, n=n)
    try:
        rep.platform = "gpu" if state.pos.device.type == "cuda" else "cpu"
        hidden = policy.w1.shape[1] if policy is not None else None
        kern = step_stage_costs(cfg, n_spaces, hidden)
        rep.flops = float(sum(o for _, o in kern.values()))
        model = roofline_model_bytes(cfg.capacity, _grid_kw(cfg.grid))
        rep.bytes_accessed = n_spaces * (model["aoi"] + model["move"]
                                         + model["collect"])
        carry = _nbytes(state)
        ic = cfg.input_cap
        inputs = n_spaces * (4 * ic + 16 * ic + 4)
        pol = sum(getattr(policy, f).numel() * 2
                  for f in ("w1", "b1", "w2", "b2", "w3", "b3")) \
            if policy is not None else 0
        outs = output_bytes(cfg, n_spaces)
        if migrate_cap is not None:
            inputs += n_spaces * 8 * cfg.capacity
            outs += n_spaces * (8 * n_spaces * migrate_cap
                                + 4 * (3 + n_spaces))
        rep.argument_size = carry + inputs + pol
        rep.output_size = carry + outs
        rep.output_bytes = float(rep.output_size)
        rep.alias_size = rep.donation_applied = carry if resident else 0
        rep.donation_reclaimable = max(
            0, min(rep.argument_size, rep.output_size) - rep.alias_size)
        rep.peak_hbm_bytes = (rep.argument_size + rep.output_size
                              - rep.alias_size)
    except Exception as exc:
        rep.error = f"cost model: {str(exc)[:200]}"
    return rep


def _grid_kw(grid) -> dict:
    return dict(k=grid.k, cell_cap=grid.cell_cap, sort_impl=grid.sort_impl,
                sweep_impl=grid.sweep_impl, skin=grid.skin,
                verlet_cap=grid.verlet_cap, precision=grid.precision,
                radius=grid.radius, extent_x=grid.extent_x,
                extent_z=grid.extent_z)


# =======================================================================
# roofline hand model (the reference's docs/ROOFLINE.md), copied
# =======================================================================
def _padded_cells(grid_kw: dict) -> int:
    """(cols+2) * (rows+2) padded grid rows, the table-build term."""
    radius = float(grid_kw.get("radius", 50.0))
    ex = float(grid_kw.get("extent_x", 1024.0))
    ez = float(grid_kw.get("extent_z", ex))
    cols = max(1, int(math.ceil(ex / radius)))
    rows = max(1, int(math.ceil(ez / radius)))
    return (cols + 2) * (rows + 2)


def roofline_model_bytes(n: int, grid_kw: dict) -> dict[str, float]:
    """Per-phase HBM bytes/tick of the hand model (docs/ROOFLINE.md
    table), keyed by the bench phase-probe names. ``grid_kw`` needs
    k, cell_cap, sort_impl, sweep_impl, skin (+ radius/extent for the
    table term); missing knobs take the documented bench defaults.

    These are the MODEL's coefficients — the whole point of the audit
    is that XLA's own accounting (cost_analysis) is diffed against
    them, so keep changes here in lockstep with docs/ROOFLINE.md."""
    k = int(grid_kw.get("k", 32))
    cc = int(grid_kw.get("cell_cap", 12))
    sort_impl = grid_kw.get("sort_impl", "argsort")
    sweep = grid_kw.get("sweep_impl", "ranges")
    skin = float(grid_kw.get("skin", 0.0))
    vcap = int(grid_kw.get("verlet_cap", 0)) or (k + k // 2)
    # quantized state planes (precision=q16, ISSUE 12): the per-term
    # narrowings below mirror exactly what ops/aoi.py ships — the
    # packed 2-lane "ranges" sorted view, the packed-qxz reuse gather,
    # the 21-bit-triplet cand cache, bf16 velocity, and the
    # deadbanded-dirty delta prefilter. Keep in lockstep with
    # docs/ROOFLINE.md "Quantized state planes".
    q16 = grid_kw.get("precision", "off") != "off"
    cells = _padded_cells(grid_kw)
    win = 9 * cc                      # candidate-window lanes per query

    out: dict[str, float] = {}
    out["cell_ids"] = 12.0 * n        # read pos x/z + write rows
    if sort_impl in ("counting", "pallas"):
        # two-pass counting sort: histogram + cumsum + stable scatter
        out["aoi_sort"] = 28.0 * n + 8.0 * cells
    else:
        # bitonic network: ~0.5 log^2(n) compare-exchange passes over
        # keys+payload (16 B/element/pass)
        out["aoi_sort"] = 0.5 * max(1.0, math.log2(max(n, 2))) ** 2 \
            * 16.0 * n
    if sweep in ("table", "cellrow", "shift"):
        # dense per-cell table init + 3x scatter in/out
        out["aoi_build"] = 4.0 * (3 * cc) * cells + 24.0 * n
    elif sweep == "ranges" and q16:
        # packed 2-lane sorted view ((qx,qz) pair + word = 8 B/row)
        out["aoi_build"] = 8.0 * n
    else:
        # tableless ranges/fused front half: sorted [n, 3] view write
        out["aoi_build"] = 12.0 * n
    if sweep == "fused":
        # the whole back half is ONE VMEM-resident kernel: sorted view
        # streamed once + query scalars in, ranked keys + demand out —
        # the [n, 108] window and packed keys never round-trip HBM
        # (under q16 the fused kernel keeps its f32 view — its window
        # already never touches HBM, so there is nothing left to
        # narrow)
        out["aoi_gather"] = 12.0 * n + 44.0 * n
        out["aoi_pack"] = 0.0
        out["aoi_rank"] = 4.0 * k * n + 4.0 * n
    elif sweep == "ranges" and q16:
        # 3 dynamic-slices of (2, 3*cell_cap) lanes per query — the
        # position pair rides ONE i32 lane instead of two f32 lanes
        out["aoi_gather"] = 3 * 2 * (3 * cc) * 4.0 * n
        out["aoi_pack"] = 2 * 4.0 * win * n
        out["aoi_rank"] = 4.0 * win * n + 4.0 * k * n
    else:
        # 3 dynamic-slices of (3, 3*cell_cap) f32 per query
        out["aoi_gather"] = 3 * 3 * (3 * cc) * 4.0 * n
        out["aoi_pack"] = 2 * 4.0 * win * n     # packed keys w + r
        out["aoi_rank"] = 4.0 * win * n + 4.0 * k * n
    if skin > 0:
        # Verlet reuse tick (the steady state the cache-carried probe
        # measures): candidate ids + positions + flags re-gathers plus
        # the shared ranking — front half + window fetch amortize to
        # ~1/cadence duty (cadence is workload speed, not modeled here)
        if q16:
            # 21-bit-packed cand rows (2*ceil(V/3) u32 words) + ONE
            # packed-qxz i32 gather per lane + ranked [n, k] out
            cand_words = 2 * ((vcap + 2) // 3)
            out["aoi_reuse"] = (4.0 * cand_words + 4.0 * vcap
                                + 4.0 * k) * n
        else:
            out["aoi_reuse"] = (3 * 4.0 * vcap + 4.0 * k) * n
        out["aoi_rebuild"] = (out["cell_ids"] + out["aoi_sort"]
                              + out["aoi_build"] + out["aoi_gather"]
                              + out["aoi_pack"] + out["aoi_rank"])
        out["aoi"] = out["aoi_reuse"]   # reuse-dominated steady state
    else:
        out["aoi"] = (out["cell_ids"] + out["aoi_sort"]
                      + out["aoi_build"] + out["aoi_gather"]
                      + out["aoi_pack"] + out["aoi_rank"])
    if q16:
        # pos r/w 24 + prev re-snap read 12 (the deadband compare) +
        # bf16 velocity streams 24 (half of f32's 48) + qxz mirror 4
        out["move"] = 64.0 * n
        # interest delta streams prev+new ONCE each (8k): the changed-
        # row prefilter rides the deadbanded quantized dirty lanes the
        # sweep already delivers, and the k^2 membership compare only
        # gathers the bounded changed-row set (ops/delta two_tier);
        # sync/attr masks + cap-scale value gathers ~= 24 B/row
        out["collect"] = 8.0 * k * n + 24.0 * n
    else:
        out["move"] = 96.0 * n        # pos/vel/yaw streams x ~4
        # interest delta (prev/new nbr reads x2) + sync/attr collection
        out["collect"] = 16.0 * k * n + (4.0 * k + 64.0) * n
    return out


def roofline_audit(phase_ms: dict, phase_costs: dict, n: int,
                   grid_kw: dict, platform: str | None = None,
                   bandwidth_gbps: float = H100_HBM_GBPS) -> dict:
    """The ``roofline_audit`` block: per-phase modeled vs measured bytes
    (the reference's block, priced at ``bandwidth_gbps``, the H100's HBM
    rate by default, where the reference prices the TPU v5e's).

    ``phase_ms`` is the measured per-phase ms; ``phase_costs`` maps
    phase name -> :class:`CostReport` (or its dict) for the SAME probe.
    ``drift_pct`` compares the report's bytes to the hand model;
    ``model_ms`` is the model's bandwidth-roofline projection."""
    model = roofline_model_bytes(n, grid_kw)
    phases: dict[str, dict] = {}
    tot_model = tot_meas = 0.0
    covered: list[str] = []
    for name, mbytes in model.items():
        row: dict[str, Any] = {"model_mb": round(mbytes / 1e6, 3)}
        row["model_ms"] = round(mbytes / (bandwidth_gbps * 1e6), 4)
        cr = phase_costs.get(name)
        if cr is not None:
            crd = cr.as_dict() if isinstance(cr, CostReport) else cr
            xb = crd.get("bytes_accessed")
            if xb is not None:
                row["cost_mb"] = round(xb / 1e6, 3)
                if mbytes > 0:
                    row["drift_pct"] = round(
                        (xb - mbytes) / mbytes * 100.0, 1)
            if crd.get("flops") is not None:
                row["cost_gflops"] = round(crd["flops"] / 1e9, 4)
            if crd.get("error"):
                row["cost_error"] = crd["error"]
        if name in phase_ms:
            row["measured_ms"] = phase_ms[name]
        phases[name] = row
        if name in ("aoi", "move", "collect"):  # non-overlapping total
            tot_model += mbytes
            if "cost_mb" in row:
                covered.append(name)
                tot_meas += row["cost_mb"] * 1e6
    out = {
        "doc": "the reference's docs/ROOFLINE.md",
        "n": n,
        "bandwidth_gbps": bandwidth_gbps,
        "platform": platform,
        "phases": phases,
        "total_model_mb": round(tot_model / 1e6, 3),
    }
    if len(covered) == 3:
        out["total_cost_mb"] = round(tot_meas / 1e6, 3)
        out["total_drift_pct"] = round(
            (tot_meas - tot_model) / tot_model * 100.0, 1)
    elif covered:
        out["cost_coverage_partial"] = sorted(covered)
    return out


# =======================================================================
# histogram quantiles + SLO verdicts
# =======================================================================
def hist_quantile(edges, counts, q: float) -> float:
    """Quantile from a fixed-bucket histogram: the UPPER edge of the
    bucket containing the q-th sample (conservative — the true value is
    <= the reported one). ``counts`` has len(edges)+1 entries (the last
    is the +Inf bucket, reported as ``inf``). NaN on an empty
    histogram."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            if i < len(edges):
                return float(edges[i])
            return float("inf")
    return float("inf")


def hist_quantile_interp(edges, counts, q: float) -> float:
    """Quantile with LINEAR INTERPOLATION inside the containing bucket
    (the Prometheus histogram_quantile estimator): continuous as mass
    shifts between buckets, so two quantiles compare. Still ``inf``
    when the q-th sample sits in the +Inf bucket, NaN on an empty
    histogram."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank:
            if i >= len(edges):
                return float("inf")
            lo = float(edges[i - 1]) if i > 0 else 0.0
            hi = float(edges[i])
            if c <= 0:
                return hi
            return lo + (hi - lo) * (rank - prev_cum) / c
    return float("inf")


def slo_from_histogram(edges, counts, target_ms: float | None = None,
                       source: str = "histogram") -> dict:
    """{target_ms, p50/p90/p99_ms, samples, pass} from a fixed-bucket
    latency histogram. ``pass`` is conservative: percentiles are bucket
    upper bounds, so a pass means the true p99 is under target too.
    Non-finite percentiles are stamped as None with ``"overflow":
    true`` (JSON has no Infinity); either way the verdict is a fail."""
    if target_ms is None:
        target_ms = DEFAULT_SLO_TARGET_MS
    total = int(sum(counts))
    p50 = hist_quantile(edges, counts, 0.50)
    p90 = hist_quantile(edges, counts, 0.90)
    p99 = hist_quantile(edges, counts, 0.99)
    ok = total > 0 and p99 <= target_ms
    out = {
        "target_ms": float(target_ms),
        "p50_ms": p50, "p90_ms": p90, "p99_ms": p99,
        "samples": total,
        "pass": bool(ok),
        "source": source,
    }
    if not all(math.isfinite(out[k])
               for k in ("p50_ms", "p90_ms", "p99_ms")):
        out["overflow"] = True
        for k in ("p50_ms", "p90_ms", "p99_ms"):
            if not math.isfinite(out[k]):
                out[k] = None
    return out


# =======================================================================
# process-local registry
# =======================================================================
_lock = threading.Lock()
_reports: dict[str, dict] = {}
_providers: dict[str, Callable[[], dict]] = {}
_slo: dict | None = None
_slo_target_ms: float = DEFAULT_SLO_TARGET_MS


def register_report(report: CostReport | dict,
                    name: str | None = None) -> None:
    """Record a cost report for this process's ``/costs`` payload."""
    d = report.as_dict() if isinstance(report, CostReport) else dict(report)
    with _lock:
        _reports[name or d.get("name", "tick")] = d


def register_provider(name: str, fn: Callable[[], dict]) -> None:
    """Register a LAZY cost-report provider (e.g. the World's tick).
    Providers run only on ``snapshot(analyze=True)``, never per
    scrape."""
    with _lock:
        _providers[name] = fn


def record_slo(verdict: dict) -> None:
    """Record the latest SLO verdict."""
    global _slo
    with _lock:
        _slo = dict(verdict)


def set_slo_target(target_ms: float) -> None:
    """Set this process's SLO budget (e.g. 1000/tick_hz in a game)."""
    global _slo_target_ms
    with _lock:
        _slo_target_ms = float(target_ms)


def _live_slo() -> dict | None:
    """SLO verdict from the live ``tick_latency_ms`` metric histogram,
    when this process serves one."""
    from goworld_tpu_torch.utils import metrics

    snap = metrics.REGISTRY.histogram_snapshot("tick_latency_ms")
    if not snap:
        return None
    # merge every labeled child into one distribution
    edges: list[float] | None = None
    counts: list[int] | None = None
    for _labels, s in snap:
        e = [u for u, _c in s["buckets"]]
        c = [cnt for _u, cnt in s["buckets"]] + [s["inf"]]
        if edges is None:
            edges, counts = e, c
        elif e == edges:
            counts = [a + b for a, b in zip(counts, c)]
    if edges is None or sum(counts) == 0:
        return None
    return slo_from_histogram(edges, counts, _slo_target_ms,
                              source="tick_latency_ms")


def snapshot(analyze: bool = False) -> dict:
    """The ``/costs`` payload: recorded reports, provider names (run
    when ``analyze``; a provider that raises is recorded as an error),
    and the freshest SLO verdict (explicitly recorded, else derived
    live from ``tick_latency_ms``)."""
    if analyze:
        with _lock:
            pending = list(_providers.items())
        for name, fn in pending:
            try:
                register_report(fn(), name=name)
            except Exception as exc:  # a provider must never fail /costs
                register_report({"name": name,
                                 "error": str(exc)[:200]}, name=name)
    with _lock:
        out: dict = {
            "reports": dict(_reports),
            "providers": sorted(_providers),
            "slo": dict(_slo) if _slo is not None else None,
            "slo_target_ms": _slo_target_ms,
        }
    if out["slo"] is None:
        out["slo"] = _live_slo()
    return out


def reset() -> None:
    """Drop all registered state (tests)."""
    global _slo, _slo_target_ms
    with _lock:
        _reports.clear()
        _providers.clear()
        _slo = None
        _slo_target_ms = DEFAULT_SLO_TARGET_MS
