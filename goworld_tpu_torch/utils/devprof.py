"""Device-plane observability, the part of ``goworld_tpu/utils/devprof.py``
that the World's planes read.

* :func:`grid_config_key` — the resolved kernel stamps of a GridSpec,
  the key a workload signature is stamped with.
* The SLO plane — :func:`hist_quantile` / :func:`hist_quantile_interp`
  / :func:`slo_from_histogram` turn a fixed-bucket histogram (the
  telemetry lanes of :mod:`goworld_tpu_torch.ops.telemetry`, or the live
  ``tick_latency_ms`` metric) into a {target_ms, p50/p90/p99, pass}
  verdict.
* A process-local registry of cost reports, lazy report providers and
  the last SLO verdict (the ``/costs`` payload of the debug endpoints,
  which are not ported yet).

The reference's ``cost_report`` lowers an XLA executable and reads its
cost analysis; a torch step has no such executable, so it is not here
and ``World.cost_report`` raises naming ROADMAP.md (as do the roofline
models, which a later item reads from the port's own counts).
"""

from __future__ import annotations

import math
import threading
from typing import Callable

__all__ = [
    "grid_config_key", "hist_quantile", "hist_quantile_interp",
    "slo_from_histogram", "register_report", "register_provider",
    "record_slo", "snapshot", "set_slo_target", "reset",
    "DEFAULT_SLO_TARGET_MS",
]

# the paper's AOI-sync latency target (p99 < 16 ms at the 1M/60 Hz
# headline shape) — the default SLO budget everywhere
DEFAULT_SLO_TARGET_MS = 16.0


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


def register_report(report: dict, name: str | None = None) -> None:
    """Record a cost report for this process's ``/costs`` payload."""
    d = dict(report)
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
