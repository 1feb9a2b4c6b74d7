"""Deployment-wide observability aggregator: ONE SLO verdict for the
metric the paper is graded on.

Every process's ``/costs`` verdict covers its own device tick; the
sync-age plane (utils/syncage.py) measures what a CLIENT observes —
device-tick epoch to gate delivery. This tool scrapes every process's
``/syncage``, ``/metrics``, ``/clock``, ``/workload``, ``/governor``,
``/incidents`` and ``/standby`` endpoints, merges the fixed-bucket histograms
exactly (``metrics.Histogram.add_counts`` over the raw count vectors
— never re-derived from percentiles), and prints one deployment
verdict::

    python -m goworld_tpu_torch.tools.obs_aggregate <server_dir>
    python -m goworld_tpu_torch.tools.obs_aggregate \
        --url http://127.0.0.1:16000/metrics
    # refreshed every 2 s; the CLI's `watch` runs the same loop
    python -m goworld_tpu_torch.tools.obs_aggregate <server_dir> --watch 2
    python -m goworld_tpu_torch watch <server_dir>

Output: the merged end-to-end sync-age p50/p90/p99 vs the 16 ms
target (the deployment PASS/FAIL), a per-hop lane table attributing
the age (device_tick / drain_decode / encode / dispatcher /
gate_flush), the merged device-tick latency for contrast, and the
measured cross-process wall-clock skew (from the existing ``/clock``
anchors — cross-process ages are only honest up to this number, so it
is printed next to the verdict, never assumed away).

Convention: unreachable processes and processes predating the
endpoints are skipped silently (the ``/costs`` convention — old
processes are not noise); the verdict line reports how many gates
actually contributed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from goworld_tpu_torch.utils import metrics
from goworld_tpu_torch.utils.syncage import (
    DEFAULT_TARGET_MS,
    HOPS,
    ptiles as _ptiles,
)


def _fetch_json(url: str, timeout: float = 2.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def _targets(server_dir: str | None, urls: list[str]) -> list[tuple]:
    """(label, base url) pairs — reuses the scraper's ini discovery."""
    out = [
        (u.split("//", 1)[-1].split("/", 1)[0],
         u.rsplit("/metrics", 1)[0].rstrip("/"))
        for u in urls
    ]
    if server_dir:
        from goworld_tpu_torch import config as config_mod
        from goworld_tpu_torch.tools import scrape_metrics

        for name in config_mod.DEFAULT_CONFIG_PATHS:
            p = os.path.join(server_dir, name)
            if os.path.exists(p):
                out += [
                    (label, url.rsplit("/", 1)[0])
                    for label, url in scrape_metrics.targets_from_config(
                        config_mod.load(p))
                ]
                break
        else:
            raise FileNotFoundError(
                f"no cluster ini under {server_dir}")
    return out


def _merge_counts(hist: metrics.Histogram | None, edges, counts):
    """Merge one raw count vector into the running histogram; builds it
    from the first contributor's edges, skips mismatched edge sets
    (a process running different buckets cannot merge exactly —
    ``add_counts`` only checks the vector LENGTH, so the edges are
    compared here)."""
    if hist is None:
        hist = metrics.Histogram(buckets=edges)
    if list(edges) != list(hist._uppers):
        return hist, False
    try:
        hist.add_counts(counts)
    except ValueError:
        return hist, False
    return hist, True


def scrape_clock_skew(targets: list[tuple],
                      timeout: float = 2.0) -> dict:
    """Cross-process wall-clock offsets via the existing ``/clock``
    anchors: each offset is remote ``wall_us`` minus the local request
    midpoint; the SPREAD between processes bounds how honest
    cross-process age lanes are. (merge_traces.py uses the same
    estimator to align cluster traces.)"""
    offsets: dict[str, float] = {}
    for label, base in targets:
        t0 = time.time()
        try:
            payload = _fetch_json(f"{base}/clock", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            continue
        mid_us = (t0 + time.time()) / 2.0 * 1e6
        if isinstance(payload, dict) and "wall_us" in payload:
            offsets[label] = payload["wall_us"] - mid_us
    out: dict = {"offsets_us": {k: round(v, 1)
                                for k, v in offsets.items()}}
    if len(offsets) >= 2:
        spread = max(offsets.values()) - min(offsets.values())
        out["max_skew_ms"] = round(spread / 1e3, 3)
    return out


def aggregate(targets: list[tuple], timeout: float = 2.0,
              tick_contrast: bool = True) -> dict:
    """Scrape + merge the whole deployment into one record.
    ``tick_contrast=False`` skips the merged device-tick /metrics
    scrape (one extra round-trip per process that only the hop table
    prints — ``cli.py status`` already scraped /metrics itself)."""
    e2e_hist: metrics.Histogram | None = None
    hop_hists: dict[str, metrics.Histogram | None] = \
        {h: None for h in HOPS}
    edges = None
    gates: list[str] = []
    skipped: list[str] = []
    targets_ms: list[float] = []
    warp_total = 0
    for label, base in targets:
        try:
            payload = _fetch_json(f"{base}/syncage", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            skipped.append(label)
            continue
        if not isinstance(payload, dict) or "error" in payload:
            skipped.append(label)  # a process that ages nothing
            continue
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict) or "e2e_counts" not in snap:
                continue
            sedges = snap.get("edges_ms")
            e2e_hist, ok = _merge_counts(e2e_hist, sedges,
                                         snap["e2e_counts"])
            if not ok:
                skipped.append(f"{label}:{name} (bucket mismatch)")
                continue
            edges = edges or sedges
            for hop in HOPS:
                hc = (snap.get("hop_counts") or {}).get(hop)
                if hc is not None:
                    hop_hists[hop], _ = _merge_counts(
                        hop_hists[hop], sedges, hc)
            gates.append(f"{label}:{name}")
            warp_total += int(snap.get("clock_warp_total", 0))
            if isinstance(snap.get("target_ms"), (int, float)):
                targets_ms.append(float(snap["target_ms"]))
    out: dict = {
        # gates may run different targets; the deployment verdict is
        # judged against the STRICTEST one (and the spread is visible)
        "target_ms": min(targets_ms) if targets_ms
        else DEFAULT_TARGET_MS,
        "gates": gates,
        "skipped": skipped,
        "clock_warp_total": warp_total,
    }
    if targets_ms and min(targets_ms) != max(targets_ms):
        out["target_ms_max"] = max(targets_ms)
    if e2e_hist is not None and edges is not None:
        snap = e2e_hist.snapshot()
        counts = [c for _u, c in snap["buckets"]] + [snap["inf"]]
        out["e2e"] = _ptiles(edges, counts)
        p99 = out["e2e"].get("p99_ms")
        if isinstance(p99, (int, float)):
            out["pass"] = bool(p99 <= out["target_ms"])
        elif p99 == "inf":
            out["pass"] = False
        hops = {}
        for hop in HOPS:
            h = hop_hists[hop]
            if h is None:
                continue
            hs = h.snapshot()
            hops[hop] = _ptiles(
                edges, [c for _u, c in hs["buckets"]] + [hs["inf"]])
        out["hops"] = hops
    # contrast line: the merged DEVICE-tick latency (what every verdict
    # before this plane measured) from each process's /metrics buckets
    if tick_contrast:
        out["tick_latency"] = _merged_metric_hist(
            targets, "tick_latency_ms", timeout=timeout)
    out["clock"] = scrape_clock_skew(targets, timeout=timeout)
    out["residency"] = aggregate_residency(targets, timeout=timeout)
    out["audit"] = aggregate_audit(targets, timeout=timeout)
    out["standby"] = aggregate_standby(targets, timeout=timeout)
    out["rebalance"] = aggregate_rebalance(targets, timeout=timeout)
    return out


def aggregate_standby(targets: list[tuple],
                      timeout: float = 2.0) -> dict:
    """Scrape every process's ``/standby`` plane (replication/standby.py)
    and collect one record per hot-standby mirror: role, replication
    lag (wall time since the last applied frame in primary ticks, the
    sync-age convention), bytes/tick of stream cost, and last-keyframe
    age. Processes without a tracker answer an honest error dict and
    are skipped silently (the ``/costs`` convention)."""
    standbys: list[dict] = []
    for label, base in targets:
        try:
            payload = _fetch_json(f"{base}/standby", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if not isinstance(payload, dict) or "error" in payload:
            continue
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict) or "role" not in snap:
                continue
            standbys.append({"source": f"{label}:{name}", **snap})
    out: dict = {"standbys": standbys}
    verdicts = [s["pass"] for s in standbys if "pass" in s]
    if verdicts:
        out["pass"] = all(verdicts)
    return out


def standby_lines(agg: dict) -> list[str]:
    """One replication line per hot standby (empty when none
    contributed): lag ticks vs budget, stream bytes/tick, and the age
    of the last keyframe (the resync anchor — a stale keyframe means a
    torn stream could not self-heal yet)."""
    lines: list[str] = []
    for s in (agg.get("standby") or {}).get("standbys", []):
        verdict = ("PASS" if s.get("pass")
                   else "FAIL" if "pass" in s else "?")
        lag = s.get("lag_ticks")
        line = (f"standby game{s.get('standby_game')} of "
                f"game{s.get('primary_game')} {verdict} "
                f"lag={'-' if lag is None else lag} ticks vs budget "
                f"{s.get('lag_budget_ticks')} | "
                f"{s.get('bytes_per_tick')} B/tick | last keyframe "
                f"{s.get('last_keyframe_age_s', '-')}s ago "
                f"({s.get('frames')} frames, role {s.get('role')})")
        rej = sum((s.get("rejects") or {}).values())
        if rej:
            line += f" | {rej} torn frames rejected"
        if s.get("role") == "promoted":
            line += (f" | promoted epoch {s.get('promoted_epoch')} at "
                     f"tick {s.get('promoted_at_tick')}")
        lines.append(line)
    return lines


def aggregate_rebalance(targets: list[tuple],
                        timeout: float = 2.0) -> dict:
    """Scrape every process's ``/rebalance`` plane
    (goworld_tpu_torch/rebalance/) and collect one record per handoff
    executor agent plus the deployment controller's snapshot (at most
    one process hosts it). Processes without the plane answer an
    honest error dict and are skipped silently (the ``/costs``
    convention)."""
    agents: list[dict] = []
    controller: dict | None = None
    for label, base in targets:
        try:
            payload = _fetch_json(f"{base}/rebalance",
                                  timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if not isinstance(payload, dict) or "error" in payload:
            continue
        for name, snap in sorted(
                (payload.get("agents") or {}).items()):
            if isinstance(snap, dict):
                agents.append({"source": f"{label}:{name}", **snap})
        ctl = payload.get("controller")
        if isinstance(ctl, dict) and controller is None:
            controller = {"source": label, **ctl}
    out: dict = {
        "agents": agents,
        "busy": sum(1 for a in agents if a.get("busy")),
        "moves_total": sum(
            sum((a.get("moves_total") or {}).values())
            for a in agents),
        "aborts_total": sum(
            sum((a.get("aborts_total") or {}).values())
            for a in agents),
    }
    if controller is not None:
        out["controller"] = controller
    return out


def rebalance_lines(agg: dict) -> list[str]:
    """One line per handoff agent with live work or history, plus the
    controller's decision state (empty when no process carries the
    plane): a BUSY agent shows the in-flight job (target, acked/sent,
    unacked backlog — the entities whose loss an abort must undo)."""
    lines: list[str] = []
    rb = agg.get("rebalance") or {}
    for a in rb.get("agents", []):
        moved = sum((a.get("moves_total") or {}).values())
        if not (a.get("busy") or a.get("handoffs") or moved):
            continue  # an idle agent with no history is just wiring
        line = (f"rebalance {a.get('game')} "
                f"{'BUSY' if a.get('busy') else 'idle'} | "
                f"{a.get('handoffs', 0)} handoff(s), "
                f"{a.get('completed', 0)} done, "
                f"{a.get('aborted', 0)} aborted")
        if moved:
            line += f" | {moved} entities moved"
        job = a.get("job")
        if job:
            line += (f" | -> {job.get('target')} "
                     f"{job.get('acked')}/{job.get('sent')} acked, "
                     f"{job.get('unacked')} in flight "
                     f"({job.get('reason')})")
        lines.append(line)
    ctl = rb.get("controller")
    if ctl:
        pol = ctl.get("policy") or {}
        line = (f"rebalance controller ({ctl.get('source')}): "
                f"window {pol.get('window')}, "
                f"{pol.get('committed', 0)} committed / "
                f"{pol.get('planned', 0)} planned")
        if pol.get("pending"):
            line += f" | pending {pol['pending']}"
        if pol.get("runs"):
            runs = ", ".join(f"{n}:{r}" for n, r in
                             sorted(pol["runs"].items()))
            line += f" | hot runs {runs}"
        lines.append(line)
    return lines


def aggregate_audit(targets: list[tuple], timeout: float = 2.0) -> dict:
    """Scrape every process's ``/audit`` plane (utils/audit.py) and
    prove deployment-wide entity conservation: the per-game ledger
    censuses + the unmatched in-flight migration window must equal
    created - destroyed exactly (``audit.conservation_verdict`` — the
    same function the chaos audit scenario gates on). The dispatcher's
    routing census cross-checks the games' own ledgers; a violation
    names its first EntityID. Unreachable/plane-less processes are
    skipped silently (the ``/costs`` convention)."""
    from goworld_tpu_torch.utils import audit as audit_mod

    games: list[dict] = []
    disp: dict | None = None
    gate_probes = 0
    sources: list[str] = []
    for label, base in targets:
        try:
            payload = _fetch_json(f"{base}/audit", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if not isinstance(payload, dict) or "error" in payload:
            continue
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict):
                continue
            kind = snap.get("kind")
            if kind == "game":
                games.append(snap)
                sources.append(f"{label}:{name}")
            elif kind == "dispatcher":
                disp = snap
                sources.append(f"{label}:{name}")
            elif kind == "gate":
                gate_probes += 1
    if not games:
        return {"games": 0, "sources": sources}
    out = audit_mod.conservation_verdict(games, dispatcher=disp)
    out["sources"] = sources
    out["gate_probes"] = gate_probes
    out["oracle_samples"] = sum(
        (g.get("oracle") or {}).get("samples", 0) for g in games)
    out["oracle_mismatches"] = sum(
        (g.get("oracle") or {}).get("mismatches", 0) for g in games)
    return out


def audit_line(agg: dict) -> str:
    """One deployment conservation line (empty when no game ledger
    contributed): the census balance verdict with any named problems
    indented under it."""
    a = agg.get("audit") or {}
    if not a.get("games"):
        return ""
    verdict = "PASS" if a.get("ok") else "FAIL"
    line = (f"deployment conservation {verdict} "
            f"live={a.get('live')} + in_flight={a.get('in_flight')} "
            f"vs created={a.get('created')} - "
            f"destroyed={a.get('destroyed')} "
            f"({a['games']} games, "
            f"{a.get('oracle_samples', 0)} oracle samples")
    if "dispatcher_entities" in a:
        line += f", dispatcher routes {a['dispatcher_entities']}"
    line += ")"
    for p in (a.get("problems") or [])[:4]:
        line += f"\n  audit: {p}"
    return line


def aggregate_residency(targets: list[tuple],
                        timeout: float = 2.0) -> dict:
    """Merge every tracked world's serve-loop residency plane
    (utils/residency.py, debug_http ``/residency``) into one
    deployment record: the bubble histograms are vector-added exactly
    (``add_counts`` over the raw count vectors, the ``/syncage``
    convention), the serve_gap is reported as the WORST across worlds
    (the deployment's hidden tax is set by its slowest serve loop),
    and the verdict judges the merged bubble p99 against the
    STRICTEST budget. Unreachable/404/tracker-less processes are
    skipped silently."""
    bub_hist: metrics.Histogram | None = None
    edges = None
    worlds: list[str] = []
    worst_gap = None
    budget = None
    for label, base in targets:
        try:
            payload = _fetch_json(f"{base}/residency", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if not isinstance(payload, dict) or "error" in payload:
            continue
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict) \
                    or "bubble_counts" not in snap:
                continue
            sedges = snap.get("edges_ms")
            bub_hist, ok = _merge_counts(bub_hist, sedges,
                                         snap["bubble_counts"])
            if not ok:
                worlds.append(f"{label}:{name} (bucket mismatch)")
                continue
            edges = edges or sedges
            worlds.append(f"{label}:{name}")
            gap = snap.get("serve_gap")
            if isinstance(gap, (int, float)) \
                    and (worst_gap is None or gap > worst_gap):
                worst_gap = gap
            b = snap.get("bubble_budget_ms")
            if isinstance(b, (int, float)):
                budget = b if budget is None else min(budget, b)
    out: dict = {"worlds": worlds}
    if bub_hist is not None and edges is not None:
        hs = bub_hist.snapshot()
        out["bubble"] = _ptiles(
            edges, [c for _u, c in hs["buckets"]] + [hs["inf"]])
        if budget is not None:
            out["bubble_budget_ms"] = budget
            p99 = out["bubble"].get("p99_ms")
            if isinstance(p99, (int, float)):
                out["pass"] = bool(p99 <= budget)
            elif p99 == "inf":
                out["pass"] = False
    if worst_gap is not None:
        out["serve_gap_worst"] = worst_gap
    return out


def residency_line(agg: dict) -> str:
    """One deployment serve-loop residency line (empty when no world
    contributed): merged bubble percentiles vs the strictest budget +
    the worst serve_gap."""
    res = agg.get("residency") or {}
    bub = res.get("bubble")
    if not bub or not bub.get("samples"):
        return ""
    verdict = ("PASS" if res.get("pass")
               else "FAIL" if "pass" in res else "?")
    line = (f"deployment residency {verdict} bubble "
            f"p50={bub.get('p50_ms')} p90={bub.get('p90_ms')} "
            f"p99={bub.get('p99_ms')} ms vs budget "
            f"{res.get('bubble_budget_ms')} ms "
            f"({bub['samples']} ticks via "
            f"{len(res.get('worlds', []))} worlds)")
    if res.get("serve_gap_worst") is not None:
        line += f" | worst serve_gap {res['serve_gap_worst']}"
    return line


def _merged_metric_hist(targets: list[tuple], name: str,
                        timeout: float = 2.0) -> dict:
    """Merge one unlabeled histogram family across every /metrics
    endpoint (cumulative Prometheus buckets de-cumulated per process,
    then vector-added)."""
    merged: metrics.Histogram | None = None
    edges_out = None
    for _label, base in targets:
        try:
            with urllib.request.urlopen(f"{base}/metrics",
                                        timeout=timeout) as resp:
                series = metrics.parse_prometheus_text(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError):
            continue
        buckets: list[tuple[float, float]] = []
        for key, v in series.items():
            if not key.startswith(f"{name}_bucket{{"):
                continue
            le = key.split('le="', 1)[-1].rstrip('"}')
            buckets.append(
                (float("inf") if le == "+Inf" else float(le), v))
        if not buckets:
            continue
        buckets.sort()
        edges = [u for u, _c in buckets if u != float("inf")]
        cum = [c for _u, c in buckets]
        counts = [cum[0]] + [cum[i] - cum[i - 1]
                             for i in range(1, len(cum))]
        counts = [max(0, int(c)) for c in counts]
        if merged is None:
            merged = metrics.Histogram(buckets=edges)
            edges_out = edges
        try:
            merged.add_counts(counts)
        except ValueError:
            continue
    if merged is None or edges_out is None:
        return {"samples": 0}
    snap = merged.snapshot()
    return _ptiles(edges_out,
                   [c for _u, c in snap["buckets"]] + [snap["inf"]])


def scrape_process_lines(targets: list[tuple],
                         timeout: float = 2.0) -> list[str]:
    """Per-process context lines under the verdict (workload signature,
    governor, incident counts) — ONE copy of the scrape plumbing,
    shared with ``cli.py status``."""
    from goworld_tpu_torch.tools import scrape_metrics

    mtargets = [(label, f"{base}/metrics") for label, base in targets]
    wl = scrape_metrics.scrape_workload(mtargets, timeout=timeout)
    gv = scrape_metrics.scrape_governor(mtargets, timeout=timeout)
    rs = scrape_metrics.scrape_residency(mtargets, timeout=timeout)
    return (scrape_metrics.workload_lines(wl)
            + scrape_metrics.governor_lines(gv)
            + scrape_metrics.residency_lines(rs))


def verdict_line(agg: dict) -> str:
    """The ONE deployment line: merged e2e sync-age percentiles vs the
    target, contributor count, and the measured clock-skew bound."""
    e2e = agg.get("e2e")
    if not e2e or not e2e.get("samples"):
        return ("deployment sync-age: no stamped deliveries yet "
                f"({len(agg.get('gates', []))} gates answered, "
                f"{len(agg.get('skipped', []))} processes skipped)")
    verdict = "PASS" if agg.get("pass") else "FAIL"
    line = (f"deployment sync-age {verdict} "
            f"e2e p50={e2e.get('p50_ms')} p90={e2e.get('p90_ms')} "
            f"p99={e2e.get('p99_ms')} ms vs target "
            f"{agg.get('target_ms')} ms "
            f"({e2e['samples']} records via {len(agg.get('gates', []))}"
            f" gates)")
    skew = (agg.get("clock") or {}).get("max_skew_ms")
    if skew is not None:
        line += f" | clock skew <= {skew} ms"
    if agg.get("clock_warp_total"):
        line += f" | {agg['clock_warp_total']} warped boundaries"
    return line


def hop_table(agg: dict) -> list[str]:
    hops = agg.get("hops") or {}
    if not hops:
        return []
    lines = [f"{'hop':<14}{'p50_ms':>10}{'p90_ms':>10}{'p99_ms':>10}"]
    for hop in HOPS:
        h = hops.get(hop)
        if not h or not h.get("samples"):
            continue
        lines.append(f"{hop:<14}{h.get('p50_ms', '-'):>10}"
                     f"{h.get('p90_ms', '-'):>10}"
                     f"{h.get('p99_ms', '-'):>10}")
    tick = agg.get("tick_latency") or {}
    if tick.get("samples"):
        lines.append(f"{'(device tick)':<14}{tick.get('p50_ms', '-'):>10}"
                     f"{tick.get('p90_ms', '-'):>10}"
                     f"{tick.get('p99_ms', '-'):>10}")
    return lines


def render(agg: dict) -> str:
    lines = [verdict_line(agg)] + hop_table(agg)
    rline = residency_line(agg)
    if rline:
        lines.append(rline)
    aline = audit_line(agg)
    if aline:
        lines.append(aline)
    lines += standby_lines(agg)
    lines += rebalance_lines(agg)
    return "\n".join(lines)


def probe_targets(targets: list[tuple],
                  timeout: float = 2.0) -> list[str]:
    """``--strict`` reachability sweep: every configured process must
    answer ``/healthz``; returns the failures as ``label: reason``
    lines (empty = all reachable)."""
    failures: list[str] = []
    for label, base in targets:
        try:
            _fetch_json(f"{base}/healthz", timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            failures.append(f"{label}: {base}/healthz unreachable "
                            f"({exc})")
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="merge every process's sync-age plane into one "
                    "deployment SLO verdict")
    ap.add_argument("server_dir", nargs="?", default=None)
    ap.add_argument("--url", action="append", default=[],
                    help="a process /metrics url (repeatable)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS seconds until interrupted")
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw merged record instead of text")
    ap.add_argument("--strict", action="store_true",
                    help="list unreachable configured processes and "
                         "exit nonzero instead of skipping them "
                         "silently (CI mode)")
    args = ap.parse_args(argv)

    try:
        targets = _targets(args.server_dir, args.url)
    except FileNotFoundError as exc:
        print(exc, file=sys.stderr)
        return 1
    if not targets:
        print("nothing to scrape: pass a server dir with http_port "
              "configured, or --url", file=sys.stderr)
        return 1

    strict_rc = 0
    while True:
        if args.strict:
            failures = probe_targets(targets, timeout=args.timeout)
            for f in failures:
                print(f"STRICT: {f}", file=sys.stderr)
            if failures:
                strict_rc = 1
        agg = aggregate(targets, timeout=args.timeout)
        if args.json:
            print(json.dumps(agg, indent=2, default=str))
        else:
            print(render(agg))
            for line in scrape_process_lines(targets,
                                             timeout=args.timeout):
                print(line)
        if not args.watch:
            break
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            break
        print()
    return strict_rc


if __name__ == "__main__":
    sys.exit(main())
