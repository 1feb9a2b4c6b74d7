"""One-shot /metrics scraper across a whole cluster.

Hits every process's debug-http ``/metrics`` endpoint (dispatchers,
games, gates — ports from the server dir's ini ``http_port`` keys) and
prints one merged table: rows are metric series, one value column per
process. Used by ``goworld_tpu_torch.cli status`` and usable directly in CI
smoke runs::

    # the whole cluster; one process; with histogram bucket rows
    python -m goworld_tpu_torch.tools.scrape_metrics <server_dir>
    python -m goworld_tpu_torch.tools.scrape_metrics \
        --url http://127.0.0.1:16000/metrics
    python -m goworld_tpu_torch.tools.scrape_metrics <server_dir> --buckets

Also scrapes every process's ``/costs`` endpoint (the device-plane
observability of :mod:`goworld_tpu_torch.utils.devprof`) and prints one SLO
verdict line per process under the metric table — p50/p90/p99 against
the process's latency budget, plus any registered compiled-tick cost
reports with ``--costs``. Processes predating the endpoint are
skipped silently.

Exit status: 0 if every target answered, 1 otherwise (a process with a
configured http_port that cannot be scraped is a finding, not noise).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

from goworld_tpu_torch import config as config_mod
from goworld_tpu_torch.utils.metrics import parse_prometheus_text


def targets_from_config(cfg, host_fallback: str = "127.0.0.1",
                        ) -> list[tuple[str, str]]:
    """(label, /metrics url) for every process with an http_port.
    Multihost games expose one endpoint per rank (http_port + rank)."""
    targets: list[tuple[str, str]] = []
    for did, dc in sorted(cfg.dispatchers.items()):
        if dc.http_port:
            targets.append((
                f"dispatcher{did}",
                f"http://{dc.host}:{dc.http_port}/metrics",
            ))
    for gid, gc in sorted(cfg.games.items()):
        if not gc.http_port:
            continue
        procs = max(1, getattr(gc, "mesh_processes", 1))
        for rank in range(procs):
            label = f"game{gid}" if procs == 1 else f"game{gid}c{rank}"
            targets.append((
                label,
                f"http://{host_fallback}:{gc.http_port + rank}/metrics",
            ))
    for gid, gc in sorted(cfg.gates.items()):
        if gc.http_port:
            targets.append((
                f"gate{gid}",
                f"http://{gc.host}:{gc.http_port}/metrics",
            ))
    return targets


def scrape(url: str, timeout: float = 2.0) -> dict[str, float]:
    """Fetch one /metrics endpoint into {series: value}; raises on
    network errors (callers decide whether that is fatal)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_prometheus_text(
            resp.read().decode("utf-8", "replace")
        )


def scrape_all(targets: list[tuple[str, str]], timeout: float = 2.0,
               ) -> tuple[dict[str, dict[str, float]], list[str]]:
    """Scrape every target; returns ({label: series map}, [errors])."""
    results: dict[str, dict[str, float]] = {}
    errors: list[str] = []
    for label, url in targets:
        try:
            results[label] = scrape(url, timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            errors.append(f"{label}: {url} unreachable ({e})")
    return results, errors


def merged_table(results: dict[str, dict[str, float]],
                 include_buckets: bool = False) -> str:
    """One row per series, one column per process; histogram bucket
    rows are dropped by default (they swamp the table — use /metrics
    directly or --buckets when they matter)."""
    if not results:
        return "(no metrics scraped)"
    labels = list(results)
    series: set[str] = set()
    for m in results.values():
        series.update(m)
    if not include_buckets:
        series = {s for s in series if "_bucket{" not in s}
    rows = sorted(series)
    name_w = max([len(r) for r in rows] + [len("series")])
    col_ws = [
        max(len(lb), *(len(_cell(results[lb].get(r))) for r in rows))
        if rows else len(lb)
        for lb in labels
    ]
    lines = [
        "  ".join(["series".ljust(name_w)]
                  + [lb.rjust(w) for lb, w in zip(labels, col_ws)])
    ]
    for r in rows:
        lines.append("  ".join(
            [r.ljust(name_w)]
            + [_cell(results[lb].get(r)).rjust(w)
               for lb, w in zip(labels, col_ws)]
        ))
    return "\n".join(lines)


def _cell(v: float | None) -> str:
    if v is None:
        return "-"
    return str(int(v)) if float(v).is_integer() else f"{v:.3f}"


# ----------------------------------------------------------------------
# /costs: per-process SLO verdicts + cost reports (utils/devprof)
# ----------------------------------------------------------------------
def scrape_costs(targets: list[tuple[str, str]], timeout: float = 2.0,
                 errors: list[str] | None = None) -> dict[str, dict]:
    """Fetch each target's ``/costs`` (derived from its /metrics url);
    {label: payload}. Unreachable processes or processes predating the
    endpoint (404) are skipped — the metric scrape already reports
    reachability — unless the caller passes ``errors`` (``--strict``):
    then every failure is appended there as a ``label: reason`` line."""
    out: dict[str, dict] = {}
    for label, url in targets:
        costs_url = url.rsplit("/", 1)[0] + "/costs"
        try:
            with urllib.request.urlopen(costs_url,
                                        timeout=timeout) as resp:
                payload = json.loads(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            if errors is not None:
                errors.append(f"{label}: {costs_url} failed ({e})")
            continue
        if isinstance(payload, dict) and "error" not in payload:
            out[label] = payload
    return out


def scrape_workload(targets: list[tuple[str, str]],
                    timeout: float = 2.0) -> dict[str, dict]:
    """Fetch each target's ``/workload`` and ``/incidents`` (derived
    from its /metrics url); {label: {"workload": ..., "incidents":
    ...}}. Unreachable processes and processes predating the
    endpoints (404) are skipped silently, matching the ``/costs``
    convention — old processes are not noise."""
    out: dict[str, dict] = {}
    for label, url in targets:
        base = url.rsplit("/", 1)[0]
        entry: dict = {}
        for name in ("workload", "incidents"):
            try:
                with urllib.request.urlopen(f"{base}/{name}",
                                            timeout=timeout) as resp:
                    payload = json.loads(
                        resp.read().decode("utf-8", "replace"))
            except (urllib.error.URLError, OSError, ValueError):
                # 404s (old processes) arrive as HTTPError — skipped
                # here like unreachable hosts
                continue
            if isinstance(payload, dict):
                entry[name] = payload
        if entry:
            out[label] = entry
    return out


def workload_lines(scraped: dict[str, dict]) -> list[str]:
    """One live workload-signature + incident-count line per process
    (``cli.py status`` prints these under the SLO verdicts)."""
    lines: list[str] = []
    for label, entry in sorted(scraped.items()):
        wl = entry.get("workload")
        if not (isinstance(wl, dict) and wl.get("sig")):
            # gates/dispatchers serve the endpoint but carry no live
            # world — skip silently, like 404s
            continue
        rec = wl.get("recommendation") or {}
        rec_s = " ".join(f"{k}={v}" for k, v in sorted(rec.items()))
        # the resolved precision plane rides the signature's config
        # stamp — surface it so a recommend sync_delta=1
        # line is readable next to what the process already runs
        prec = (wl.get("config") or {}).get("precision", "off")
        line = (f"{label}: workload {wl['sig']} "
                + (f"[{prec}] " if prec != "off" else "")
                + f"({wl.get('ticks', 0)} ticks in window"
                + (f"; recommend {rec_s}" if rec_s else "") + ")")
        inc = entry.get("incidents")
        if isinstance(inc, dict):
            n = sum(
                rec.get("incident_count", 0)
                for rec in inc.values() if isinstance(rec, dict)
            )
            line += f" | incidents {n}"
        lines.append(line)
    return lines


def scrape_governor(targets: list[tuple[str, str]],
                    timeout: float = 2.0) -> dict[str, dict]:
    """Fetch each target's ``/governor`` (goworld_tpu_torch/autotune);
    {label: payload}. Unreachable/404/provider-less processes are
    skipped silently — the ``/costs`` convention."""
    out: dict[str, dict] = {}
    for label, url in targets:
        gov_url = url.rsplit("/", 1)[0] + "/governor"
        try:
            with urllib.request.urlopen(gov_url,
                                        timeout=timeout) as resp:
                payload = json.loads(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if isinstance(payload, dict) and "error" not in payload:
            out[label] = payload
    return out


def governor_lines(scraped: dict[str, dict]) -> list[str]:
    """One kernel-governor line per process with a live governor
    (``cli.py status`` prints these under the workload lines):
    current config key, pending warm target, swap count, regret
    state."""
    lines: list[str] = []
    for label, payload in sorted(scraped.items()):
        for name, g in sorted(payload.items()):
            if not isinstance(g, dict) or "current" not in g:
                continue
            line = (f"{label}: governor {g['current']}"
                    + (f" -> {g['pending']} (warming)"
                       if g.get("pending") else "")
                    + f" | swaps {len(g.get('swaps', []))}"
                    + f" over {g.get('windows', 0)} windows")
            reg = g.get("regret_guard")
            if isinstance(reg, dict):
                line += (f" | regret watch (revert to "
                         f"{reg.get('revert_to')})")
            lines.append(line)
    return lines


def scrape_rebalance(targets: list[tuple[str, str]],
                     timeout: float = 2.0) -> dict[str, dict]:
    """Fetch each target's ``/rebalance`` (goworld_tpu_torch/rebalance);
    {label: payload}. Unreachable/404/plane-less processes are
    skipped silently — the ``/costs`` convention."""
    out: dict[str, dict] = {}
    for label, url in targets:
        rb_url = url.rsplit("/", 1)[0] + "/rebalance"
        try:
            with urllib.request.urlopen(rb_url,
                                        timeout=timeout) as resp:
                payload = json.loads(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError):
            continue
        if isinstance(payload, dict) and "error" not in payload:
            out[label] = payload
    return out


def rebalance_lines(scraped: dict[str, dict]) -> list[str]:
    """One self-healing line per process whose handoff agent has live
    or historical work (``cli.py status`` prints these under the
    standby lines); idle agents with no history stay silent — the
    plane is wiring on every game, news only when a move happened."""
    lines: list[str] = []
    for label, payload in sorted(scraped.items()):
        for name, a in sorted((payload.get("agents") or {}).items()):
            if not isinstance(a, dict):
                continue
            moved = sum((a.get("moves_total") or {}).values())
            if not (a.get("busy") or a.get("handoffs") or moved):
                continue
            line = (f"{label}: rebalance {a.get('game', name)} "
                    f"{'BUSY' if a.get('busy') else 'idle'} | "
                    f"{a.get('handoffs', 0)} handoff(s), "
                    f"{a.get('completed', 0)} done, "
                    f"{a.get('aborted', 0)} aborted")
            if moved:
                line += f" | {moved} entities moved"
            job = a.get("job")
            if job:
                line += (f" | -> {job.get('target')} "
                         f"{job.get('acked')}/{job.get('sent')} "
                         f"acked, {job.get('unacked')} in flight")
            lines.append(line)
        ctl = payload.get("controller")
        if isinstance(ctl, dict):
            pol = ctl.get("policy") or {}
            line = (f"{label}: rebalance controller window "
                    f"{pol.get('window')}, "
                    f"{pol.get('committed', 0)} committed / "
                    f"{pol.get('planned', 0)} planned")
            if pol.get("pending"):
                line += f" | pending {pol['pending']}"
            lines.append(line)
    return lines


def scrape_residency(targets: list[tuple[str, str]],
                     timeout: float = 2.0,
                     errors: list[str] | None = None) -> dict[str, dict]:
    """Fetch each target's ``/residency`` (utils/residency.py);
    {label: payload}. Unreachable/404/tracker-less processes are
    skipped silently — the ``/costs`` convention (gates and
    dispatchers serve the endpoint but tick no world) — unless the
    caller passes ``errors`` (``--strict``)."""
    out: dict[str, dict] = {}
    for label, url in targets:
        res_url = url.rsplit("/", 1)[0] + "/residency"
        try:
            with urllib.request.urlopen(res_url,
                                        timeout=timeout) as resp:
                payload = json.loads(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            if errors is not None:
                errors.append(f"{label}: {res_url} failed ({e})")
            continue
        if isinstance(payload, dict) and "error" not in payload:
            out[label] = payload
    return out


def scrape_audit(targets: list[tuple[str, str]], timeout: float = 2.0,
                 errors: list[str] | None = None) -> dict[str, dict]:
    """Fetch each target's ``/audit`` (utils/audit.py correctness
    plane); {label: payload}. Unreachable/404/plane-less processes
    are skipped silently — the ``/costs`` convention — unless the
    caller passes ``errors`` (``--strict``): then every failure is
    appended there so a misconfigured audit rollout is visible
    instead of quietly shrinking the census."""
    out: dict[str, dict] = {}
    for label, url in targets:
        aud_url = url.rsplit("/", 1)[0] + "/audit"
        try:
            with urllib.request.urlopen(aud_url,
                                        timeout=timeout) as resp:
                payload = json.loads(
                    resp.read().decode("utf-8", "replace"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            if errors is not None:
                errors.append(f"{label}: {aud_url} failed ({e})")
            continue
        if isinstance(payload, dict) and "error" not in payload:
            out[label] = payload
    return out


def audit_lines(scraped: dict[str, dict]) -> list[str]:
    """One entity-ownership line per audited process (``cli.py
    status`` prints the cluster-level conservation verdict; these are
    the per-process raw censuses): live count, census CRC, lifetime
    create/destroy/migrate counters, violation total and oracle
    sample progress."""
    lines: list[str] = []
    for label, payload in sorted(scraped.items()):
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict):
                continue
            if snap.get("kind") == "game" and "census" in snap:
                viol = sum((snap.get("violations_total") or {}).values())
                oracle = snap.get("oracle") or {}
                line = (f"{label}: audit {name} live="
                        f"{snap.get('entities', 0)} "
                        f"crc={snap.get('crc', 0):08x} | "
                        f"created {snap.get('created', 0)} "
                        f"destroyed {snap.get('destroyed', 0)} "
                        f"migrated {snap.get('migrated_out', 0)}out/"
                        f"{snap.get('migrated_in', 0)}in | "
                        f"oracle {oracle.get('samples', 0)} samples "
                        f"{oracle.get('mismatches', 0)} mismatches | "
                        + ("OK" if viol == 0 else
                           f"{viol} VIOLATIONS"))
                lines.append(line)
            elif snap.get("kind") == "dispatcher":
                games = snap.get("games") or {}
                lines.append(f"{label}: audit routes "
                             f"{snap.get('entities', 0)} entities "
                             f"over {len(games)} games")
    return lines


def residency_lines(scraped: dict[str, dict]) -> list[str]:
    """One serve-loop residency line per tracked world (``cli.py
    status`` prints these under the governor lines): bubble p99 vs
    budget, alloc churn (or its honest absence), the serve_gap ratio
    and any gc pauses on the tick thread."""
    lines: list[str] = []
    for label, payload in sorted(scraped.items()):
        for name, snap in sorted(payload.items()):
            if not isinstance(snap, dict) or "bubble" not in snap:
                continue
            p99 = (snap["bubble"] or {}).get("p99_ms")
            line = f"{label}: residency bubble p99 {p99} ms"
            alloc = snap.get("alloc")
            if isinstance(alloc, dict) and "allocs_per_tick" in alloc:
                line += f" | allocs/tick {alloc['allocs_per_tick']}"
            elif isinstance(alloc, dict) and "unavailable" in alloc:
                line += " | allocs/tick -"
            gap = snap.get("serve_gap")
            if gap is not None:
                line += (f" | serve_gap {gap} "
                         f"({snap.get('serve_gap_ref', '?')})")
            gc_snap = snap.get("gc") or {}
            if gc_snap.get("pauses"):
                line += (f" | gc {gc_snap['pauses']} pauses "
                         f"max {gc_snap.get('max_ms')} ms")
            if "pass" in snap:
                line += " | " + ("PASS" if snap["pass"] else
                                 "FAIL (bubble over "
                                 f"{snap.get('bubble_budget_ms')} ms)")
            lines.append(line)
    return lines


def slo_lines(costs: dict[str, dict]) -> list[str]:
    """One human line per process: the SLO verdict (or its absence)."""
    lines: list[str] = []
    for label, payload in sorted(costs.items()):
        slo = payload.get("slo")
        if not isinstance(slo, dict):
            lines.append(f"{label}: slo -(no latency histogram yet)")
            continue
        verdict = "PASS" if slo.get("pass") else "FAIL"
        lines.append(
            f"{label}: slo {verdict} p50={slo.get('p50_ms')} "
            f"p90={slo.get('p90_ms')} p99={slo.get('p99_ms')} ms "
            f"vs target {slo.get('target_ms')} ms "
            f"({slo.get('samples', 0)} samples, "
            f"{slo.get('source', '?')})")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="scrape /metrics from every cluster process")
    ap.add_argument("server_dir", nargs="?", default=None,
                    help="server directory with the cluster ini")
    ap.add_argument("--url", action="append", default=[],
                    help="scrape this /metrics url directly (repeatable)")
    ap.add_argument("--buckets", action="store_true",
                    help="include histogram bucket rows")
    ap.add_argument("--costs", action="store_true",
                    help="also dump each process's registered cost "
                         "reports (/costs), not just the SLO verdict")
    ap.add_argument("--strict", action="store_true",
                    help="list every unreachable/404 sub-endpoint "
                         "(costs, residency, audit) on stderr and exit "
                         "nonzero instead of silently skipping it")
    ap.add_argument("--timeout", type=float, default=2.0)
    args = ap.parse_args(argv)

    targets: list[tuple[str, str]] = [
        (u.split("//", 1)[-1].split("/", 1)[0], u) for u in args.url
    ]
    if args.server_dir:
        for name in config_mod.DEFAULT_CONFIG_PATHS:
            p = os.path.join(args.server_dir, name)
            if os.path.exists(p):
                targets += targets_from_config(config_mod.load(p))
                break
        else:
            print(f"no cluster ini under {args.server_dir}",
                  file=sys.stderr)
            return 1
    if not targets:
        print("nothing to scrape: pass a server dir with http_port "
              "configured, or --url", file=sys.stderr)
        return 1

    results, errors = scrape_all(targets, timeout=args.timeout)
    print(merged_table(results, include_buckets=args.buckets))
    # --strict: sub-endpoint failures become findings instead of
    # silent skips (the default stays quiet — old processes are not
    # noise during a rolling upgrade)
    strict_errors: list[str] | None = [] if args.strict else None
    # only re-probe processes the metric scrape already reached — a
    # dead target would otherwise stall a second full timeout here
    costs = scrape_costs([t for t in targets if t[0] in results],
                         timeout=args.timeout, errors=strict_errors)
    if costs:
        print()
        for line in slo_lines(costs):
            print(line)
    # live workload signature + incident counts (debug_http /workload
    # + /incidents; 404/unreachable skipped silently like /costs)
    wl = scrape_workload([t for t in targets if t[0] in results],
                         timeout=args.timeout)
    for line in workload_lines(wl):
        print(line)
    # serve-loop residency verdicts (debug_http /residency;
    # 404/unreachable/tracker-less skipped silently like /costs)
    res = scrape_residency([t for t in targets if t[0] in results],
                           timeout=args.timeout, errors=strict_errors)
    for line in residency_lines(res):
        print(line)
    # entity-ownership censuses (debug_http /audit; utils/audit.py)
    aud = scrape_audit([t for t in targets if t[0] in results],
                       timeout=args.timeout, errors=strict_errors)
    for line in audit_lines(aud):
        print(line)
    if args.costs:
        for label, payload in sorted(costs.items()):
            for name, rep in (payload.get("reports") or {}).items():
                print(f"{label}: cost {name}: "
                      f"{json.dumps(rep, default=str)}")
    for e in errors:
        print(e, file=sys.stderr)
    for e in strict_errors or ():
        print(f"STRICT: {e}", file=sys.stderr)
    return 1 if errors or strict_errors else 0


if __name__ == "__main__":
    sys.exit(main())
