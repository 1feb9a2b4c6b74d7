"""Merge every cluster process's ``/trace`` export into ONE Perfetto JSON.

Each process serves its own Chrome-trace object (tick timeline + RPC/
migration hop spans, ``utils/debug_http.py``); this tool turns them into
a single causally-linked cluster trace:

1. scrape ``/clock`` + ``/trace`` from every process (ports from the
   server dir's ini ``http_port`` keys, or explicit ``--url`` bases);
2. estimate each process's wall-clock offset against the merger's clock
   (request-midpoint method, NTP-style) and shift its event timestamps;
3. re-pid each process onto its own Perfetto process track;
4. synthesize flow arrows from the span linkage carried in event args
   (``span_id``/``parent_id``, written by ``utils/tracing.py``) so a
   traced RPC renders as gate → dispatcher → game arrows across tracks.

Usage::

    python -m goworld_tpu_torch.tools.merge_traces <server_dir> \
        [--out cluster_trace.json]
    python -m goworld_tpu_torch.tools.merge_traces \
        --url http://127.0.0.1:16000 --url http://127.0.0.1:14100

Open the output in https://ui.perfetto.dev ("Open trace file") or
``chrome://tracing``. Driven end-to-end by ``goworld_tpu_torch trace``.

Exit status: 0 if every target answered, 1 otherwise.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
import urllib.error
import urllib.request

from goworld_tpu_torch import config as config_mod


def base_targets_from_config(cfg, host_fallback: str = "127.0.0.1",
                             ) -> list[tuple[str, str]]:
    """(label, base debug-http url) for every process with an
    http_port. Derived from ``scrape_metrics.targets_from_config`` —
    ONE copy of the cluster endpoint-discovery logic (multihost rank
    expansion, host fallback) serves both tools."""
    from goworld_tpu_torch.tools import scrape_metrics as mod

    suffix = "/metrics"
    return [
        (label, url[: -len(suffix)])
        for label, url in mod.targets_from_config(cfg, host_fallback)
    ]


def fetch_json(url: str, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(url,
                                 headers={"Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
        if resp.headers.get("Content-Encoding") == "gzip":
            body = gzip.decompress(body)
    return json.loads(body.decode("utf-8", "replace"))


def _clock_sample(base_url: str, timeout: float = 5.0,
                  ) -> tuple[float, float, float]:
    """One /clock exchange: (offset_us, wall_us, mono_us). ``offset_us``
    is what to SUBTRACT from the process's event timestamps to land on
    the merger's wall clock: ``remote_wall - local_midpoint`` where the
    midpoint halves the request round trip (the classic NTP
    single-exchange estimate; sub-ms on a LAN, exact in-process)."""
    t0 = time.time()
    clock = fetch_json(base_url + "/clock", timeout=timeout)
    t1 = time.time()
    wall = float(clock["wall_us"])
    return wall - (t0 + t1) / 2.0 * 1e6, wall, float(clock["mono_us"])


def estimate_clock_offset(base_url: str, timeout: float = 5.0) -> float:
    return _clock_sample(base_url, timeout=timeout)[0]


# a wall-vs-monotonic disagreement beyond this between the two /clock
# samples bracketing a scrape means the process's wall clock STEPPED
# (NTP correction, VM resume) — its timestamps are suspect
CLOCK_STEP_TOLERANCE_US = 5000.0


def _shift_events(events: list[dict], offset_us: float,
                  pid: int) -> list[dict]:
    out = []
    for ev in events:
        ev = dict(ev)
        ev["pid"] = pid
        if "ts" in ev:
            ev["ts"] = float(ev["ts"]) - offset_us
        out.append(ev)
    return out


def synthesize_flows(events: list[dict]) -> list[dict]:
    """Flow (arrow) events from the span linkage in event args. Perfetto
    binds ``s``/``f`` pairs by id and attaches each to the slice whose
    time range encloses its timestamp."""
    spans: dict[str, dict] = {}
    for ev in events:
        sid = (ev.get("args") or {}).get("span_id")
        if ev.get("ph") == "X" and sid:
            spans[sid] = ev
    flows: list[dict] = []
    for ev in events:
        args = ev.get("args") or {}
        parent_id = args.get("parent_id")
        if ev.get("ph") != "X" or not parent_id:
            continue
        parent = spans.get(parent_id)
        if parent is None:
            continue  # parent span not captured (ring rolled / no scrape)
        fid = int(args["span_id"][:12], 16)  # 48b: JSON-number safe
        flows.append({
            "name": "trace", "cat": "trace", "ph": "s", "id": fid,
            "pid": parent["pid"], "tid": parent["tid"],
            "ts": parent["ts"],
        })
        flows.append({
            "name": "trace", "cat": "trace", "ph": "f", "bp": "e",
            "id": fid, "pid": ev["pid"], "tid": ev["tid"],
            "ts": ev["ts"],
        })
    return flows


def collect(targets: list[tuple[str, str]], timeout: float = 5.0,
            ) -> tuple[dict, list[str]]:
    """Scrape + align + merge; returns (trace object, errors)."""
    events: list[dict] = []
    errors: list[str] = []
    for i, (label, base) in enumerate(targets):
        try:
            # bracket the scrape with two clock exchanges: the paired
            # wall/mono anchors detect a wall-clock step mid-capture
            # (mono never steps), and averaging the two offsets halves
            # the midpoint-estimate noise
            off1, w1, m1 = _clock_sample(base, timeout=timeout)
            trace = fetch_json(base + "/trace", timeout=timeout)
            off2, w2, m2 = _clock_sample(base, timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError,
                KeyError) as e:
            errors.append(f"{label}: {base} unreachable ({e})")
            continue
        step_us = (w2 - w1) - (m2 - m1)
        if abs(step_us) > CLOCK_STEP_TOLERANCE_US:
            errors.append(
                f"{label}: wall clock stepped {step_us / 1e3:.1f} ms "
                "during the scrape — this track's timestamps (and its "
                "flow arrows) are unreliable"
            )
        offset = (off1 + off2) / 2.0
        pid = i + 1  # one Perfetto process track per endpoint — the
        #              real pids collide in standalone/shared hosts
        proc_events = _shift_events(
            trace.get("traceEvents", []), offset, pid
        )
        # make the track identifiable even if the export lacked its
        # process_name metadata
        if not any(ev.get("name") == "process_name"
                   for ev in proc_events):
            proc_events.insert(0, {
                "name": "process_name", "ph": "M", "pid": pid,
                "tid": 0, "args": {"name": label},
            })
        events.extend(proc_events)
    events.extend(synthesize_flows(events))
    return ({"traceEvents": events, "displayTimeUnit": "ms"}, errors)


def write_and_report(merged: dict, errors: list[str],
                     out: str) -> int:
    """Write the merged trace and print the span/flow summary + errors;
    returns the process exit code (shared by ``main`` and the
    ``goworld_tpu_torch trace`` subcommand)."""
    with open(out, "w") as f:
        json.dump(merged, f)
    n_spans = sum(1 for e in merged["traceEvents"]
                  if e.get("ph") == "X")
    n_flows = sum(1 for e in merged["traceEvents"]
                  if e.get("ph") == "s")
    print(f"wrote {out}: {n_spans} spans, {n_flows} flow arrows "
          f"(open in https://ui.perfetto.dev)")
    for e in errors:
        print(e, file=sys.stderr)
    return 1 if errors else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="merge /trace from every cluster process into one "
                    "Perfetto JSON")
    ap.add_argument("server_dir", nargs="?", default=None,
                    help="server directory with the cluster ini")
    ap.add_argument("--url", action="append", default=[],
                    help="debug-http base url (repeatable)")
    ap.add_argument("--out", default="cluster_trace.json")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    targets: list[tuple[str, str]] = [
        (u.split("//", 1)[-1].split("/", 1)[0], u.rstrip("/"))
        for u in args.url
    ]
    if args.server_dir:
        for name in config_mod.DEFAULT_CONFIG_PATHS:
            p = os.path.join(args.server_dir, name)
            if os.path.exists(p):
                targets += base_targets_from_config(config_mod.load(p))
                break
        else:
            print(f"no cluster ini under {args.server_dir}",
                  file=sys.stderr)
            return 1
    if not targets:
        print("nothing to merge: pass a server dir with http_port "
              "configured, or --url", file=sys.stderr)
        return 1

    merged, errors = collect(targets, timeout=args.timeout)
    return write_and_report(merged, errors, args.out)


if __name__ == "__main__":
    sys.exit(main())
