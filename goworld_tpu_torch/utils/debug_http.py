"""Debug/observability HTTP server.

Reference being rebuilt: ``engine/binutil`` (``binutil.go:17-75``) — every
process serves ``net/http/pprof`` + expvar on its ``http_addr``. The
port exposes:

* ``/vars``   — gwvar-style exposed variables (:mod:`opmon` ``expose``)
* ``/ops``    — opmon op stats (count / avg / max per named op)
* ``/metrics``— Prometheus text exposition of the :mod:`metrics` registry
  (the expvar/opmon role, scrapeable: counters, gauges, histograms)
* ``/trace``  — Chrome ``chrome://tracing`` / Perfetto JSON: the per-tick
  phase timeline ring buffer (:data:`metrics.timeline`) merged with the
  distributed-tracing span ring (:data:`tracing.recorder`); gzipped when
  the client sends ``Accept-Encoding: gzip`` (merged cluster traces at
  1M entities are large)
* ``/tracing``— distributed-tracing control: ``?rate=R`` sets the
  process's sample rate, ``?clear=1`` drops recorded spans; always
  returns the current state (driven by ``goworld_tpu_torch trace``)
* ``/clock``  — paired monotonic/wall anchors for cross-process clock
  alignment (:mod:`goworld_tpu_torch.tools.merge_traces`)
* ``/healthz``— liveness probe
* ``/profile``— torch.profiler capture trigger: GET starts a CPU + CUDA
  trace (``?logdir=`` overrides the output dir, ``torch_profile/`` under
  the working directory by default), ``?stop=1`` stops it and writes the
  Chrome trace (``<process>_<pid>_<n>.pt.trace.json``) into the logdir,
  ``?seconds=N`` auto-stops the capture after N seconds (a started
  capture that is never stopped would otherwise hold the per-process
  profiler forever), ``?status=1`` reports without side effects. Nothing
  is profiled until the endpoint is called: a torch.profiler session
  slows the process's later kernel launches, so it is an operator's
  last act before a restart
* ``/costs`` — device-plane cost observability (:mod:`goworld_tpu_torch.
  utils.devprof`): registered :class:`CostReport`s of compiled tick
  executables, lazy analyze providers (run with ``?analyze=1`` —
  a lower+compile costs seconds, so it is operator-triggered), and
  the freshest SLO verdict (recorded, or derived live from the
  ``tick_latency_ms`` histogram)
* ``/workload`` — the live workload signature (:mod:`goworld_tpu_torch.ops.
  telemetry` reducer over the in-graph telemetry lanes the serving
  tick accumulates on device): churn/density/event/skew classes +
  the ``[gameN]`` kernel-config recommendation
* ``/incidents`` — the incident flight recorder (:mod:`goworld_tpu_torch.
  utils.flightrec`): frozen snapshot bundles (SLO breach, overload
  transition, oracle anomaly, signature change) with their per-tick
  frame tails; ``?frames=1`` includes the live ring too
* ``/faults`` — fault-injection plane state (:mod:`goworld_tpu_torch.utils.
  faults`): seed, per-rule trial counts and the deterministic fired
  log; ``{"active": false}`` when no schedule is installed
* ``/overload`` — overload-protection plane state (:mod:`goworld_tpu_torch.
  utils.overload`): every registered governor's ladder state and
  transition log, circuit breaker states, per-class shed counters
* ``/governor`` — online kernel-governor state (:mod:`goworld_tpu_torch.
  autotune`): current/pending config key, the deterministic swap +
  decision logs, warm-set compile states, regret-guard status and the
  freshest signature the policy judged
* ``/syncage`` — the end-to-end sync-age plane (:mod:`goworld_tpu_torch.
  utils.syncage`): per-gate age-at-delivery percentiles (e2e + per
  hop) AND the raw bucket count vectors so the deployment aggregator
  (:mod:`goworld_tpu_torch.tools.obs_aggregate` / ``cli.py watch``)
  can merge
  histograms exactly; an honest error on processes that age nothing
* ``/residency`` — the serve-loop residency plane (:mod:`goworld_tpu_torch.
  utils.residency`): per-world host-bubble/phase percentiles with raw
  mergeable count vectors, alloc-churn samples, the donation-readiness
  buffer census and the serve_gap verdict; an honest error on
  processes that tick no world
* ``/audit`` — the correctness audit plane (:mod:`goworld_tpu_torch.utils.
  audit`): per-game entity-ownership census digests (count + CRC fold
  per type) with the in-flight migration window, sampled AOI-oracle /
  mirror-probe / snapshot-scrub stats and the violation rings;
  ``?eids=1`` adds the (bounded) sorted EntityID lists for diffing a
  census divergence down to the first differing id; an honest error
  on processes that track no entities
* ``/standby`` — the hot-standby replication plane (:mod:`goworld_tpu_torch.
  replication.standby`): per-standby applied seq/tick, stream bytes,
  reject counts by torn-stream reason, last-keyframe age and a
  sync-age-style staleness verdict (lag ticks vs budget);
  ``?promote=1`` (optionally ``&epoch=E``) is the supervisor's
  promotion poke; an honest error on processes that mirror nothing
* ``/rebalance`` — the self-healing rebalance plane (:mod:`goworld_tpu_torch.
  rebalance`): per-game handoff agents (active job, queue/unacked
  depth, move/abort counters by cause) and the controller's policy
  state + decision-log tail where one runs; ``?handoff=GAMEID``
  (optionally ``&batch=N``) pokes a bounded manual cohort drain on
  this process's agent

http.server on a daemon thread, one call to :func:`start`.
"""

from __future__ import annotations

import gzip as _gzip
import json
import math
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from goworld_tpu_torch.utils import log, metrics, opmon, tracing

logger = log.get("debug_http")

_ENDPOINTS = ["/healthz", "/vars", "/ops", "/metrics", "/trace",
              "/tracing", "/clock", "/profile", "/faults", "/overload",
              "/costs", "/workload", "/incidents", "/governor",
              "/syncage", "/residency", "/audit", "/standby",
              "/rebalance"]

# torch.profiler capture state (one capture at a time per process)
_profile_lock = threading.Lock()
_profile_dir: str | None = None
_profiler = None
_profile_name = "goworld_tpu_torch"
# monotonically bumped per start: the ?seconds auto-stop timer only
# fires for ITS capture (a manual stop + fresh start must not be
# killed by a stale timer)
_profile_gen = 0
# torch.profiler must start and stop on one thread, and it records the
# CPU ops of the thread that starts it: a game posts both onto its logic
# thread (set_profile_thread(world.post_q.post)); other processes run
# them on one worker thread of this module
_profile_post = None
_OWNER_TIMEOUT_S = 60.0


def set_profile_thread(post) -> None:
    """Run ``/profile``'s start and stop through ``post(fn)``, which
    must call ``fn()`` on the thread whose work is to be profiled (a
    game passes ``world.post_q.post``: its logic thread drains it every
    tick)."""
    global _profile_post
    _profile_post = post


def _worker_post():
    import queue

    q: queue.Queue = queue.Queue()

    def loop() -> None:
        while True:
            q.get()()

    threading.Thread(target=loop, name="debug-http-profiler",
                     daemon=True).start()
    return q.put


def _on_owner(fn):
    """Run ``fn`` on the profiling thread and return its result (its
    exception re-raised here); TimeoutError if the thread does not get
    to it within ``_OWNER_TIMEOUT_S``."""
    global _profile_post
    if _profile_post is None:
        _profile_post = _worker_post()
    done = threading.Event()
    box: list = []

    def run() -> None:
        try:
            box.append((True, fn()))
        except BaseException as exc:  # handed back to the caller
            box.append((False, exc))
        done.set()

    _profile_post(run)
    if not done.wait(_OWNER_TIMEOUT_S):
        raise TimeoutError("the profiling thread did not run the request")
    ok, val = box[0]
    if not ok:
        raise val
    return val


def merged_trace(process_name: str) -> dict:
    """The tick timeline's Chrome trace with the span recorder's events
    (RPC/migration hop spans, one named track per service) appended —
    one JSON object per process, merged cluster-wide by
    :mod:`goworld_tpu_torch.tools.merge_traces`."""
    obj = metrics.timeline.chrome_trace(process_name)
    obj["traceEvents"].extend(
        tracing.recorder.chrome_events(os.getpid())
    )
    return obj


def _stop_capture() -> str:
    """Stop the running capture and write its Chrome trace into the
    logdir; the trace's path. Called with ``_profile_lock`` held."""
    global _profiler, _profile_dir
    prof, d = _profiler, _profile_dir
    _profiler, _profile_dir = None, None
    path = os.path.join(
        d, f"{_profile_name}_{os.getpid()}_{_profile_gen}.pt.trace.json")

    def stop() -> None:
        prof.stop()
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(path)

    _on_owner(stop)
    return path


def _profile_auto_stop(gen: int) -> None:
    """Timer body for ``?seconds=N``: stop the capture IF it is still
    the one that armed this timer (generation check — a manual stop +
    restart must never be killed by a stale timer)."""
    with _profile_lock:
        if _profile_dir is None or gen != _profile_gen:
            return
        try:
            path = _stop_capture()
        except Exception as exc:  # the capture is still torn down
            logger.warning("profile auto-stop failed: %s", exc)
            return
        logger.info("profile auto-stopped -> %s", path)


def _profile_action(query: dict) -> tuple[dict, int]:
    """Start/stop a torch.profiler capture; (json body, status)."""
    global _profile_dir, _profile_gen, _profiler
    try:
        import torch
        from torch import profiler as torch_profiler
    except Exception:
        return ({"error": "torch.profiler unavailable in this process"},
                501)
    # presence of the key counts (`?stop` and `?stop=1` both stop)
    stop = "stop" in query and query["stop"][0] not in ("0", "false")
    status = "status" in query and query["status"][0] not in ("0",
                                                              "false")
    with _profile_lock:
        if status:
            return ({"active": _profile_dir is not None,
                     "logdir": _profile_dir}, 200)
        if stop:
            if _profile_dir is None:
                return ({"error": "no capture in progress"}, 409)
            d = _profile_dir
            try:
                _stop_capture()
            except Exception as exc:
                return ({"error": f"stop failed: {exc}"}, 500)
            return ({"ok": True, "stopped": True, "logdir": d}, 200)
        if _profile_dir is not None:
            return ({"error": "capture already in progress",
                     "logdir": _profile_dir}, 409)
        seconds = 0.0
        if "seconds" in query:
            # parse BEFORE starting: a bad value must not leave a
            # capture running with no auto-stop armed
            try:
                seconds = float(query["seconds"][0])
            except ValueError:
                return ({"error": "seconds must be a number"}, 400)
            # reject non-finite too: Timer(nan) fires immediately and
            # Timer(inf) never — both defeat the auto-stop guarantee
            # this parameter exists to provide
            if not math.isfinite(seconds) or seconds <= 0:
                return ({"error": "seconds must be a finite number "
                                  "> 0"}, 400)
        logdir = query.get("logdir", [""])[0] or os.path.join(
            os.getcwd(), "torch_profile"
        )
        acts = [torch_profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch_profiler.ProfilerActivity.CUDA)

        def start():
            prof = torch_profiler.profile(activities=acts)
            prof.start()
            return prof

        try:
            _profiler = _on_owner(start)
        except Exception as exc:
            return ({"error": f"profiler start failed: {exc}"}, 500)
        _profile_dir = logdir
        _profile_gen += 1
        body = {"ok": True, "started": True, "logdir": logdir}
        if seconds:
            t = threading.Timer(seconds, _profile_auto_stop,
                                args=(_profile_gen,))
            t.daemon = True
            t.start()
            body["auto_stop_s"] = seconds
        return (body, 200)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # keep request noise out of server logs
        pass

    def _body(self, body: bytes, ctype: str, code: int = 200,
              gzip_ok: bool = False) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        if gzip_ok and "gzip" in \
                self.headers.get("Accept-Encoding", ""):
            body = _gzip.compress(body)
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._body(json.dumps(obj, indent=2, default=str).encode(),
                   "application/json", code)

    def do_GET(self):  # noqa: N802 (stdlib api)
        path, _, qs = self.path.partition("?")
        # keep_blank_values: `?stop` / `?clear` (no value) must count
        query = urllib.parse.parse_qs(qs, keep_blank_values=True)
        if path == "/healthz":
            self._json({"ok": True})
        elif path == "/vars":
            self._json(opmon.vars())
        elif path == "/ops":
            self._json(opmon.monitor.snapshot())
        elif path == "/metrics":
            self._body(metrics.REGISTRY.expose_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/trace":
            self._body(
                json.dumps(merged_trace(
                    getattr(self.server, "process_name", "goworld_tpu_torch")
                )).encode(),
                "application/json",
                gzip_ok=True,
            )
        elif path == "/tracing":
            if "rate" in query:
                try:
                    tracing.set_sample_rate(float(query["rate"][0]))
                except ValueError:
                    self._json({"error": "rate must be a float"}, 400)
                    return
            if "clear" in query \
                    and query["clear"][0] not in ("0", "false"):
                tracing.recorder.clear()
            self._json({"rate": tracing.sample_rate(),
                        "spans": len(tracing.recorder)})
        elif path == "/clock":
            # both clocks sampled back to back: the merge tool pairs
            # them with its own request midpoint to estimate this
            # process's wall-clock offset
            self._json({
                "wall_us": time.time() * 1e6,
                "mono_us": time.monotonic() * 1e6,
                "pid": os.getpid(),
                "process_name": getattr(self.server, "process_name",
                                        "goworld_tpu_torch"),
            })
        elif path == "/profile":
            body, code = _profile_action(query)
            self._json(body, code)
        elif path == "/faults":
            # fault-injection plane state: per-rule trial counts + the
            # deterministic fired-trial log (utils/faults.py; chaos
            # runs scrape this to verify seeded replay)
            from goworld_tpu_torch.utils import faults

            self._json(faults.snapshot())
        elif path == "/overload":
            # overload ladder state, per-class shed counters and
            # circuit breakers (utils/overload.py)
            from goworld_tpu_torch.utils import overload

            self._json(overload.snapshot())
        elif path == "/costs":
            # device-plane cost reports + SLO verdict (utils/devprof):
            # ?analyze=1 runs the registered lazy providers (a
            # lower+compile of the live tick — seconds, so opt-in)
            from goworld_tpu_torch.utils import devprof

            analyze = "analyze" in query \
                and query["analyze"][0] not in ("0", "false")
            self._json(devprof.snapshot(analyze=analyze))
        elif path == "/workload":
            # live workload signature (ops/telemetry reducer over the
            # serving tick's device lanes; utils/flightrec registry)
            from goworld_tpu_torch.utils import flightrec

            self._json(flightrec.workload_snapshot())
        elif path == "/governor":
            # online kernel-governor state (goworld_tpu_torch/autotune):
            # swap/decision logs, warm-set states, regret guard
            from goworld_tpu_torch.autotune import governor as autotune_gov

            self._json(autotune_gov.snapshot())
        elif path == "/syncage":
            # end-to-end sync-age plane (utils/syncage registry):
            # percentiles + mergeable raw count vectors per tracker
            from goworld_tpu_torch.utils import syncage

            self._json(syncage.snapshot_all())
        elif path == "/residency":
            # serve-loop residency plane (utils/residency registry):
            # bubble/phase percentiles + mergeable count vectors,
            # alloc churn, buffer census and serve_gap per world
            from goworld_tpu_torch.utils import residency

            self._json(residency.snapshot_all())
        elif path == "/audit":
            # correctness audit plane (utils/audit registry): ledger
            # census digests + in-flight migration window, sampled
            # oracle/probe/scrub stats, violations; ?eids=1 adds the
            # (bounded) sorted EntityID list so a census divergence
            # can be diffed down to the first differing id
            from goworld_tpu_torch.utils import audit

            want_eids = "eids" in query \
                and query["eids"][0] not in ("0", "false")
            self._json(audit.snapshot_all(eids=want_eids))
        elif path == "/standby":
            # hot-standby replication plane (goworld_tpu_torch/
            # replication/standby registry): per-standby lag/bytes/reject
            # stats with a sync-age-style staleness verdict; ?promote=1
            # (optionally &epoch=E) drives the supervisor's promotion
            # poke — the claim itself runs on the game's logic thread
            from goworld_tpu_torch.replication import standby

            if "promote" in query \
                    and query["promote"][0] not in ("0", "false"):
                ep = query.get("epoch", [None])[0]
                self._json(standby.request_promotion(
                    int(ep) if ep not in (None, "") else None))
            else:
                self._json(standby.snapshot_all())
        elif path == "/rebalance":
            # self-healing rebalance plane (goworld_tpu_torch/rebalance
            # registry): per-game handoff agents (active job, move/
            # abort counters) and, on the controller's host, the
            # policy state + decision log tail; ?handoff=GAMEID
            # (optionally &batch=N) pokes a bounded cohort handoff on
            # this process's agent — the operator's manual drain knob,
            # same bookkeeping as an automated move; the start itself
            # is posted onto the game's logic thread
            from goworld_tpu_torch import rebalance

            if "handoff" in query and query["handoff"][0]:
                try:
                    target = int(query["handoff"][0])
                except ValueError:
                    self._json({"error": "handoff wants a game id"},
                               400)
                    return
                batch_q = query.get("batch", [None])[0]
                self._json(rebalance.request_handoff(
                    target,
                    int(batch_q) if batch_q not in (None, "") else None))
            else:
                self._json(rebalance.snapshot())
        elif path == "/incidents":
            # flight-recorder incident bundles (utils/flightrec);
            # ?frames=1 adds the live per-tick frame ring
            from goworld_tpu_torch.utils import flightrec

            frames = "frames" in query \
                and query["frames"][0] not in ("0", "false")
            self._json(flightrec.snapshot_all(frames=frames))
        else:
            self._json({"error": "not found",
                        "endpoints": _ENDPOINTS}, 404)


def start(port: int, host: str = "127.0.0.1",
          process_name: str = "goworld_tpu_torch") -> ThreadingHTTPServer:
    """Serve debug endpoints on a daemon thread; returns the server (its
    bound port is ``server.server_address[1]`` when ``port=0``).
    ``process_name`` labels the ``/trace`` export and the ``/profile``
    trace files (e.g. ``game1``)."""
    global _profile_name
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.process_name = process_name  # type: ignore[attr-defined]
    _profile_name = process_name
    t = threading.Thread(target=srv.serve_forever,
                         name=f"debug-http-{port}", daemon=True)
    t.start()
    logger.info("debug http on %s:%d", host, srv.server_address[1])
    return srv
