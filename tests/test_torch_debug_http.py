"""The port's debug HTTP (``goworld_tpu_torch.utils.debug_http``) against
the JAX package's (``goworld_tpu.utils.debug_http``).

Two processes, one a package, script the same state (the same fault
schedule, a World of 64 slots with 12 entities of fixed ids in a space,
6 ticks on the CPU, a standby tracker with a promotion hook and a
handoff agent with its hook registered) and serve it; every endpoint in
``_ENDPOINTS``, the profile status, the standby and rebalance pokes and
an unknown path answer with the same status, content type and body
shape (every key of every object, the kind of every value), the
standby and rebalance planes and their pokes with the same bodies, and
``/metrics`` with the same series names. ``/profile`` drives torch.profiler: it starts, reports
its status, refuses a second start and a bad ``seconds``, stops and
writes a Chrome trace; ``?seconds=`` stops it by itself; and the start
and stop run on the thread the process names."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from goworld_tpu_torch.utils import debug_http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 240

PROBE = r'''
import importlib, json, sys, urllib.error, urllib.request
pkg = sys.argv[1]
kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
if kw:
    import torch
    torch.set_num_threads(1)
dh = importlib.import_module(pkg + ".utils.debug_http")
state = importlib.import_module(pkg + ".core.state")
aoi = importlib.import_module(pkg + ".ops.aoi")
ent = importlib.import_module(pkg + ".entity")
faults = importlib.import_module(pkg + ".utils.faults")
faults.install("game1", spec="drop:gate->client:0.5", seed=3)


class Npc(ent.Entity):
    ATTRS = {"hp": "allclients"}


w = ent.World(state.WorldConfig(capacity=64, grid=aoi.GridSpec(
    radius=20.0, extent_x=100.0, extent_z=100.0)), game_id=1, **kw)
w.register_entity("Npc", Npc)
w.register_space("Arena", ent.Space)
w.create_nil_space()
sp = w.create_space("Arena", eid="arena00000000000")
for i in range(12):
    sp.create_entity("Npc", pos=(5.0 + 7 * i, 0.0, 40.0),
                     eid=f"npc{i:013d}")
for _ in range(6):
    w.tick()
standby = importlib.import_module(pkg + ".replication.standby")
rebalance = importlib.import_module(pkg + ".rebalance")
tr = standby.register("game2", standby.StandbyTracker(
    2, 1, tick_hz=60.0, clock=lambda: 100.0))
tr.note_applied("key", tick=6, seq=0, nbytes=900, apply_ms=1.5)
tr.on_promote = lambda epoch=None: {"status": "claiming",
                                    "epoch": -1 if epoch is None else epoch}
rebalance.register("game1", rebalance.HandoffExecutor(w, game_id=1,
                                                      batch=4))
rebalance.set_handoff_hook(lambda target, batch: {
    "requested": True, "target": f"game{target}", "batch": batch})
srv = dh.start(0, process_name="game1")
port = srv.server_address[1]
out = {}
for ep in [e for e in dh._ENDPOINTS if e != "/profile"] + [
        "/profile?status=1", "/audit?eids=1", "/incidents?frames=1",
        "/standby?promote=1", "/rebalance?handoff=2", "/nope"]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{ep}",
                                    timeout=60) as r:
            code, ctype, body = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, body = e.code, e.headers["Content-Type"], e.read()
    body = body.decode()
    if ctype == "application/json":
        body = json.loads(body)
    out[ep] = [code, ctype, body]
print("RESULT" + json.dumps(out))
'''


def _shape(o):
    """Every key of every object and the kind of every value. A
    percentile past its histogram's last bucket reads "inf" (the
    convention of ``utils/syncage.py`` ``ptiles``): a number's kind."""
    if o == "inf":
        return "number"
    if isinstance(o, dict):
        return {k: _shape(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_shape(o[0])] if o else []
    if isinstance(o, bool):
        return "bool"
    if isinstance(o, (int, float)):
        return "number"
    return "none" if o is None else type(o).__name__


def _series(text: str) -> set:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


@pytest.fixture(scope="module")
def bodies():
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", PROBE, pkg], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("goworld_tpu", "goworld_tpu_torch")}
    out = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=WAIT)
        assert p.returncode == 0, stderr[-3000:]
        out[pkg] = json.loads(stdout[stdout.index("RESULT") + 6:])
    return out["goworld_tpu"], out["goworld_tpu_torch"]


ENDPOINTS = [e for e in debug_http._ENDPOINTS if e != "/profile"] + [
    "/profile?status=1", "/audit?eids=1", "/incidents?frames=1",
    "/standby?promote=1", "/rebalance?handoff=2", "/nope"]


@pytest.mark.parametrize("ep", ENDPOINTS)
def test_endpoint_answers_as_jax(bodies, ep):
    jax, port = bodies
    (jcode, jtype, jbody), (tcode, ttype, tbody) = jax[ep], port[ep]
    assert (tcode, ttype) == (jcode, jtype)
    if ep == "/metrics":
        assert _series(tbody) == _series(jbody)
        assert _series(tbody)
    else:
        assert _shape(tbody) == _shape(jbody)
    if ep in ("/standby", "/standby?promote=1", "/rebalance",
              "/rebalance?handoff=2"):
        # the planes and their pokes run on the port: the same bodies
        assert tbody == jbody
        assert "error" not in tbody
    if ep == "/audit?eids=1":
        assert tbody == jbody  # the same census of the same ids


def test_endpoint_list_is_the_jax_list():
    from goworld_tpu.utils import debug_http as jdebug_http

    assert debug_http._ENDPOINTS == jdebug_http._ENDPOINTS


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Pump:
    """A stand-in logic thread that drains posted callbacks, as a
    game's tick loop drains ``world.post_q``."""

    def __init__(self):
        self.q: list = []
        self.threads: set = set()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def post(self, fn) -> None:
        self.q.append(fn)

    def _run(self) -> None:
        while not self._stop.is_set():
            while self.q:
                self.threads.add(threading.get_ident())
                self.q.pop(0)()
            time.sleep(0.01)

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=10)


@pytest.fixture()
def server(tmp_path):
    pump = _Pump()
    debug_http.set_profile_thread(pump.post)
    srv = debug_http.start(0, process_name="game9")
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", pump
    finally:
        srv.shutdown()
        pump.close()
        debug_http.set_profile_thread(None)


def test_profile_starts_reports_and_stops(server, tmp_path):
    base, pump = server
    logdir = str(tmp_path / "prof")
    assert _get(base, "/profile?status=1") == (
        200, {"active": False, "logdir": None})
    assert _get(base, "/profile?stop=1")[0] == 409
    assert _get(base, "/profile?seconds=nan")[0] == 400
    code, body = _get(base, f"/profile?logdir={logdir}")
    assert (code, body) == (200, {"ok": True, "started": True,
                                  "logdir": logdir})
    assert _get(base, "/profile?status=1") == (
        200, {"active": True, "logdir": logdir})
    assert _get(base, "/profile")[0] == 409
    import torch

    (torch.ones(64) * 2).sum()  # some work on the profiled thread
    assert _get(base, "/profile?stop=1") == (
        200, {"ok": True, "stopped": True, "logdir": logdir})
    traces = glob.glob(os.path.join(logdir, "game9_*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert "traceEvents" in json.load(f)
    assert len(pump.threads) == 1  # start and stop ran on the pump
    assert _get(base, "/profile?status=1")[1]["active"] is False


def test_profile_seconds_stops_by_itself(server, tmp_path):
    base, _ = server
    logdir = str(tmp_path / "auto")
    code, body = _get(base, f"/profile?seconds=0.5&logdir={logdir}")
    assert code == 200 and body["auto_stop_s"] == 0.5
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline \
            and _get(base, "/profile?status=1")[1]["active"]:
        time.sleep(0.1)
    assert glob.glob(os.path.join(logdir, "game9_*.pt.trace.json"))
