"""Deterministic, seeded fault-injection plane.

The reference engine's resilience story (connect-forever dispatcher
links, freeze/restore, disconnect census cleanup) is only trustworthy if
its failure branches can be *exercised on demand*. This module makes
failure a first-class, reproducible input the same way the metrics
registry made latency a first-class output: a seeded schedule of faults
injected at the transport and storage seams, every injection counted in
the metrics registry (``faults_injected_total{kind,edge}``), stamped
into the distributed-tracing span ring (``fault:<kind>`` instants on the
``faults`` track, parented to the victim packet's span when traced) and
recorded in a deterministic per-rule log served at debug-http
``/faults``.

Schedule grammar (full reference: ``docs/ROBUSTNESS.md``)::

    spec  := rule ("," rule)*
    wire  := kind ":" edge [":mt=" N] ":" prob [":" D "ms"]
             kind  = drop | dup | delay | truncate | disconnect
             edge  = src "->" dst      (role tokens or "*")
    kill  := "kill:" process "@t+" SECS "s"
    err   := "err:" subsys "." op ":" prob        subsys = kvdb | storage
    crash := "crash:" point (":" prob | "@n=" N)

Examples::

    drop:gate->dispatcher:0.05            5% of gate->dispatcher packets
    delay:game->dispatcher:mt=13:0.5:20ms delay half the client RPCs 20ms
    kill:game1@t+10s                      SIGKILL-equivalent 10s in
    err:kvdb.put:0.2                      20% of kvdb puts raise
    crash:game.tick@n=600                 die at the 600th game tick

Determinism contract: every rule owns a ``random.Random`` seeded from
``crc32(seed | rule-text)``; decisions are a pure function of the rule's
own trial counter, so two runs whose matching call sites see the same
number of trials produce **byte-identical** per-rule fault logs (the
trial indices at which each rule fired). Wall-clock enters only through
``kill:...@t+...`` timers, which log without a trial index.

Activation: :func:`install` is called at process boot (``api.run`` for
games, the CLI runners for dispatchers/gates) with the process label and
the ini ``[deployment] faults`` / ``faults_seed`` values; the
``GOWORLD_FAULTS`` / ``GOWORLD_FAULTS_SEED`` environment variables
override the ini. No spec -> the module stays inert and every hook is a
single module-bool load.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from random import Random

from goworld_tpu_torch.utils import log, metrics

logger = log.get("faults")

# exit code used by injected kills/crashes: distinguishable from clean
# exit (0) and the freeze exit (consts.FREEZE_EXIT_CODE) in supervisor
# logs
KILL_EXIT_CODE = 86

WIRE_KINDS = ("drop", "dup", "delay", "truncate", "disconnect")

# module fast-path flag + active plane (the tracing.active idiom: hot
# call sites check one bool before touching anything else)
active = False
plane: "FaultPlane | None" = None


class InjectedFaultError(ConnectionError):
    """Raised by op-fault hooks (``err:...`` rules). Subclasses
    ConnectionError so the kvdb/storage retry wrappers treat it exactly
    like a real transient backend failure."""


class FaultRule:
    """One parsed rule; owns its RNG, trial counter and fired log."""

    __slots__ = ("text", "kind", "src", "dst", "msgtype", "prob",
                 "delay_s", "target", "at_s", "subsys", "op", "point",
                 "at_n", "_rng", "trials", "fired", "_counter")

    def __init__(self, text: str):
        self.text = text
        self.kind = ""
        self.src = self.dst = "*"
        self.msgtype: int | None = None
        self.prob = 0.0
        self.delay_s = 0.0
        self.target = ""          # kill: process label
        self.at_s: float | None = None
        self.subsys = self.op = ""  # err rules
        self.point = ""           # crash rules
        self.at_n: int | None = None
        self._rng: Random | None = None
        self.trials = 0
        self.fired: list[int] = []
        self._counter: metrics.Counter | None = None

    # -- deterministic decision ----------------------------------------
    def seed_with(self, seed: int) -> None:
        self._rng = Random(zlib.crc32(f"{seed}|{self.text}".encode()))

    def decide(self) -> int | None:
        """Count one trial; return the trial index if the rule fires."""
        n = self.trials
        self.trials += 1
        if self.at_n is not None:
            hit = (n + 1) == self.at_n
        else:
            hit = self._rng.random() < self.prob
        if not hit:
            return None
        self.fired.append(n)
        return n

    def matches_edge(self, edge: str, msgtype: int) -> bool:
        if self.msgtype is not None and msgtype != self.msgtype:
            return False
        sep = edge.find("->")
        if sep < 0:
            return False
        src, dst = edge[:sep], edge[sep + 2:]
        return (self.src in ("*", src)) and (self.dst in ("*", dst))


def _parse_rule(text: str) -> FaultRule:
    r = FaultRule(text)
    kind, _, rest = text.partition(":")
    r.kind = kind
    if kind == "kill":
        # kill:<process>@t+<secs>s
        target, at, ts = rest.partition("@t+")
        if not at or not ts.endswith("s"):
            raise ValueError(f"bad kill rule {text!r} "
                             "(want kill:<proc>@t+<secs>s)")
        r.target = target
        r.at_s = float(ts[:-1])
        return r
    if kind == "crash":
        # crash:<point>:<p>  |  crash:<point>@n=<N>
        point, at, n = rest.partition("@n=")
        if at:
            r.point = point
            r.at_n = int(n)
        else:
            point, _, p = rest.rpartition(":")
            if not point:
                raise ValueError(f"bad crash rule {text!r}")
            r.point = point
            r.prob = float(p)
        return r
    if kind == "err":
        # err:<subsys>.<op>:<p>
        target, _, p = rest.rpartition(":")
        subsys, dot, op = target.partition(".")
        if not dot or subsys not in ("kvdb", "storage"):
            raise ValueError(f"bad err rule {text!r} "
                             "(want err:kvdb|storage.<op>:<p>)")
        r.subsys, r.op = subsys, op
        r.prob = float(p)
        return r
    if kind not in WIRE_KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {text!r}")
    parts = rest.split(":")
    if len(parts) < 2:
        raise ValueError(f"bad {kind} rule {text!r} "
                         f"(want {kind}:<edge>[:mt=<N>]:<p>)")
    edge = parts.pop(0)
    src, sep, dst = edge.partition("->")
    if not sep:
        raise ValueError(f"bad edge {edge!r} in {text!r} (want src->dst)")
    r.src, r.dst = src or "*", dst or "*"
    if parts and parts[0].startswith("mt="):
        r.msgtype = int(parts.pop(0)[3:])
    if not parts:
        raise ValueError(f"missing probability in {text!r}")
    r.prob = float(parts.pop(0))
    if kind == "delay":
        ms = parts.pop(0) if parts else "10ms"
        if not ms.endswith("ms"):
            raise ValueError(f"bad delay {ms!r} in {text!r} (want <N>ms)")
        r.delay_s = float(ms[:-2]) / 1e3
    if parts:
        raise ValueError(f"trailing fields {parts} in {text!r}")
    return r


def parse_schedule(spec: str) -> list[FaultRule]:
    return [_parse_rule(t.strip())
            for t in spec.split(",") if t.strip()]


class FaultPlane:
    """The per-process injection engine: parsed rules + seed + log."""

    def __init__(self, rules: list[FaultRule], seed: int,
                 process: str = ""):
        self.rules = rules
        self.seed = seed
        self.process = process
        self.injected_total = 0
        self._lock = threading.Lock()
        self._timers: list[threading.Timer] = []
        # a test can intercept kills/crashes instead of dying
        self.exit_hook = None
        self._wire_rules = [r for r in rules if r.kind in WIRE_KINDS]
        for r in rules:
            r.seed_with(seed)
            if r.kind in WIRE_KINDS:
                r._counter = metrics.counter(
                    "faults_injected_total",
                    help="injected faults by kind and edge",
                    kind=r.kind, edge=f"{r.src}->{r.dst}",
                )
            elif r.kind == "err":
                r._counter = metrics.counter(
                    "faults_injected_total",
                    kind="err", edge=f"{r.subsys}.{r.op}",
                )
            else:
                r._counter = metrics.counter(
                    "faults_injected_total",
                    kind=r.kind, edge=r.target or r.point,
                )

    # -- lifecycle ------------------------------------------------------
    def start_timers(self) -> None:
        """Arm ``kill:<proc>@t+...`` rules matching this process."""
        for r in self.rules:
            if r.kind == "kill" and r.target == self.process:
                t = threading.Timer(r.at_s, self._timed_kill, (r,))
                t.daemon = True
                t.start()
                self._timers.append(t)

    def stop(self) -> None:
        for t in self._timers:
            t.cancel()

    def _timed_kill(self, rule: FaultRule) -> None:
        with self._lock:
            rule.fired.append(-1)  # wall-clock fault: no trial index
            self.injected_total += 1
        rule._counter.inc()
        logger.error("FAULT kill: %s dies now (%s)", self.process,
                     rule.text)
        self._die()

    def _die(self) -> None:
        if self.exit_hook is not None:
            self.exit_hook()
            return
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)

    # -- wire faults ----------------------------------------------------
    def wire_fault(self, edge: str, msgtype: int, trace_ctx=None,
                   kinds: tuple | None = None) -> FaultRule | None:
        """Consult every wire rule matching (edge, msgtype) in spec
        order; each match consumes one trial. The first rule that fires
        wins (later rules get no trial for this packet, keeping the
        whole decision stream a pure function of the seed)."""
        with self._lock:
            for r in self._wire_rules:
                if kinds is not None and r.kind not in kinds:
                    continue
                if not r.matches_edge(edge, msgtype):
                    continue
                n = r.decide()
                if n is not None:
                    self.injected_total += 1
                    self._note(r, n, edge=edge, msgtype=msgtype,
                               trace_ctx=trace_ctx)
                    return r
        return None

    # -- op faults (kvdb/storage) ---------------------------------------
    def op_fault(self, subsys: str, op: str) -> bool:
        with self._lock:
            for r in self.rules:
                if r.kind != "err" or r.subsys != subsys \
                        or r.op not in ("*", op):
                    continue
                n = r.decide()
                if n is not None:
                    self.injected_total += 1
                    self._note(r, n, edge=f"{subsys}.{op}")
                    return True
        return False

    # -- crashpoints ----------------------------------------------------
    def crash(self, point: str) -> None:
        fired = None
        with self._lock:
            for r in self.rules:
                if r.kind != "crash" or r.point != point:
                    continue
                n = r.decide()
                if n is not None:
                    self.injected_total += 1
                    self._note(r, n, edge=point)
                    fired = r
                    break
        if fired is not None:
            logger.error("FAULT crash at %r (%s)", point, fired.text)
            self._die()

    # -- observability --------------------------------------------------
    def _note(self, rule: FaultRule, trial: int, edge: str = "",
              msgtype: int | None = None, trace_ctx=None) -> None:
        """Count + trace-stamp one injection (lock held by caller)."""
        rule._counter.inc()
        # stamp the span ring so /trace exports show the injection as a
        # zero-duration instant; parent it to the victim packet's span
        # when the packet was traced
        from goworld_tpu_torch.utils import tracing

        ctx = (trace_ctx.child() if trace_ctx is not None
               else tracing.new_trace())
        args = {"rule": rule.text, "trial": trial}
        if msgtype is not None:
            args["msgtype"] = msgtype
        tracing.recorder.record(
            f"fault:{rule.kind}", f"faults:{self.process or edge}", ctx,
            trace_ctx.span_hex if trace_ctx is not None else None,
            time.time() * 1e6, 0.0, args,
        )

    def log_lines(self) -> list[str]:
        """Deterministic per-rule fault log: one line per rule in spec
        order listing the trial indices that fired (``-1`` marks a
        wall-clock kill). Byte-identical across runs with the same seed
        and per-rule trial counts."""
        with self._lock:
            return [
                f"{r.text} -> "
                + ",".join(str(n) for n in r.fired)
                for r in self.rules
            ]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": True,
                "process": self.process,
                "seed": self.seed,
                "injected_total": self.injected_total,
                "rules": [
                    {"rule": r.text, "trials": r.trials,
                     "fired": list(r.fired)}
                    for r in self.rules
                ],
            }


# =======================================================================
# module-level install + hooks (the call-site API)
# =======================================================================
def install(process: str, spec: str = "", seed: int = 0,
            ) -> FaultPlane | None:
    """Install the process-wide plane from an ini spec, overridable by
    ``GOWORLD_FAULTS`` / ``GOWORLD_FAULTS_SEED``. Returns None (and
    leaves the module inert) when no spec is configured anywhere."""
    global active, plane
    env_spec = os.environ.get("GOWORLD_FAULTS")
    if env_spec is not None:
        spec = env_spec
    env_seed = os.environ.get("GOWORLD_FAULTS_SEED")
    if env_seed:
        seed = int(env_seed)
    if not spec.strip():
        return None
    plane = FaultPlane(parse_schedule(spec), seed, process=process)
    active = True
    plane.start_timers()
    logger.warning(
        "fault injection ACTIVE in %s: seed=%d spec=%s", process, seed,
        spec,
    )
    return plane


def uninstall() -> None:
    """Deactivate (tests)."""
    global active, plane
    if plane is not None:
        plane.stop()
    plane = None
    active = False


def maybe_op_fault(subsys: str, op: str) -> None:
    """kvdb/storage op seam: raise a transient error when an ``err``
    rule fires. One module-bool load when inert."""
    if active and plane is not None and plane.op_fault(subsys, op):
        raise InjectedFaultError(
            f"injected {subsys}.{op} fault (seed {plane.seed})"
        )


def maybe_crash(point: str) -> None:
    """Named crashpoint (e.g. ``freeze.write``, ``game.tick``): the
    process dies here when a ``crash`` rule fires."""
    if active and plane is not None:
        plane.crash(point)


def kcp_loss_hook(edge: str):
    """Datagram-level injection for the KCP (reliable-UDP) edge: returns
    a ``loss_hook(datagram) -> bool`` for :mod:`goworld_tpu_torch.net.kcp`
    (True = drop this datagram), or None when inert or no drop rule
    matches the edge. KCP retransmits, so drops here exercise the ARQ
    path rather than losing packets outright."""
    if not active or plane is None:
        return None
    if not any(r.kind == "drop" and r.matches_edge(edge, 0)
               for r in plane._wire_rules):
        return None

    def hook(_datagram: bytes) -> bool:
        # re-read the module global: the gate captures this hook once,
        # but uninstall() (tests) may clear the plane while KCP
        # sessions are still sending
        p = plane
        if not active or p is None:
            return False
        return p.wire_fault(edge, 0, kinds=("drop",)) is not None

    return hook


def snapshot() -> dict:
    """debug-http ``/faults`` payload."""
    if not active or plane is None:
        return {"active": False}
    s = plane.snapshot()
    s["log"] = plane.log_lines()
    return s
