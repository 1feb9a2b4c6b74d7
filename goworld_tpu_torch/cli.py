"""Ops CLI — ``python -m goworld_tpu_torch start|stop|kill|reload|status
<dir>``, the port of the JAX package's ``python -m goworld_tpu``.

Reference being rebuilt: ``cmd/goworld`` (``main.go:22-61``): the operator
tool that starts a whole cluster from one server directory (dispatchers,
then games, then gates — ``start.go:17-114``), stops it in reverse order
(``stop.go:11-90``), hot-reloads games via SIGHUP + ``-restore`` restart
(``reload.go:10-34``), and reports process status (``status.go:14-116``).

Differences from the reference, by design:

* ``build`` compiles the native C++ cores (into ``goworld_tpu_torch/
  _build/``, :mod:`goworld_tpu_torch.native`) + bytecode instead of Go
  binaries (games are Python scripts; ``cmd_build``); the CUDA kernels
  still build at first use (:mod:`goworld_tpu_torch.kernels`);
* liveness is tracked with pid files under ``<dir>/run/`` instead of
  scanning the process table (same observable behavior, simpler and safer);
* readiness still uses the supervisor tag printed to each process's log
  (reference ``consts.go:108-112`` + ``start.go:98-114``).

Arguments and exit codes are the JAX package's. A game of several
controller processes (``[gameN] mesh_processes > 1``) starts as that
many OS processes (pid labels ``gameNcR``), one controller group with a
rendezvous port of its own; ``stop``, ``status`` and ``kill`` act on
each, ``reload`` freezes it through its leader and restarts the whole
group with ``-restore``, ``watchdog`` tears down a group with a dead
rank and restarts it whole, and ``start`` refuses to heal a partial
group. A hot standby
(``[gameN] standby_of``) starts with the other games; ``watchdog``
promotes it through its ``/standby?promote=1`` when its primary dies,
and falls back to a cold restore when the standby is dead too.
``status``, ``watch``,
``trace`` and ``incidents`` read the processes' debug HTTP through the
port's own tools (:mod:`goworld_tpu_torch.tools`).

A server directory contains:

* the game script, which registers types and calls
  ``goworld_tpu_torch.run()``: ``[deployment] entry`` names it, else
  ``server_torch.py`` where the directory has one, else ``server.py``.
  ``run()`` puts the World on the card unless the script passes
  ``device="cpu"``. A script that imports the JAX package
  (``goworld_tpu``) is refused with ``ValueError`` naming it, before
  anything is spawned;
* ``goworld_tpu_torch.ini``, ``goworld_tpu.ini`` or ``goworld.ini`` — the
  cluster config.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import time

from goworld_tpu_torch import config as config_mod
from goworld_tpu_torch.utils import log
from goworld_tpu_torch.utils.consts import (
    SUPERVISOR_STARTED_TAG,
)

_CONFIG_NAMES = config_mod.DEFAULT_CONFIG_PATHS
_DEFAULT_ENTRY = "server.py"


# =======================================================================
# server-dir helpers
# =======================================================================
def _find_config(server_dir: str) -> str | None:
    for name in _CONFIG_NAMES:
        p = os.path.join(server_dir, name)
        if os.path.exists(p):
            return p
    return None


def _run_dir(server_dir: str) -> str:
    d = os.path.join(server_dir, "run")
    os.makedirs(d, exist_ok=True)
    return d


def _pid_path(server_dir: str, role: str, idx: int) -> str:
    return os.path.join(_run_dir(server_dir), f"{role}{idx}.pid")


def _log_path(server_dir: str, role: str, idx: int) -> str:
    return os.path.join(_run_dir(server_dir), f"{role}{idx}.log")


def _read_pid(server_dir: str, role: str, idx: int) -> int | None:
    try:
        with open(_pid_path(server_dir, role, idx)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _has_pidfile(server_dir: str, role: str, idx) -> bool:
    """A pidfile distinguishes a CRASH (file present, process dead —
    clean stops unlink it) from never-started / deliberately stopped."""
    return os.path.exists(_pid_path(server_dir, role, idx))


def _maintenance_path(server_dir: str) -> str:
    return os.path.join(_run_dir(server_dir), "maintenance.lock")


class _maintenance:
    """Scoped marker that a deliberate ops action (stop/reload) is in
    flight: the watchdog skips scans while it exists, so it never races
    a reload's own freeze-exit-restart cycle. Stale locks (a killed CLI)
    expire after 10 minutes."""

    def __init__(self, server_dir: str):
        self._p = _maintenance_path(server_dir)

    def __enter__(self):
        with open(self._p, "w") as f:
            f.write(str(os.getpid()))
        return self

    def __exit__(self, *exc):
        try:
            os.unlink(self._p)
        except OSError:
            pass


def _maintenance_touch(server_dir: str) -> None:
    """Refresh the lock's mtime: long operations (a reload of many
    games can exceed the 10-minute staleness window) call this between
    phases so the watchdog keeps standing down."""
    try:
        os.utime(_maintenance_path(server_dir))
    except OSError:
        pass


def _in_maintenance(server_dir: str) -> bool:
    try:
        age = time.time() - os.path.getmtime(_maintenance_path(server_dir))
    except OSError:
        return False
    return age < 600.0


def _alive(pid: int | None) -> bool:
    if pid is None:
        return False
    try:
        # reap if it's an exited child of this process (a long-lived
        # caller — e.g. a test harness — would otherwise see a zombie
        # and conclude the process never exited)
        os.waitpid(pid, os.WNOHANG)
    except (ChildProcessError, OSError):
        pass
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        # kill(0) also succeeds for zombies we cannot reap; check state
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(") ", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        return True  # no /proc (non-linux): kill(0) verdict stands


def _entry_script(cfg: config_mod.ClusterConfig, server_dir: str) -> str:
    """``[deployment] entry``; without it the port's script
    ``server_torch.py`` where the directory has one, else ``server.py``
    (the stock example directories hold both packages' scripts). A
    script that imports the JAX package is refused (:func:`_check_entry`)."""
    entry = getattr(cfg, "entry", None) or _DEFAULT_ENTRY
    if entry == _DEFAULT_ENTRY and os.path.exists(
            os.path.join(server_dir, "server_torch.py")):
        entry = "server_torch.py"
    path = os.path.join(server_dir, entry)
    _check_entry(path)
    return path


def _jax_imports(source: str) -> list[str]:
    """The modules of the JAX package (``goworld_tpu``, ``goworld_tpu.*``)
    that a script's source imports."""
    import ast

    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        out += [n for n in names
                if n == "goworld_tpu" or n.startswith("goworld_tpu.")]
    return out


def _check_entry(path: str) -> None:
    """Refuse, before anything is spawned, a game script that imports the
    JAX package: this CLI serves the port (``goworld_tpu_torch``) only."""
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError:
        return  # a missing script is reported by the command itself
    try:
        found = _jax_imports(source)
    except SyntaxError:
        return  # the game process reports it in its log
    if found:
        raise ValueError(
            f"game script {path} imports the JAX package "
            f"({', '.join(sorted(set(found)))}); the port's CLI runs "
            "scripts on goworld_tpu_torch (write a server_torch.py, or "
            "run it with python -m goworld_tpu)")


def _group_labels(cfg: config_mod.ClusterConfig, gid: int):
    """(n_procs, pid-labels) for one game: a game with
    ``mesh_processes > 1`` is ONE logical game run as that many SPMD
    controller processes (rank-labelled pidfiles ``gameNcR``)."""
    procs = max(1, getattr(cfg.games[gid], "mesh_processes", 1))
    return procs, [gid if procs == 1 else f"{gid}c{r}"
                   for r in range(procs)]


def _game_instances(cfg: config_mod.ClusterConfig):
    """One (gid, rank, n_procs, pid-label) per game OS process."""
    out = []
    for gid in sorted(cfg.games):
        procs, labels = _group_labels(cfg, gid)
        for rank, label in enumerate(labels):
            out.append((gid, rank, procs, label))
    return out


def _game_labels(cfg: config_mod.ClusterConfig) -> list:
    return [label for _, _, _, label in _game_instances(cfg)]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load_checked(server_dir: str) -> tuple[config_mod.ClusterConfig, str]:
    """(config, its path) of a deployment on a game script that imports
    no JAX (the watchdog's scans would otherwise report the refusal
    forever)."""
    cfgfile = _find_config(server_dir)
    cfg = config_mod.load(cfgfile)
    _entry_script(cfg, server_dir)
    return cfg, cfgfile


def _start_game(server_dir: str, cfg, gid: int, entry: str,
                      py: str, rel_cfg: str,
                      force_restore: bool = False) -> bool:
    """Spawn every OS process of one game (the controllers of a game of
    several) and wait for all their readiness tags. Controllers block
    in their group's rendezvous until the whole group is up, so
    spawning precedes any waiting."""
    procs, labels = _group_labels(cfg, gid)
    coord = f"127.0.0.1:{_free_port()}" if procs > 1 else None
    # any restorable snapshot counts — the reload freeze file OR the
    # periodic crash-recovery checkpoint (a supervisor start after a
    # crash must not cold-boot past hours of checkpoints). The booting
    # game picks the freshest PARSEABLE one itself
    # (freeze.restore_from_file); filenames spelled out here so the ops
    # CLI needn't import torch just to start.
    restore = force_restore or any(
        os.path.exists(os.path.join(server_dir, name))
        for name in (f"game{gid}_freezed.dat", f"game{gid}_checkpoint.dat")
    )
    waits: list[tuple[str, int]] = []
    for rank, label in enumerate(labels):
        cmd = [py, entry, "-gid", str(gid)]
        if rel_cfg:
            cmd += ["-configfile", rel_cfg]
        if restore:
            cmd.append("-restore")
        extra_env = None
        if procs > 1:
            # one controller group a game; every rank joins it (the
            # torch.distributed rendezvous on coord) before it builds
            # the global mesh
            extra_env = {
                "GOWORLD_MH_PROCS": str(procs),
                "GOWORLD_MH_PROC_ID": str(rank),
                "GOWORLD_MH_COORD": coord,
            }
        waits.append((label, _spawn(server_dir, "game", label, cmd,
                                    extra_env=extra_env)))
    for lbl, off in waits:
        ok = _wait_started(server_dir, "game", lbl, off)
        print(f"game{lbl}: {'started' if ok else 'FAILED'}")
        if not ok:
            return False
    return True


def _spawn(server_dir: str, role: str, idx: int, cmd: list[str],
           extra_env: dict | None = None) -> int:
    """Start the process; returns the byte offset of its log so readiness
    waits only match tags THIS process printed (logs append across
    restarts — reload would otherwise see the previous run's tag)."""
    log_path = _log_path(server_dir, role, idx)
    offset = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    logf = open(log_path, "ab")
    env = dict(os.environ)
    # spawned processes run with cwd=server_dir; make sure they can still
    # import the framework from wherever this CLI loaded it
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    if extra_env:
        env.update(extra_env)
    proc = subprocess.Popen(
        cmd, stdout=logf, stderr=subprocess.STDOUT, cwd=server_dir,
        env=env, start_new_session=True,
    )
    logf.close()
    with open(_pid_path(server_dir, role, idx), "w") as f:
        f.write(str(proc.pid))
    return offset


def _wait_started(server_dir: str, role: str, idx: int,
                  offset: int = 0, timeout: float = 120.0) -> bool:
    """Poll the process log for the supervisor tag (reference
    ``start.go:98-114`` reads the logfile for the STARTED tag)."""
    path = _log_path(server_dir, role, idx)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pid = _read_pid(server_dir, role, idx)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                if SUPERVISOR_STARTED_TAG.encode() in f.read():
                    return True
        except OSError:
            pass
        if not _alive(pid):
            return False
        time.sleep(0.2)
    return False


# =======================================================================
# start (reference start.go:17-114: dispatchers -> games -> gates)
# =======================================================================
def cmd_start(server_dir: str) -> int:
    cfg, cfgfile = _load_checked(server_dir)
    entry = _entry_script(cfg, server_dir)
    if not os.path.exists(entry):
        print(f"error: game script {entry} not found", file=sys.stderr)
        return 1
    py = sys.executable
    rel_cfg = os.path.basename(cfgfile) if cfgfile else ""

    for did in sorted(cfg.dispatchers):
        if _alive(_read_pid(server_dir, "dispatcher", did)):
            print(f"dispatcher{did}: already running")
            continue
        cmd = [py, "-m", "goworld_tpu_torch.cli", "run-dispatcher",
               "-dispid", str(did)]
        if rel_cfg:
            cmd += ["-configfile", rel_cfg]
        off = _spawn(server_dir, "dispatcher", did, cmd)
        ok = _wait_started(server_dir, "dispatcher", did, off)
        print(f"dispatcher{did}: {'started' if ok else 'FAILED'}")
        if not ok:
            return 1

    for gid in sorted(cfg.games):
        procs, labels = _group_labels(cfg, gid)
        alive = [lb for lb in labels
                 if _alive(_read_pid(server_dir, "game", lb))]
        if len(alive) == len(labels):
            for lb in labels:
                print(f"game{lb}: already running")
            continue
        if alive:
            # a PARTIAL multihost group cannot be healed in place: the
            # dead ranks would join a brand-new rendezvous the live
            # ranks never dialed and block until its timeout
            print(
                f"game{gid}: controllers {alive} still running — stop "
                "the whole group before restarting it", file=sys.stderr,
            )
            return 1
        if not _start_game(server_dir, cfg, gid, entry, py, rel_cfg):
            return 1

    for gid in sorted(cfg.gates):
        if _alive(_read_pid(server_dir, "gate", gid)):
            print(f"gate{gid}: already running")
            continue
        cmd = [py, "-m", "goworld_tpu_torch.cli", "run-gate",
               "-gateid", str(gid)]
        if rel_cfg:
            cmd += ["-configfile", rel_cfg]
        off = _spawn(server_dir, "gate", gid, cmd)
        ok = _wait_started(server_dir, "gate", gid, off)
        print(f"gate{gid}: {'started' if ok else 'FAILED'}")
        if not ok:
            return 1
    return 0


# =======================================================================
# stop / kill (reference stop.go: gates -> games -> dispatchers)
# =======================================================================
def _stop_role(server_dir: str, role: str, indices, sig,
               timeout: float = 30.0) -> bool:
    ok = True
    for idx in indices:
        pid = _read_pid(server_dir, role, idx)
        if not _alive(pid):
            # already dead (e.g. crashed earlier): a DELIBERATE stop
            # must still clear the pidfile, or the dead-pid-with-pidfile
            # crash signature would survive the stop and a later
            # watchdog scan would resurrect an intentionally-downed
            # cluster
            try:
                os.unlink(_pid_path(server_dir, role, idx))
            except OSError:
                pass
            continue
        try:
            os.kill(pid, sig)
        except OSError:
            continue
        deadline = time.monotonic() + timeout
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        if _alive(pid):
            print(f"{role}{idx}: did not exit", file=sys.stderr)
            ok = False
        else:
            try:
                os.unlink(_pid_path(server_dir, role, idx))
            except OSError:
                pass
            print(f"{role}{idx}: stopped")
    return ok


def cmd_stop(server_dir: str, sig=signal.SIGTERM) -> int:
    cfg = config_mod.load(_find_config(server_dir))
    with _maintenance(server_dir):
        ok = _stop_role(server_dir, "gate", sorted(cfg.gates), sig)
        ok &= _stop_role(server_dir, "game", _game_labels(cfg), sig)
        ok &= _stop_role(server_dir, "dispatcher",
                         sorted(cfg.dispatchers), sig)
    return 0 if ok else 1


# =======================================================================
# reload (reference reload.go: SIGHUP games, restart with -restore)
# =======================================================================
def cmd_reload(server_dir: str) -> int:
    with _maintenance(server_dir):
        return _cmd_reload_locked(server_dir)


def _freeze_game(server_dir: str, gid: int, labels: list,
                 timeout: float = 90.0) -> str:
    """SIGHUP game ``gid`` (reference FreezeSignal: it snapshots to its
    freeze file and exits) and wait for every process of it to exit;
    "" when a FRESH freeze file landed, else what went wrong. A game of
    several controllers gets the signal on its LEADER; the decision
    spreads to every controller through the mutation exchange, all of
    them exit after snapshotting at the same tick, the leader writes."""
    t_sig = time.time()
    try:
        os.kill(_read_pid(server_dir, "game", labels[0]), signal.SIGHUP)
    except (OSError, TypeError):
        return "could not signal the game"
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(
            _alive(_read_pid(server_dir, "game", lb)) for lb in labels):
        time.sleep(0.1)
    if any(_alive(_read_pid(server_dir, "game", lb)) for lb in labels):
        return "freeze did not complete"
    freeze_file = os.path.join(server_dir, f"game{gid}_freezed.dat")
    # the file must be FRESH: a stale snapshot from a previous reload
    # would otherwise mask a failed freeze and silently restore
    # outdated state
    if not os.path.exists(freeze_file) \
            or os.path.getmtime(freeze_file) < t_sig - 1.0:
        return "no fresh freeze file after exit"
    return ""


def _cmd_reload_locked(server_dir: str) -> int:
    cfg, cfgfile = _load_checked(server_dir)
    entry = _entry_script(cfg, server_dir)
    py = sys.executable
    rel_cfg = os.path.basename(cfgfile) if cfgfile else ""
    for gid in sorted(cfg.games):
        _maintenance_touch(server_dir)  # each game can take minutes
        procs, labels = _group_labels(cfg, gid)
        alive = [lb for lb in labels
                 if _alive(_read_pid(server_dir, "game", lb))]
        if not alive:
            print(f"game{gid}: not running; skipping")
            continue
        if len(alive) < len(labels):
            # same guard as cmd_start: a partial group can't be healed
            print(
                f"game{gid}: only controllers {alive} running — stop "
                "the whole group first", file=sys.stderr,
            )
            return 1
        err = _freeze_game(server_dir, gid, labels)
        if err:
            print(f"game{gid}: {err}", file=sys.stderr)
            return 1
        if not _start_game(server_dir, cfg, gid, entry, py, rel_cfg,
                           force_restore=True):
            print(f"game{gid}: RESTORE FAILED", file=sys.stderr)
            return 1
        print(f"game{gid}: reloaded")
    return 0


# =======================================================================
# watchdog / supervisor (supervised crash recovery)
# =======================================================================
class RestartBackoff:
    """Per-process exponential backoff with jitter for supervised
    restarts. Every restart attempt that lands within ``stable_after``
    seconds of the previous one escalates the delay (a crash-looping
    process must not be respawned at scan cadence forever); an attempt
    after a stable stretch resets to immediate."""

    def __init__(self, base: float = 1.0, cap: float = 30.0,
                 stable_after: float = 30.0, rng=None):
        import random

        self.base = base
        self.cap = cap
        self.stable_after = stable_after
        self._rng = rng or random.Random()
        # label -> (fails, earliest next attempt, last attempt, delay)
        self._state: dict[str, tuple[int, float, float, float]] = {}

    def ready(self, label: str) -> bool:
        st = self._state.get(label)
        return st is None or time.monotonic() >= st[1]

    def delay_of(self, label: str) -> float:
        st = self._state.get(label)
        return 0.0 if st is None else max(0.0, st[1] - time.monotonic())

    def attempted(self, label: str, ok: bool) -> None:
        now = time.monotonic()
        fails, _, last, prev_delay = self._state.get(
            label, (0, 0.0, float("-inf"), 0.0))
        # reset only after a stretch STABLE BEYOND the current backoff
        # window: at the cap, attempts are already cap seconds apart, so
        # comparing against stable_after alone would reset a permanent
        # crash loop every cycle and restart the climb from zero
        if ok and now - last > self.stable_after + prev_delay:
            fails = 0
        else:
            fails += 1
        delay = 0.0 if fails == 0 else min(
            self.cap, self.base * 2 ** (fails - 1)
        )
        delay *= 1.0 + 0.25 * self._rng.random()  # jitter: no thundering
        self._state[label] = (fails, now + delay, now, delay)


def _standby_for(cfg: config_mod.ClusterConfig, gid: int) -> int | None:
    """The configured hot standby of game ``gid`` (``[gameN]
    standby_of = gid``), or None. First configured wins — one standby
    per primary is the supported topology."""
    for sgid in sorted(cfg.games):
        if sgid != gid and getattr(cfg.games[sgid], "standby_of", 0) == gid:
            return sgid
    return None


def _promote_standby(server_dir: str, cfg: config_mod.ClusterConfig,
                     gid: int, sgid: int, timeout: float = 3.0) -> bool:
    """Try to turn game ``gid``'s crash into a warm failover: poke the
    live standby's debug-http ``/standby?promote=1``. The standby
    stages a kvreg-arbitrated claim on its logic thread (single-winner
    — a zombie primary can never split-brain) and resumes ticking from
    its last applied frame. Returns True iff the standby accepted the
    request; the caller falls back to cold restore otherwise. The
    epoch is derived by the standby from the last observed promotion
    round in kvreg, so repeated scans stay monotonic without
    supervisor-side state."""
    import json as _json
    import urllib.request

    gc = cfg.games.get(sgid)
    if gc is None or getattr(gc, "http_port", 0) <= 0:
        return False
    _n, labels = _group_labels(cfg, sgid)
    if not all(_alive(_read_pid(server_dir, "game", lb)) for lb in labels):
        return False  # the standby is dead too: cold restore it is
    url = f"http://127.0.0.1:{gc.http_port}/standby?promote=1"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            out = _json.loads(resp.read().decode("utf-8", "replace"))
    except (OSError, ValueError):
        return False
    return isinstance(out, dict) and "error" not in out


def watch_once(server_dir: str,
               backoff: "RestartBackoff | None" = None) -> list[str]:
    """One supervision scan over the cluster. Dead dispatchers and gates
    are respawned in place (they are stateless — games reconnect forever
    to dispatchers, the reference's resilience model,
    ``DispatcherConnMgr.go:63-85``). A game with ANY dead process is
    handled as a whole: surviving ranks of a multihost group are torn
    down cleanly first (a partial group cannot be healed — its
    rendezvous cannot re-admit a rank, the cmd_start guard), then the
    whole group restarts with ``-restore`` from the freshest snapshot (a reload's
    freeze file or the periodic ``checkpoint_interval`` checkpoint,
    whichever is newer — ``freeze.latest_snapshot_path``), on the card
    its script puts the World on. Exception: a dead game with a
    configured LIVE hot standby (``[gameN] standby_of``) is recovered
    by warm promotion instead — the standby already mirrors the state
    in memory, so failover costs ticks, not a process boot
    (``_promote_standby``). Returns a list of action strings (empty =
    everything healthy)."""
    from goworld_tpu_torch import freeze as freeze_mod

    if _in_maintenance(server_dir):
        return []  # a deliberate stop/reload is in flight: stand down

    cfg, cfgfile = _load_checked(server_dir)
    entry = _entry_script(cfg, server_dir)
    py = sys.executable
    rel_cfg = os.path.basename(cfgfile) if cfgfile else ""
    actions: list[str] = []

    for role, ids_, flag, runner in (
        ("dispatcher", sorted(cfg.dispatchers), "-dispid",
         "run-dispatcher"),
        ("gate", sorted(cfg.gates), "-gateid", "run-gate"),
    ):
        for idx in ids_:
            # only recover CRASHES (pidfile present, process dead);
            # "no pidfile" means never started or cleanly stopped —
            # the watchdog must not resurrect a deliberate stop
            if not _has_pidfile(server_dir, role, idx) \
                    or _alive(_read_pid(server_dir, role, idx)):
                continue
            if backoff is not None and not backoff.ready(f"{role}{idx}"):
                actions.append(
                    f"{role}{idx}: restart deferred "
                    f"{backoff.delay_of(f'{role}{idx}'):.1f}s (backoff)"
                )
                continue
            cmd = [py, "-m", "goworld_tpu_torch.cli", runner, flag,
                   str(idx)]
            if rel_cfg:
                cmd += ["-configfile", rel_cfg]
            off = _spawn(server_dir, role, idx, cmd)
            ok = _wait_started(server_dir, role, idx, off)
            if backoff is not None:
                backoff.attempted(f"{role}{idx}", ok)
            actions.append(
                f"{role}{idx}: {'restarted' if ok else 'RESTART FAILED'}"
            )

    for gid in sorted(cfg.games):
        procs, labels = _group_labels(cfg, gid)
        # a crash only: "no pidfile" is never started / cleanly stopped
        if not any(_has_pidfile(server_dir, "game", lb) for lb in labels):
            continue
        alive = [lb for lb in labels
                 if _alive(_read_pid(server_dir, "game", lb))]
        if len(alive) == len(labels):
            continue
        if backoff is not None and not backoff.ready(f"game{gid}"):
            actions.append(
                f"game{gid}: restart deferred "
                f"{backoff.delay_of(f'game{gid}'):.1f}s (backoff)"
            )
            continue
        if alive:
            actions.append(
                f"game{gid}: dead rank(s) "
                f"{sorted(set(map(str, labels)) - set(map(str, alive)))}; "
                f"tearing down surviving {alive}"
            )
            _stop_role(server_dir, "game", alive, signal.SIGTERM,
                       timeout=15)
            stragglers = [lb for lb in alive
                          if _alive(_read_pid(server_dir, "game", lb))]
            if stragglers:
                _stop_role(server_dir, "game", stragglers, signal.SIGKILL,
                           timeout=10)
        # hot standby (replication/): a configured live mirror turns
        # the crash into a WARM promotion — the state is already on the
        # standby — instead of a cold restore from disk. The dead
        # primary is NOT restarted (its EntityIDs now route to the
        # promoted standby; a restart would re-claim them) — its
        # pidfile is cleared so later scans treat it as cleanly
        # stopped.
        sgid = _standby_for(cfg, gid)
        if sgid is not None and _promote_standby(server_dir, cfg,
                                                 gid, sgid):
            for lb in labels:
                try:
                    os.unlink(_pid_path(server_dir, "game", lb))
                except OSError:
                    pass
            if backoff is not None:
                backoff.attempted(f"game{gid}", True)
            actions.append(
                f"game{gid}: standby game{sgid} PROMOTED "
                "(warm failover; primary not restarted)"
            )
            continue
        if sgid is not None:
            actions.append(
                f"game{gid}: standby game{sgid} unreachable; "
                "falling back to cold restore"
            )
        snap = freeze_mod.latest_snapshot_path(gid, server_dir)
        ok = _start_game(server_dir, cfg, gid, entry, py, rel_cfg,
                         force_restore=snap is not None)
        if backoff is not None:
            backoff.attempted(f"game{gid}", ok)
        actions.append(
            f"game{gid}: "
            + ("restarted from "
               + (os.path.basename(snap) if snap else "cold boot")
               if ok else "RESTART FAILED")
        )
    return actions


def cmd_watchdog(server_dir: str, interval: float = 2.0,
                 once: bool = False) -> int:
    """Supervision loop: scan every ``interval`` seconds and recover
    dead processes (see :func:`watch_once`). ``--once`` does a single
    scan and exits (scriptable health-check-and-heal)."""
    _load_checked(server_dir)  # refuse before anything is spawned
    while True:
        scan_failed = False
        try:
            actions = watch_once(server_dir)
        except Exception as exc:
            print(f"watchdog scan failed: {exc}", file=sys.stderr)
            actions = []
            scan_failed = True
        for a in actions:
            print(a, flush=True)
        if once:
            # a scan that could not run is NOT a healthy verdict
            return 1 if scan_failed \
                or any("FAILED" in a for a in actions) else 0
        time.sleep(interval)


def _freeze_games_for_shutdown(server_dir: str,
                               cfg: config_mod.ClusterConfig) -> bool:
    """Freeze-on-SIGTERM: SIGHUP every game's leader (dispatchers and
    gates still up — the freeze ack dance needs them), wait for the
    whole group to exit, verify a FRESH freeze file landed. The next
    ``start``/``supervise`` boots the games ``-restore`` from it."""
    ok = True
    for gid in sorted(cfg.games):
        procs, labels = _group_labels(cfg, gid)
        alive = [lb for lb in labels
                 if _alive(_read_pid(server_dir, "game", lb))]
        if not alive:
            continue
        if labels[0] not in alive:
            # partial group with a dead leader: the freeze ack dance
            # cannot be driven (same stance as cmd_reload's guard) —
            # skip the freeze; the stop below still runs and the next
            # start restores from the freshest checkpoint instead
            print(f"game{gid}: leader rank dead; cannot freeze a "
                  "partial group", file=sys.stderr)
            ok = False
            continue
        err = _freeze_game(server_dir, gid, labels)
        for lb in labels:  # frozen processes exited; clear crash marker
            if not _alive(_read_pid(server_dir, "game", lb)):
                try:
                    os.unlink(_pid_path(server_dir, "game", lb))
                except OSError:
                    pass
        if err:
            print(f"game{gid}: freeze-on-shutdown failed ({err})",
                  file=sys.stderr)
            ok = False
        else:
            print(f"game{gid}: frozen for shutdown")
    return ok


def cmd_supervise(server_dir: str, interval: float = 2.0,
                  backoff_base: float = 1.0, backoff_max: float = 30.0,
                  freeze_on_term: bool = False,
                  stop=None) -> int:
    """Run the cluster under supervision: start it, then scan-and-heal
    forever with per-process exponential backoff + jitter (a crash loop
    degrades to spaced retries, not a respawn storm). SIGTERM/SIGINT
    stop the cluster — with ``--freeze-on-term`` the games freeze first
    (snapshot to ``game%d_freezed.dat``) so the next start restores hot
    state instead of cold-booting. ``stop`` is an optional
    threading.Event for embedding (tests drive the loop without
    signals)."""
    import threading

    _load_checked(server_dir)  # refuse before anything is spawned
    stop = stop or threading.Event()
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, lambda *_: stop.set())
    rc = cmd_start(server_dir)
    if rc != 0:
        print("supervise: initial start incomplete; healing from scans",
              file=sys.stderr)
    backoff = RestartBackoff(base=backoff_base, cap=backoff_max)
    while not stop.wait(interval):
        try:
            actions = watch_once(server_dir, backoff=backoff)
        except Exception as exc:
            print(f"supervise scan failed: {exc}", file=sys.stderr)
            continue
        for a in actions:
            print(a, flush=True)
    cfg = config_mod.load(_find_config(server_dir))
    ok = True
    with _maintenance(server_dir):
        if freeze_on_term:
            # a failed freeze must surface in the exit code: callers
            # gating on it would otherwise believe hot state was saved
            ok = _freeze_games_for_shutdown(server_dir, cfg)
        ok &= _stop_role(server_dir, "gate", sorted(cfg.gates),
                         signal.SIGTERM)
        ok &= _stop_role(server_dir, "game", _game_labels(cfg),
                         signal.SIGTERM)
        ok &= _stop_role(server_dir, "dispatcher",
                         sorted(cfg.dispatchers), signal.SIGTERM)
    return 0 if ok else 1


# =======================================================================
# build (reference build.go)
# =======================================================================
def cmd_build(server_dir: str | None = None) -> int:
    """Reference ``goworld build <server>`` (``cmd/goworld/build.go:9-38``
    go-compiles the server, dispatcher and gate). Python has no link
    step, but the port DOES have build products: the native C++ cores
    (the batch sync codec, the KCP ARQ core, the snappy codec, compiled
    from ``goworld_tpu_torch/native/`` into ``goworld_tpu_torch/_build/``)
    and .pyc bytecode. Building them at deploy time moves first-boot
    latency to the build box — the role the reference's command plays.
    The CUDA kernels build at first use (``goworld_tpu_torch.kernels``)."""
    import compileall

    from goworld_tpu_torch import native

    pkg_root = os.path.dirname(os.path.abspath(__file__))
    if server_dir and not os.path.isdir(server_dir):
        # a typo'd path must not print "build ok" (compileall treats a
        # missing dir as trivially successful)
        print(f"server directory not found: {server_dir}")
        return 1
    print("building native cores ...")
    try:
        libs = native.build_all()
    except RuntimeError as e:
        print(f"native build FAILED:\n{e}")
        return 1
    for so in libs:
        print(f"  {os.path.basename(so)}: ok")
    print("byte-compiling framework ...")
    # quiet=1: listings off, per-file ERRORS still shown (the operator
    # needs to know WHICH file failed)
    ok = compileall.compile_dir(pkg_root, quiet=1)
    if server_dir:
        print(f"byte-compiling server {server_dir} ...")
        ok = compileall.compile_dir(server_dir, quiet=1) and ok
    if not ok:
        print("byte-compile reported errors")
        return 1
    print("build ok")
    return 0


def _load_tool(name: str):
    """One of the port's cluster tools (:mod:`goworld_tpu_torch.tools`)."""
    import importlib

    return importlib.import_module(f"goworld_tpu_torch.tools.{name}")


def _load_scrape_tool():
    """The shared cluster scraper (tools/scrape_metrics.py)."""
    return _load_tool("scrape_metrics")


def cmd_status(server_dir: str) -> int:
    cfg = config_mod.load(_find_config(server_dir))
    rows = (
        [("dispatcher", i) for i in sorted(cfg.dispatchers)]
        + [("game", label) for label in _game_labels(cfg)]
        + [("gate", i) for i in sorted(cfg.gates)]
    )
    all_up = True
    for role, idx in rows:
        pid = _read_pid(server_dir, role, idx)
        up = _alive(pid)
        all_up &= up
        state = f"running (pid {pid})" if up else "stopped"
        print(f"{role}{idx}: {state}")
    # live telemetry (reference status.go only checks the process table;
    # with /metrics on every process, status can show the cluster's
    # actual health: tick latency, AOI overflow, backlogs, drops)
    targets = _load_scrape_tool().targets_from_config(cfg)
    if targets:
        _print_telemetry(targets)
    return 0 if all_up else 1


def _print_telemetry(targets: list[tuple[str, str]]) -> None:
    scraper = _load_scrape_tool()
    results, errors = scraper.scrape_all(targets)
    if results:
        print()
        print(scraper.merged_table(results))
    # only reach targets the metric scrape answered — a dead process
    # would stall a second timeout in each scrape below
    live = [t for t in targets if t[0] in results]
    # device-plane SLO verdicts (debug_http /costs, utils/devprof): one
    # pass/fail line per process against its tick budget
    costs = scraper.scrape_costs(live)
    if costs:
        print()
        for line in scraper.slo_lines(costs):
            print(line)
    # live workload signature + incident counts (/workload +
    # /incidents), the kernel governor's one-liner (/governor) and the
    # serve-loop residency verdict (/residency) per process;
    # 404/unreachable skipped silently like /costs
    for line in (
        scraper.workload_lines(scraper.scrape_workload(live))
        + scraper.governor_lines(scraper.scrape_governor(live))
        + scraper.residency_lines(scraper.scrape_residency(live))
    ):
        print(line)
    # ONE deployment-wide sync-age verdict: the merged end-to-end
    # age-at-delivery vs the paper's 16 ms target, the residency and
    # conservation lines, and the standby and rebalance lines
    # (tools/obs_aggregate.py)
    agg_tool = _load_tool("obs_aggregate")
    bases = [(label, url.rsplit("/", 1)[0]) for label, url in live]
    if bases:
        try:
            # tick_contrast off: status already scraped /metrics; the
            # verdict line never prints it
            agg = agg_tool.aggregate(bases, tick_contrast=False)
            lines = [agg_tool.verdict_line(agg),
                     agg_tool.residency_line(agg),
                     agg_tool.audit_line(agg),
                     *agg_tool.standby_lines(agg),
                     *agg_tool.rebalance_lines(agg)]
            for line in lines:
                if line:
                    print(line)
        except Exception:
            pass  # the verdict must never break status
    for e in errors:
        print(f"metrics: {e}", file=sys.stderr)


def cmd_watch(server_dir: str, interval: float = 2.0,
              once: bool = False) -> int:
    """Live deployment sync-age dashboard: the merged e2e verdict +
    per-hop lane table (tools/obs_aggregate.py), refreshed every
    ``interval`` seconds until interrupted."""
    agg_tool = _load_tool("obs_aggregate")
    argv = [server_dir]
    if not once:
        argv += ["--watch", str(interval)]
    return agg_tool.main(argv)


# =======================================================================
# trace (distributed tracing capture across the live cluster)
# =======================================================================
def cmd_trace(server_dir: str, rate: float, seconds: float,
              out: str) -> int:
    """Capture a cluster-wide distributed trace: arm sampling at
    ``rate`` on every process's ``/tracing`` endpoint, let traffic run
    for ``seconds``, disarm, then scrape + clock-align + merge every
    ``/trace`` export into one Perfetto JSON (tools/merge_traces.py)."""
    cfg = config_mod.load(_find_config(server_dir))
    merger = _load_tool("merge_traces")
    targets = merger.base_targets_from_config(cfg)
    if not targets:
        print("no process has an http_port configured — tracing needs "
              "the debug-http endpoints", file=sys.stderr)
        return 1

    def _get(url: str):
        """One debug-http GET via the merge tool's fetch_json (ONE
        copy of the scrape plumbing); None on any failure."""
        try:
            return merger.fetch_json(url, timeout=3.0)
        except (OSError, ValueError):
            return None
    # remember each process's steady-state rate (e.g. an ini
    # trace_sample_rate) so the capture restores it instead of
    # force-disarming the whole cluster; when the pre-arm state read
    # fails, fall back to the INI-CONFIGURED rate rather than 0 so a
    # flaky read can never clobber an operator's always-on sampling
    prior: dict[str, float] = {}
    for gid, gc in cfg.games.items():
        prior[f"game{gid}"] = float(getattr(gc, "trace_sample_rate", 0.0))
    for gid, gc in cfg.gates.items():
        prior[f"gate{gid}"] = float(
            getattr(gc, "trace_sample_rate", 0.0))
    armed = 0
    for label, base in targets:
        state = _get(f"{base}/tracing")
        if state is not None:
            prior[label] = float(state.get("rate", 0.0))
        if _get(f"{base}/tracing?rate={rate}&clear=1") is not None:
            armed += 1
        else:
            print(f"{label}: {base} unreachable (skipping)",
                  file=sys.stderr)
    if armed == 0:
        print("no process reachable; is the cluster running?",
              file=sys.stderr)
        return 1
    print(f"sampling at rate {rate} on {armed}/{len(targets)} "
          f"processes for {seconds:g}s ...")
    time.sleep(seconds)
    # restoring MUST be loud: a process left sampling at the capture
    # rate keeps paying trailer bytes + span recording until restarted
    def _restore(label: str, base: str) -> bool:
        return _get(
            f"{base}/tracing?rate={prior.get(label, 0.0)}"
        ) is not None

    still_armed = [
        (label, base) for label, base in targets
        if not _restore(label, base)
    ]
    for label, base in list(still_armed):  # one retry after a breather
        time.sleep(1.0)
        if _restore(label, base):
            still_armed.remove((label, base))
    for label, base in still_armed:
        print(f"WARNING: {label}: could not restore sample rate at "
              f"{base} — it keeps tracing at {rate} until restarted or "
              f"`curl '{base}/tracing?rate={prior.get(label, 0.0)}'` "
              "succeeds", file=sys.stderr)
    merged, errors = merger.collect(targets)
    rc = merger.write_and_report(merged, errors, out)
    return 1 if still_armed else rc


# =======================================================================
# incidents (postmortem bundle capture across the live cluster)
# =======================================================================
def cmd_incidents(server_dir: str, out: str | None = None,
                  frames: bool = False) -> int:
    """Scrape every process's ``/incidents`` (the flight-recorder
    bundles — SLO breach, overload transition, audit violation …) into
    one timestamped postmortem bundle directory: ``{label}.json`` per
    reachable process plus a ``manifest.json`` naming what was
    captured. ``--frames`` adds each recorder's live per-tick frame
    ring (``?frames=1``) for tail context around the frozen bundles."""
    cfg = config_mod.load(_find_config(server_dir))
    merger = _load_tool("merge_traces")
    targets = merger.base_targets_from_config(cfg)
    if not targets:
        print("no process has an http_port configured — incident "
              "capture needs the debug-http endpoints", file=sys.stderr)
        return 1
    stamp = time.strftime("%Y%m%d_%H%M%S")
    bundle_dir = os.path.join(out or server_dir, f"incidents_{stamp}")
    os.makedirs(bundle_dir, exist_ok=True)
    manifest: dict = {"captured_at": stamp, "frames": bool(frames),
                      "processes": {}, "unreachable": []}
    total = 0
    for label, base in targets:
        url = f"{base}/incidents" + ("?frames=1" if frames else "")
        try:
            payload = merger.fetch_json(url, timeout=3.0)
        except (OSError, ValueError) as exc:
            print(f"{label}: {base} unreachable ({exc})",
                  file=sys.stderr)
            manifest["unreachable"].append(label)
            continue
        path = os.path.join(bundle_dir, f"{label}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1, default=str)
        counts = {
            name: rec.get("incident_count", 0)
            for name, rec in payload.items() if isinstance(rec, dict)
        }
        n = sum(counts.values())
        total += n
        manifest["processes"][label] = {"file": f"{label}.json",
                                        "incidents": counts}
        print(f"{label}: {n} incident(s) -> {path}")
    with open(os.path.join(bundle_dir, "manifest.json"), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, default=str)
    if not manifest["processes"]:
        print("no process reachable; is the cluster running?",
              file=sys.stderr)
        return 1
    print(f"bundle: {bundle_dir} ({total} incident(s) from "
          f"{len(manifest['processes'])}/{len(targets)} processes)")
    return 0


# =======================================================================
# in-process runners (the spawned dispatcher/gate processes)
# =======================================================================
def _start_debug_http(port: int, process_name: str,
                      host: str = "127.0.0.1") -> None:
    """Observability endpoint for a spawned process (reference
    binutil.go:17-75 serves pprof + expvar on every process kind).
    Binds the process's configured host so the scraper's URLs (built
    from the same config) actually reach it."""
    if not port:
        return
    from goworld_tpu_torch.utils import debug_http

    try:
        debug_http.start(port, host=host, process_name=process_name)
    except OSError as e:
        print(f"{process_name}: debug http on port {port} failed ({e}); "
              "continuing without it", file=sys.stderr)


def cmd_run_dispatcher(dispid: int, configfile: str | None,
                       logfile: str = "") -> int:
    from goworld_tpu_torch.net.dispatcher import DispatcherService
    from goworld_tpu_torch.utils import faults

    if logfile:
        log.setup(f"dispatcher{dispid}", logfile=logfile)
    cfg = config_mod.load(configfile)
    dc = cfg.dispatchers.get(dispid) or config_mod.DispatcherConfig()
    faults.install(f"dispatcher{dispid}", spec=cfg.faults,
                   seed=cfg.faults_seed)
    _start_debug_http(dc.http_port, f"dispatcher{dispid}", host=dc.host)

    async def main() -> None:
        svc = DispatcherService(
            dispid, dc.host, dc.port,
            desired_games=cfg.desired_games,
            desired_gates=cfg.desired_gates,
        )
        task = asyncio.ensure_future(svc.serve())
        await svc.started.wait()
        print(SUPERVISOR_STARTED_TAG, flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for s in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(s, stop.set)
        await stop.wait()
        task.cancel()

    asyncio.run(main())
    return 0


def cmd_run_gate(gateid: int, configfile: str | None,
                 logfile: str = "") -> int:
    from goworld_tpu_torch.net.gate import GateService
    from goworld_tpu_torch.utils import faults

    if logfile:
        log.setup(f"gate{gateid}", logfile=logfile)
    cfg = config_mod.load(configfile)
    gc = cfg.gates.get(gateid) or config_mod.GateConfig()
    faults.install(f"gate{gateid}", spec=cfg.faults,
                   seed=cfg.faults_seed)
    _start_debug_http(gc.http_port, f"gate{gateid}", host=gc.host)
    if getattr(gc, "trace_sample_rate", 0.0) > 0:
        from goworld_tpu_torch.utils import tracing

        tracing.set_sample_rate(gc.trace_sample_rate)

    ssl_ctx = None
    if gc.encrypt:
        from goworld_tpu_torch.net import transport

        cert = gc.tls_cert or f"gate{gateid}_tls.crt"
        key = gc.tls_key or f"gate{gateid}_tls.key"
        transport.ensure_self_signed_cert(cert, key)
        ssl_ctx = transport.server_ssl_context(cert, key)

    async def main() -> None:
        svc = GateService(
            gateid, gc.host, gc.port, cfg.dispatcher_addrs(),
            ws_port=gc.ws_port,
            kcp_port=gc.kcp_port,
            kcp_idle_timeout=gc.kcp_idle_timeout,
            heartbeat_timeout=gc.heartbeat_timeout,
            position_sync_interval_ms=gc.position_sync_interval_ms,
            compress=gc.compress,
            compress_codec=gc.compress_codec,
            ssl_context=ssl_ctx,
            pend_max_packets=gc.pend_max_packets,
            pend_max_bytes=gc.pend_max_bytes,
            max_clients=gc.max_clients,
            rate_limit_pps=gc.rate_limit_pps,
            rate_limit_bps=gc.rate_limit_bps,
            downstream_max_bytes=gc.downstream_max_bytes,
            downstream_kick_secs=gc.downstream_kick_secs,
            sync_age_target_ms=gc.sync_age_target_ms,
        )
        task = asyncio.ensure_future(svc.serve())
        await svc.started.wait()
        print(SUPERVISOR_STARTED_TAG, flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for s in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(s, stop.set)
        stop_task = asyncio.ensure_future(stop.wait())
        # serve() returns early when the gate self-terminates on
        # dispatcher loss (gate.go:137-143) or crashes; exit nonzero
        # either way so the supervisor restarts us
        await asyncio.wait(
            [stop_task, task], return_when=asyncio.FIRST_COMPLETED
        )
        stop_task.cancel()
        if task.done() and not task.cancelled() \
                and task.exception() is not None:
            logger = log.get("gate")
            logger.error("gate%d serve crashed", gateid,
                         exc_info=task.exception())
            return 1
        task.cancel()
        return 1 if svc.terminated.is_set() else 0

    return asyncio.run(main())


# =======================================================================
# entry
# =======================================================================
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="goworld_tpu_torch",
        description="cluster ops (reference cmd/goworld)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("start", "stop", "kill", "reload", "status"):
        p = sub.add_parser(name)
        p.add_argument("server_dir")
    pt = sub.add_parser(
        "trace",
        help="capture a cluster-wide distributed trace (Perfetto JSON)",
    )
    pt.add_argument("server_dir")
    pt.add_argument("--rate", type=float, default=1.0,
                    help="sampling probability per client packet")
    pt.add_argument("--seconds", type=float, default=5.0,
                    help="capture window")
    pt.add_argument("--out", default="cluster_trace.json")
    pi = sub.add_parser(
        "incidents",
        help="scrape every process's /incidents flight-recorder "
             "bundles into a timestamped postmortem directory",
    )
    pi.add_argument("server_dir")
    pi.add_argument("--out", default=None,
                    help="parent directory for the bundle "
                         "(default: the server dir)")
    pi.add_argument("--frames", action="store_true",
                    help="include each recorder's live per-tick frame "
                         "ring (?frames=1), not just frozen bundles")
    pb = sub.add_parser("build")
    pb.add_argument("server_dir", nargs="?", default=None)
    pw = sub.add_parser("watchdog")
    pw.add_argument("server_dir")
    pw.add_argument("--interval", type=float, default=2.0)
    pw.add_argument("--once", action="store_true")
    pwa = sub.add_parser(
        "watch",
        help="live deployment sync-age verdict: merged e2e "
             "age-at-delivery vs the 16 ms target, per-hop lanes "
             "(tools/obs_aggregate.py)",
    )
    pwa.add_argument("server_dir")
    pwa.add_argument("--interval", type=float, default=2.0)
    pwa.add_argument("--once", action="store_true")
    ps = sub.add_parser(
        "supervise",
        help="start the cluster and keep it healthy: restart-on-crash "
             "with exponential backoff + jitter; SIGTERM stops it "
             "(--freeze-on-term snapshots games first)",
    )
    ps.add_argument("server_dir")
    ps.add_argument("--interval", type=float, default=2.0)
    ps.add_argument("--backoff-base", type=float, default=1.0)
    ps.add_argument("--backoff-max", type=float, default=30.0)
    ps.add_argument("--freeze-on-term", action="store_true")
    pd = sub.add_parser("run-dispatcher")
    pd.add_argument("-dispid", type=int, default=1)
    pd.add_argument("-configfile", default=None)
    pd.add_argument("-d", dest="daemon", action="store_true",
                    help="daemonize (reference binutil -d)")
    pd.add_argument("-logfile", default="")
    pg = sub.add_parser("run-gate")
    pg.add_argument("-gateid", type=int, default=1)
    pg.add_argument("-configfile", default=None)
    pg.add_argument("-d", dest="daemon", action="store_true",
                    help="daemonize (reference binutil -d)")
    pg.add_argument("-logfile", default="")
    sub.add_parser("sample-config")

    args = ap.parse_args(argv)
    if getattr(args, "daemon", False):
        from goworld_tpu_torch.utils.daemon import daemonize

        role = "dispatcher" if args.cmd == "run-dispatcher" else "gate"
        rid = args.dispid if role == "dispatcher" else args.gateid
        daemonize(args.logfile or f"{role}{rid}.log")
    if args.cmd == "start":
        return cmd_start(args.server_dir)
    if args.cmd == "stop":
        return cmd_stop(args.server_dir)
    if args.cmd == "kill":
        return cmd_stop(args.server_dir, sig=signal.SIGKILL)
    if args.cmd == "reload":
        return cmd_reload(args.server_dir)
    if args.cmd == "status":
        return cmd_status(args.server_dir)
    if args.cmd == "trace":
        return cmd_trace(args.server_dir, rate=args.rate,
                         seconds=args.seconds, out=args.out)
    if args.cmd == "incidents":
        return cmd_incidents(args.server_dir, out=args.out,
                             frames=args.frames)
    if args.cmd == "build":
        return cmd_build(args.server_dir)
    if args.cmd == "watchdog":
        return cmd_watchdog(args.server_dir, interval=args.interval,
                            once=args.once)
    if args.cmd == "watch":
        return cmd_watch(args.server_dir, interval=args.interval,
                         once=args.once)
    if args.cmd == "supervise":
        return cmd_supervise(args.server_dir, interval=args.interval,
                             backoff_base=args.backoff_base,
                             backoff_max=args.backoff_max,
                             freeze_on_term=args.freeze_on_term)
    if args.cmd == "run-dispatcher":
        return cmd_run_dispatcher(args.dispid, args.configfile,
                                  "" if args.daemon else args.logfile)
    if args.cmd == "run-gate":
        return cmd_run_gate(args.gateid, args.configfile,
                            "" if args.daemon else args.logfile)
    if args.cmd == "sample-config":
        print(config_mod.dumps_sample())
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
