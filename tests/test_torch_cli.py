"""The port's ops CLI (``python -m goworld_tpu_torch``) end to end on the
CPU, in the cases of ``tests/test_cli.py``.

A ``nil_game``-shaped server directory whose port script (named by
``[deployment] entry``) calls ``gw.run(device="cpu")``, with TCP + snappy,
WebSocket and KCP listeners on the gate and a debug HTTP port on every
process: start, status (with the game's metrics scraped), a bot on each
edge, reload (SIGHUP, fresh freeze file, ``-restore``), the bots again,
the JAX package's reader on the port's freeze file, the watchdog
restarting a killed game with ``-restore`` and a killed gate in place,
stop, and a status that reports everything stopped. Then the command
line against the JAX CLI's (``sample-config`` byte for byte, the exit
codes on a stopped deployment), ``build`` (the three native cores into
``goworld_tpu_torch/_build/``, nothing written under ``goworld_tpu/``),
``supervise`` freezing on shutdown, every command on a game of several
controllers (processes recorded), every command on a deployment with a hot standby (the
watchdog promoting it), a script without ``device="cpu"`` that cannot
start without a card, and ``examples/unity_demo/server_torch.py`` from a
copy of its own ini with a bot over TCP and one over WebSocket.

Ports are free ones, every wait has its own bound (120 s), and every
deployment is killed in ``finally``.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import signal
import socket
import threading
import time

import pytest
import torch

from goworld_tpu import cli as jcli
from goworld_tpu import freeze as jfreeze
from goworld_tpu_torch import cli
from goworld_tpu_torch import freeze as tfreeze
from goworld_tpu_torch.net.botclient import BotClient

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120

GAME = '''import goworld_tpu_torch as gw


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"


if __name__ == "__main__":
    gw.run(%s)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _deployment(path, device: str = 'device="cpu"', extra: str = ""):
    """A nil_game-shaped server dir; (dir, ports)."""
    ports = {k: _free_port() for k in
             ("disp", "gate", "ws", "kcp", "h_disp", "h_game", "h_gate")}
    d = str(path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "server_cpu.py"), "w") as f:
        f.write(GAME % device)
    with open(os.path.join(d, "goworld_tpu.ini"), "w") as f:
        f.write(f"""[deployment]
entry = server_cpu.py
[dispatcher1]
host = 127.0.0.1
port = {ports['disp']}
http_port = {ports['h_disp']}
[game_common]
boot_entity = Account
capacity = 1024
n_spaces = 1
http_port = {ports['h_game']}
[game1]
{extra}
[gate1]
host = 127.0.0.1
port = {ports['gate']}
ws_port = {ports['ws']}
kcp_port = {ports['kcp']}
compress = true
compress_codec = snappy
http_port = {ports['h_gate']}
[storage]
kind = memory
[kvdb]
kind = memory
""")
    return d, ports


def _logs(server_dir: str) -> str:
    out = []
    rd = os.path.join(server_dir, "run")
    if os.path.isdir(rd):
        for name in sorted(os.listdir(rd)):
            if name.endswith(".log"):
                with open(os.path.join(rd, name), errors="replace") as f:
                    out.append(f"==== {name} ====\n" + f.read()[-4000:])
    return "\n".join(out)


def _kill_all(server_dir: str) -> None:
    """Whatever a failing case left running dies here."""
    rd = os.path.join(server_dir, "run")
    if not os.path.isdir(rd):
        return
    for name in os.listdir(rd):
        if name.endswith(".pid"):
            try:
                with open(os.path.join(rd, name)) as f:
                    os.kill(int(f.read().strip()), signal.SIGKILL)
            except (OSError, ValueError):
                pass


async def _bot_session(port: int, **kw):
    bot = BotClient("127.0.0.1", port, strict=True, **kw)
    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        assert bot.player.type_name == "Account"
        for _ in range(WAIT * 20):
            if bot.player.attrs.get("status") == "online":
                break
            await asyncio.sleep(0.05)
        assert bot.player.attrs.get("status") == "online"
    finally:
        recv.cancel()
        await bot.conn.close()
    assert not bot.errors, bot.errors


def _bots_on_every_edge(ports) -> None:
    asyncio.run(_bot_session(ports["gate"], compress=True,
                             compress_codec="snappy"))
    asyncio.run(_bot_session(ports["ws"], ws=True))
    asyncio.run(_bot_session(ports["kcp"], kcp=True, compress=True,
                             compress_codec="snappy"))


def _wait_dead(pid: int) -> None:
    t0 = time.time()
    while time.time() - t0 < WAIT and cli._alive(pid):
        time.sleep(0.05)


def test_start_status_reload_watchdog_stop(tmp_path, capsys):
    dst, ports = _deployment(tmp_path / "nil")
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        capsys.readouterr()
        assert cli.main(["status", dst]) == 0
        out = capsys.readouterr().out
        assert "game1: running" in out and "gate1: running" in out
        # the game's metrics, scraped from its debug HTTP
        assert re.search(r"tick_latency_ms_count\s.*\d", out), out
        _bots_on_every_edge(ports)

        # hot reload: SIGHUP -> fresh freeze file -> -restore restart
        assert cli.main(["reload", dst]) == 0, _logs(dst)
        assert "game1: reloaded" in capsys.readouterr().out
        assert cli.cmd_status(dst) == 0
        _bots_on_every_edge(ports)
        frozen = os.path.join(dst, "game1_freezed.dat")
        port_rec = tfreeze.read_freeze_file(frozen)
        assert jfreeze.read_freeze_file(frozen) == port_rec
        # the three boot Accounts of the first bots, frozen by the reload
        assert [e["type"] for e in port_rec["entities"]] == ["Account"] * 3

        # the watchdog: a healthy scan does nothing; a killed game comes
        # back with -restore from the freeze file; a killed gate
        # respawns in place
        assert cli.watch_once(dst) == []
        pid = cli._read_pid(dst, "game", 1)
        os.kill(pid, signal.SIGKILL)
        _wait_dead(pid)
        actions = cli.watch_once(dst)
        assert actions == ["game1: restarted from game1_freezed.dat"], \
            (actions, _logs(dst))
        with open(os.path.join(dst, "run", "game1.log")) as f:
            assert f.read().count("started (restore=True)") == 2
        asyncio.run(_bot_session(ports["gate"], compress=True,
                                 compress_codec="snappy"))
        gpid = cli._read_pid(dst, "gate", 1)
        os.kill(gpid, signal.SIGKILL)
        _wait_dead(gpid)
        assert cli.watch_once(dst) == ["gate1: restarted"]
        assert cli.cmd_status(dst) == 0, _logs(dst)
        assert cli.main(["stop", dst]) == 0
        # a deliberate stop is never resurrected
        assert cli.watch_once(dst) == []
        assert cli.main(["status", dst]) == 1
    finally:
        _kill_all(dst)


def test_sample_config_is_the_jax_sample(capsys):
    """Byte for byte but for the JAX text's history tags (``(ISSUE
    12)``), which the port's copy of the text does not carry."""
    assert cli.main(["sample-config"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["sample-config"]) == 0
    jax = capsys.readouterr().out
    assert port == re.sub(r" \(ISSUE \d+\)", "", jax)
    assert "[dispatcher1]" in port


@pytest.mark.parametrize("argv,rc", [
    (["status"], 1), (["stop"], 0), (["kill"], 0), (["reload"], 0),
    (["watchdog", "--once"], 0), (["watch", "--once"], None),
    (["trace", "--seconds", "0"], 1), (["incidents"], 1),
])
def test_exit_codes_match_jax_on_a_stopped_deployment(tmp_path, argv, rc,
                                                      capsys):
    """Every subcommand that reads a deployment answers a stopped one
    with the JAX CLI's exit code."""
    dst, _ = _deployment(tmp_path / "stopped")
    jdst = str(tmp_path / "stopped_jax")
    shutil.copytree(dst, jdst)
    cmd, rest = argv[0], argv[1:]
    out = str(tmp_path / "trace.json")
    extra = ["--out", out] if cmd == "trace" else []
    want = jcli.main([cmd, jdst, *rest, *extra])
    got = cli.main([cmd, dst, *rest, *extra])
    assert got == want
    if rc is not None:
        assert got == rc


def test_build_builds_the_native_cores_and_leaves_jax_untouched(tmp_path,
                                                                capsys):
    from goworld_tpu_torch import native

    def tree(root):
        out = {}
        for dp, _, fs in os.walk(os.path.join(REPO, root)):
            for f in fs:
                p = os.path.join(dp, f)
                out[p] = os.stat(p).st_mtime_ns
        return out

    before = tree("goworld_tpu")
    dst, _ = _deployment(tmp_path / "b")
    assert cli.main(["build", dst]) == 0
    text = capsys.readouterr().out
    assert "build ok" in text
    for name in native.CORES:
        path = native.library_path(name)
        assert path.exists() and path.parent == native.BUILD_DIR
        assert path.name in text
    assert tree("goworld_tpu") == before
    assert cli.main(["build", str(tmp_path / "nowhere")]) == 1


def test_supervise_freezes_on_shutdown(tmp_path):
    """``supervise --freeze-on-term``: the cluster starts, and on the
    stop signal every game freezes to a fresh file before the stop."""
    dst, ports = _deployment(tmp_path / "sup")
    stop = threading.Event()
    box: list = []
    t = threading.Thread(target=lambda: box.append(cli.cmd_supervise(
        dst, interval=0.2, freeze_on_term=True, stop=stop)))
    t.start()
    try:
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and not (
                cli._alive(cli._read_pid(dst, "gate", 1))
                and "STARTED" in _logs(dst).split("gate1.log")[-1]):
            time.sleep(0.1)
        asyncio.run(_bot_session(ports["gate"], compress=True,
                                 compress_codec="snappy"))
        stop.set()
        t.join(WAIT * 2)
        assert box == [0], _logs(dst)
        assert os.path.exists(os.path.join(dst, "game1_freezed.dat"))
        assert cli.cmd_status(dst) == 1
    finally:
        stop.set()
        _kill_all(dst)


@pytest.mark.parametrize("cmd", ["start", "reload", "watchdog",
                                 "supervise"])
def test_multihost_demo_refused_before_anything_spawns(tmp_path, cmd,
                                                       monkeypatch):
    """``examples/multihost_demo`` (``mesh_processes = 2``) was refused
    until the game of several controllers was ported; each command now
    takes it as one group of two controller processes (processes
    recorded, not spawned; ``tests/test_torch_multihost_cli.py`` runs
    the demo for real). ``start`` and ``supervise``'s start spawn
    ``game1c0`` and ``game1c1`` with the group's environment (its size,
    each rank, one rendezvous address); ``reload`` of a stopped
    deployment skips the group; ``watchdog`` with rank 1 dead tears down
    the surviving rank 0 and restarts the whole group."""
    import subprocess

    dst = str(tmp_path / "mh")
    shutil.copytree(os.path.join(REPO, "examples", "multihost_demo"), dst)
    spawned, envs = [], []

    def spawn(server_dir, role, idx, cmd_, extra_env=None):
        spawned.append(f"{role}{idx}")
        envs.append(extra_env)
        return 0

    monkeypatch.setattr(cli, "_spawn", spawn)
    monkeypatch.setattr(cli, "_wait_started", lambda *a, **k: True)
    group = ["dispatcher1", "game1c0", "game1c1", "gate1"]

    def check_group_env():
        e0, e1 = envs[1], envs[2]
        assert (e0["GOWORLD_MH_PROCS"], e0["GOWORLD_MH_PROC_ID"]) == ("2",
                                                                      "0")
        assert (e1["GOWORLD_MH_PROCS"], e1["GOWORLD_MH_PROC_ID"]) == ("2",
                                                                      "1")
        assert e0["GOWORLD_MH_COORD"] == e1["GOWORLD_MH_COORD"]
        assert e0["GOWORLD_MH_COORD"].startswith("127.0.0.1:")

    if cmd in ("start", "reload"):
        assert cli.main([cmd, dst]) == 0
        assert spawned == (group if cmd == "start" else [])
        if cmd == "start":
            check_group_env()
        return
    if cmd == "supervise":
        stop = threading.Event()
        stop.set()
        assert cli.cmd_supervise(dst, interval=0.01, stop=stop) == 0
        assert spawned == group
        check_group_env()
        return
    dead = subprocess.Popen(["true"])
    dead.wait()
    live = subprocess.Popen(["sleep", "60"])
    try:
        os.makedirs(os.path.join(dst, "run"), exist_ok=True)
        for name, pid in (("game1c0", live.pid), ("game1c1", dead.pid)):
            with open(os.path.join(dst, "run", f"{name}.pid"), "w") as f:
                f.write(str(pid))
        acts = cli.watch_once(dst)
        assert acts[0] == ("game1: dead rank(s) ['1c1']; tearing down "
                           "surviving ['1c0']"), acts
        assert acts[1].startswith("game1: restarted from "), acts
        assert live.wait(timeout=WAIT) is not None
        assert spawned == ["game1c0", "game1c1"]
    finally:
        live.kill()


@pytest.mark.parametrize("cmd", ["start", "reload", "watchdog",
                                 "supervise"])
def test_standby_refused_before_anything_spawns(tmp_path, cmd,
                                                monkeypatch):
    """A hot standby (``[game2] standby_of = 1``) was refused until the
    replication plane was ported; each command now takes the deployment
    (processes recorded, not spawned). ``start`` and ``supervise``'s
    start spawn the standby after its primary, as any game; ``reload``
    of a stopped deployment skips both games; ``watchdog`` with the
    primary dead and the standby alive pokes the standby's
    ``/standby?promote=1`` and does not restart the primary (its pid
    file is cleared), and with the standby dead too it falls back to
    the primary's cold restore."""
    import json as _json
    import subprocess
    import urllib.request

    dst, ports = _deployment(tmp_path / "sb")
    with open(os.path.join(dst, "goworld_tpu.ini"), "a") as f:
        f.write(f"[game2]\nstandby_of = 1\nhttp_port = "
                f"{ports['h_game'] + 1}\n")
    spawned, pokes = [], []

    def spawn(server_dir, role, idx, cmd_, extra_env=None):
        spawned.append(f"{role}{idx}")
        return 0

    monkeypatch.setattr(cli, "_spawn", spawn)
    monkeypatch.setattr(cli, "_wait_started", lambda *a, **k: True)
    if cmd in ("start", "reload"):
        assert cli.main([cmd, dst]) == 0
        assert spawned == (["dispatcher1", "game1", "game2", "gate1"]
                           if cmd == "start" else [])
        return
    if cmd == "supervise":
        stop = threading.Event()
        stop.set()
        assert cli.cmd_supervise(dst, interval=0.01, stop=stop) == 0
        assert spawned == ["dispatcher1", "game1", "game2", "gate1"]
        return

    class _Resp:
        def __init__(self, body):
            self.body = body

        def read(self):
            return _json.dumps(self.body).encode()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def urlopen(url, timeout=None):
        pokes.append(url)
        return _Resp({"standby": "game2", "status": "claiming",
                      "epoch": -1})

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    dead = subprocess.Popen(["true"])
    dead.wait()
    os.makedirs(os.path.join(dst, "run"), exist_ok=True)
    for name, pid in (("game1", dead.pid), ("game2", os.getpid())):
        with open(os.path.join(dst, "run", f"{name}.pid"), "w") as f:
            f.write(str(pid))
    assert cli.watch_once(dst) == [
        "game1: standby game2 PROMOTED (warm failover; primary not "
        "restarted)"]
    assert pokes == [f"http://127.0.0.1:{ports['h_game'] + 1}"
                     "/standby?promote=1"]
    assert spawned == []
    assert not os.path.exists(os.path.join(dst, "run", "game1.pid"))
    # the standby dead too: the primary's cold restore
    for name in ("game1", "game2"):
        with open(os.path.join(dst, "run", f"{name}.pid"), "w") as f:
            f.write(str(dead.pid))
    acts = cli.watch_once(dst)
    assert acts[0] == ("game1: standby game2 unreachable; falling back "
                       "to cold restore")
    assert spawned[0] == "game1"
    assert len(pokes) == 1


def test_script_without_a_device_cannot_start_without_a_card(tmp_path):
    """``gw.run()`` with no device puts the World on the card: without
    one the game dies at boot and ``start`` returns 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    dst, _ = _deployment(tmp_path / "nocard", device="")
    try:
        assert cli.main(["start", dst]) == 1
        with open(os.path.join(dst, "run", "game1.log")) as f:
            assert "device='cpu'" in f.read()
        assert not os.path.exists(os.path.join(dst, "run", "gate1.pid"))
    finally:
        cli.cmd_stop(dst)
        _kill_all(dst)


UNITY_CPU = '''import runpy

import goworld_tpu_torch as gw

runpy.run_path("server_torch.py")  # the port's game: registrations only
gw.run(device="cpu")
'''


async def _unity_login(port: int, name: str, dst: str, **kw):
    """Log in and return the attrs the Player arrived with: its create
    packet's, taken before any later packet is applied. The demo's
    Monsters hit a Player in their AOI every 100 ms (5 hp a hit), often
    within 50 ms of its arrival, so its live ``hp`` is 100 only for a
    moment that a loaded test host can miss."""
    bot = BotClient("127.0.0.1", port, strict=True, **kw)
    arrived: list = []
    handle = bot._handle_inner

    def spy(msgtype, pkt):
        handle(msgtype, pkt)
        if not arrived and bot.player is not None \
                and bot.player.type_name == "Player":
            arrived.append(dict(bot.player.attrs))

    bot._handle_inner = spy
    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        bot.call_server("Login_Client", name)
        for _ in range(WAIT * 20):
            if arrived:
                break
            await asyncio.sleep(0.05)
    finally:
        recv.cancel()
        await bot.conn.close()
    seen = (None if bot.player is None else
            (bot.player.type_name, dict(bot.player.attrs)))
    assert not bot.errors, (bot.errors, _logs(dst))
    assert arrived, (seen, _logs(dst))
    assert bot.player.type_name == "Player", (seen, _logs(dst))
    assert (arrived[0].get("name"), arrived[0].get("hp")) == (name, 100), (
        arrived, seen, _logs(dst))


def test_unity_demo_server_torch_from_its_own_ini(tmp_path):
    """``examples/unity_demo``'s stock ini (its ports moved to free
    ones, its ``ws_port`` kept) and ``server_torch.py`` through the
    port's CLI, the World on the CPU: a bot logs in over TCP and one
    over WebSocket, each gets its Player."""
    src = os.path.join(REPO, "examples", "unity_demo")
    dst = str(tmp_path / "unity")
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "server_torch.py"), dst)
    with open(os.path.join(src, "goworld_tpu.ini")) as f:
        text = f.read()
    ports = {}
    for old in ("14600", "15600", "15601"):
        assert f"port = {old}" in text
        ports[old] = _free_port()
        text = text.replace(f"port = {old}", f"port = {ports[old]}")
    with open(os.path.join(dst, "goworld_tpu.ini"), "w") as f:
        f.write("[deployment]\nentry = server_cpu.py\n" + text)
    with open(os.path.join(dst, "server_cpu.py"), "w") as f:
        f.write(UNITY_CPU)
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        asyncio.run(_unity_login(ports["15600"], "tcp-hero", dst))
        asyncio.run(_unity_login(ports["15601"], "ws-hero", dst, ws=True))
        assert cli.main(["stop", dst]) == 0
    finally:
        _kill_all(dst)


def test_entry_defaults_to_the_port_script(tmp_path):
    """Without ``[deployment] entry`` a directory holding both packages'
    scripts runs ``server_torch.py``; one holding only a ``server.py``
    (on the port) runs that."""
    cfg = cli.config_mod.load(os.path.join(REPO, "examples", "unity_demo",
                                           "goworld_tpu.ini"))
    unity = os.path.join(REPO, "examples", "unity_demo")
    assert cli._entry_script(cfg, unity) == os.path.join(
        unity, "server_torch.py")
    only = str(tmp_path / "only")
    os.makedirs(only)
    with open(os.path.join(only, "server.py"), "w") as f:
        f.write(GAME % 'device="cpu"')
    assert cli._entry_script(cfg, only) == os.path.join(only, "server.py")


@pytest.mark.parametrize("source", [
    "import goworld_tpu as gw\n",
    "from goworld_tpu.ext.pubsub import PublishSubscribeService\n",
    "import os, goworld_tpu.api\n",
    "def f():\n    from goworld_tpu import cli\n",
], ids=["import", "from_ext", "dotted", "nested"])
@pytest.mark.parametrize("cmd", ["start", "reload", "watchdog",
                                 "supervise"])
def test_jax_script_refused_before_anything_spawns(tmp_path, source, cmd):
    """A game script that imports the JAX package is refused, naming the
    script, before anything is spawned; the port's own imports
    (``goworld_tpu_torch``) are not mistaken for it."""
    dst, _ = _deployment(tmp_path / "jax")
    os.unlink(os.path.join(dst, "server_cpu.py"))
    with open(os.path.join(dst, "goworld_tpu.ini")) as f:
        text = f.read().replace("entry = server_cpu.py\n", "")
    with open(os.path.join(dst, "goworld_tpu.ini"), "w") as f:
        f.write(text)
    script = os.path.join(dst, "server.py")
    with open(script, "w") as f:
        f.write("import goworld_tpu_torch\n" + source)
    with pytest.raises(ValueError, match=re.escape(script)):
        cli.main([cmd, dst])
    assert not os.path.isdir(os.path.join(dst, "run")) or not [
        f for f in os.listdir(os.path.join(dst, "run"))
        if f.endswith(".pid")]


@pytest.mark.parametrize("example", ["nil_game", "chatroom_demo",
                                     "test_game", "unity_demo",
                                     "megaspace_demo", "multihost_demo"])
def test_every_stock_example_resolves_to_its_port_script(example):
    """Every stock example has a ``server_torch.py``, which the CLI
    picks (``multihost_demo`` too: the case below)."""
    d = os.path.join(REPO, "examples", example)
    cfg = cli.config_mod.load(os.path.join(d, "goworld_tpu.ini"))
    assert cli._entry_script(cfg, d) == os.path.join(d, "server_torch.py")
    with pytest.raises(ValueError, match="server.py"):
        cli._check_entry(os.path.join(d, "server.py"))
