"""A hot standby and the rebalance plane served through the port's ops CLI
on the CPU, end to end.

A deployment of one dispatcher, one TCP gate and three games: game1 the
primary (an Arena of 24 Monsters, its SnapshotChain checkpoint on the
replication worker), game2 its hot standby (``standby_of = 1``) and
game3 a peer with an empty Arena that takes no boot entities, under
``[deployment] rebalance = true``; every game serves its debug HTTP. The
case starts it, waits for the standby's ``/standby`` verdict, logs a
strict bot in (its Avatar on game1), drains 8 entities of game1's Arena
to game3 by ``/rebalance?handoff=3&batch=8``, kills game1 with SIGKILL,
and lets one ``watchdog`` scan promote the standby (no restart of the
primary). The bot's Avatar is then served where it lives, a second bot
logs in on the promoted game2 and sees the mirrored Monsters, the
promotion log replays byte for byte, and ``stop`` ends it all.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import threading
import time
import urllib.request

import torch

from goworld_tpu_torch import cli
from goworld_tpu_torch.net.botclient import BotClient
from goworld_tpu_torch.replication.promote import replay_decisions

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

WAIT = 120

GAME = '''import goworld_tpu_torch as gw


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"

    def Login_Client(self, name):
        w = self.world
        arena = next(s for s in w.spaces.values() if s is not w.nil_space)
        av = w.create_entity("Avatar", space=arena,
                             pos=(70.0, 0.0, 70.0))
        av.attrs["name"] = name
        self.give_client_to(av)
        self.destroy()


@gw.register_entity("Avatar")
class Avatar(gw.Entity):
    ATTRS = {"name": "allclients", "said": "client"}

    def Say_Client(self, text):
        self.attrs["said"] = f"game{self.world.game_id}:{text}"


@gw.register_entity("Monster")
class Monster(gw.Entity):
    ATTRS = {"hp": "allclients"}


@gw.register_space("Arena")
class Arena(gw.Space):
    pass


def boot(w):
    arena = w.create_space("Arena")
    if w.game_id == 1:
        for i in range(24):
            arena.create_entity(
                "Monster", pos=(60.0 + 4 * (i % 6), 0.0, 60.0 + 4 * (i // 6)))


gw.on_boot(boot)

if __name__ == "__main__":
    gw.run(device="cpu")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _deployment(d: str) -> dict:
    ports = {k: _free_port() for k in ("disp", "gate", "h1", "h2", "h3")}
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "server_cpu.py"), "w") as f:
        f.write(GAME)
    with open(os.path.join(d, "goworld_tpu.ini"), "w") as f:
        f.write(f"""[deployment]
entry = server_cpu.py
rebalance = true
[dispatcher1]
host = 127.0.0.1
port = {ports['disp']}
[game_common]
boot_entity = Account
capacity = 256
n_spaces = 1
aoi_radius = 50.0
extent_x = 200.0
extent_z = 200.0
tick_hz = 30
[game1]
http_port = {ports['h1']}
checkpoint_interval = 0.5
snapshot_keyframe_every = 4
[game2]
http_port = {ports['h2']}
standby_of = 1
[game3]
http_port = {ports['h3']}
ban_boot_entity = true
[gate1]
host = 127.0.0.1
port = {ports['gate']}
[storage]
kind = memory
[kvdb]
kind = memory
""")
    return ports


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return json.loads(r.read())


def _until(what: str, fn, limit: float = WAIT):
    t_end = time.monotonic() + limit
    while True:
        got = fn()
        if got:
            return got
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.2)


def _logs(server_dir: str) -> str:
    out = []
    rd = os.path.join(server_dir, "run")
    for name in sorted(os.listdir(rd)) if os.path.isdir(rd) else []:
        if name.endswith(".log"):
            with open(os.path.join(rd, name), errors="replace") as f:
                out.append(f"==== {name} ====\n" + f.read()[-3000:])
    return "\n".join(out)


def _kill_all(server_dir: str) -> None:
    rd = os.path.join(server_dir, "run")
    for name in os.listdir(rd) if os.path.isdir(rd) else []:
        if name.endswith(".pid"):
            try:
                with open(os.path.join(rd, name)) as f:
                    os.kill(int(f.read().strip()), signal.SIGKILL)
            except (OSError, ValueError):
                pass


class Session:
    """A strict bot on its own event loop, driven step by step. The loop
    runs on a thread of its own from connect to close, so the bot keeps
    reading and heartbeating between the steps, as a real client does:
    a loop run only inside the steps left the bot silent through the
    long stretch from its first say to its second (the handoff, the
    kill, the promotion), and on a loaded host that stretch outlasted
    the gate's heartbeat_timeout (30 s), which reaped the client and
    made its next RPC go nowhere (ROADMAP.md Queue C16). Everything
    that touches the bot runs on that loop."""

    def __init__(self, port: int, bot_id: int):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.bot = BotClient("127.0.0.1", port, bot_id=bot_id,
                             strict=True)
        self.run(self.bot.connect())

        async def recv():
            return asyncio.ensure_future(self.bot._recv_loop())
        self.recv = self.run(recv())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def call(self, method: str, *args) -> None:
        async def send():
            self.bot.call_server(method, *args)
        self.run(send())

    def wait(self, what: str, fn, limit: float = WAIT):
        async def poll():
            t_end = time.monotonic() + limit
            while not fn():
                assert time.monotonic() < t_end, f"bot: {what}"
                await asyncio.sleep(0.05)
        self.run(poll())

    def login(self, name: str) -> None:
        self.wait("boot entity", lambda: self.bot.player is not None)
        self.call("Login_Client", name)
        self.wait("Avatar", lambda: self.bot.player is not None
                  and self.bot.player.type_name == "Avatar")

    def say(self, text: str) -> str:
        self.call("Say_Client", text)
        self.wait("said", lambda: str(self.bot.player.attrs.get(
            "said", "")).endswith(text))
        return self.bot.player.attrs["said"]

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.recv.cancel)
        try:
            self.run(self.bot.conn.close())
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(WAIT)
        self.loop.close()


def _replayed(text: bytes) -> bytes:
    """The promotion log's lines back through ``replay_decisions``."""
    inputs = []
    for line in text.decode().splitlines():
        event, *pairs = line.split(" ")
        inputs.append((event, dict(p.split("=", 1) for p in pairs)))
    return replay_decisions(inputs)


def test_standby_promotes_through_the_watchdog_after_a_handoff(tmp_path):
    dst = str(tmp_path / "fo")
    ports = _deployment(dst)
    sessions = []
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        sb = _until("the standby's verdict", lambda: (
            _get(ports["h2"], "/standby").get("game2") or {}).get("pass"))
        assert sb
        s1 = Session(ports["gate"], 1)
        sessions.append(s1)
        s1.login("ann")
        assert s1.say("hi") == "game1:hi"

        # the manual drain: 8 entities of game1's Arena to game3
        _until("game3's receiving space", lambda: "error" not in _get(
            ports["h1"], "/rebalance?handoff=3&batch=8"))
        done = _until("the handoff", lambda: (lambda a: a["completed"]
                      and a)(_get(ports["h1"], "/rebalance")
                             ["agents"]["game1"]))
        assert done["moves_total"] == {"game1->game3:manual": 8}
        assert done["aborted"] == 0
        g3 = _until("game3's census", lambda: (lambda v: v if v.get(
            "entities", 0) >= 10 else None)(
                _get(ports["h3"], "/audit").get("game3", {})))
        # its nil space, its Arena and the 8 moved
        assert g3["entities"] == 10

        # game1's chain checkpoint, written by the replication worker
        assert os.path.exists(os.path.join(dst, "game1_ckpt_key.dat"))

        # the primary dies; one watchdog scan promotes the standby
        pid = cli._read_pid(dst, "game", 1)
        time.sleep(0.5)   # a frame or two more reach the standby
        os.kill(pid, signal.SIGKILL)
        _until("game1 dead", lambda: not cli._alive(pid))
        actions = cli.watch_once(dst)
        assert actions == ["game1: standby game2 PROMOTED (warm "
                           "failover; primary not restarted)"], \
            (actions, _logs(dst))
        _until("the promotion", lambda: _get(ports["h2"], "/standby")
               ["game2"]["role"] == "promoted")
        assert cli.watch_once(dst) == []
        with open(os.path.join(dst, "game2_promotion.log"), "rb") as f:
            plog = f.read()
        assert plog.startswith(b"claim ") and b"\npromoted " in plog
        assert _replayed(plog) == plog

        # the bot keeps its Avatar, served where it now lives; a new bot
        # boots on the promoted game and sees the mirrored Monsters
        said = s1.say("again")
        assert said in ("game2:again", "game3:again"), said
        s2 = Session(ports["gate"], 2)
        sessions.append(s2)
        s2.login("bob")
        assert s2.say("hello") == "game2:hello"
        s2.wait("Monsters", lambda: sum(
            m.type_name == "Monster" for m in s2.bot.entities.values())
            > 0)
        assert not s1.bot.errors and not s2.bot.errors, \
            (s1.bot.errors, s2.bot.errors)
        for s in sessions:
            s.close()
        sessions.clear()
        assert cli.main(["stop", dst]) == 0
    finally:
        for s in sessions:
            s.close()
        _kill_all(dst)
