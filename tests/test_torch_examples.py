"""The stock examples' port scripts (``examples/*/server_torch.py``) from
a copy of their own ini, through the port's ops CLI (``python -m
goworld_tpu_torch start``), the World on the CPU.

Each copy moves the ini's ports to free ones and names a wrapper entry
that runs the stock ``server_torch.py`` for its registrations and then
``gw.run(device="cpu")``; nothing else of the game changes.

* ``nil_game``: a bot's boot Account reports ``status = online``.
* ``chatroom_demo``: three bots log in; two in room 1 receive each
  other's ``OnRoomSay``, the third, moved to room 2, receives none of
  room 1's and its own room's line only; a shout reaches all three.
* ``test_game`` on the networked kinds, against the port's in-process
  servers of this test: the storage on ``mongodb`` or ``redis``, the
  kvdb on ``redis_cluster`` (three nodes), ``redis`` or ``mongodb``. Two
  bots log in, subscribe to ``news.*`` and receive ``OnPublish`` of a
  ``news.tpu`` publish; one sends a mail; they leave; one logs in again
  and gets the same Avatar. After ``stop``, each name's ``avatarOf/``
  key and each Avatar's document (its ``name``) are read back through
  fresh backends of the port.

Every wait has its own bound (120 s); every deployment is killed in
``finally``.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import socket
import threading
import time

import pytest
import torch

from goworld_tpu_torch import cli, kvdb, storage
from goworld_tpu_torch.ext.db.minimongo import MiniMongo
from goworld_tpu_torch.ext.db.miniredis import MiniRedis
from goworld_tpu_torch.net.botclient import BotClient

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120

ON_CPU = '''import runpy

import goworld_tpu_torch as gw

runpy.run_path("server_torch.py")  # the stock game: registrations only
gw.run(device="cpu")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    rd = os.path.join(server_dir, "run")
    if not os.path.isdir(rd):
        return
    for name in os.listdir(rd):
        if name.endswith(".pid"):
            try:
                with open(os.path.join(rd, name)) as f:
                    os.kill(int(f.read().strip()), 9)
            except (OSError, ValueError):
                pass


def _copy_example(name: str, dst: str, sections: dict | None = None):
    """The example's ``server_torch.py`` and ini in ``dst``, every
    ``port`` key moved to a free port and ``sections`` replacing whole
    ini sections' bodies; (dir, the gate's TCP port)."""
    src = os.path.join(REPO, "examples", name)
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "server_torch.py"), dst)
    sections = sections or {}
    out, sec, gate = [], "", None
    with open(os.path.join(src, "goworld_tpu.ini")) as f:
        for line in f.read().splitlines():
            head = re.fullmatch(r"\[(\w+)\]", line.strip())
            if head:
                sec = head.group(1)
                out.append(line)
                if sec in sections:
                    out.append(sections[sec])
                continue
            if sec in sections:
                continue
            key = re.fullmatch(r"(\w*port) = \d+", line.strip())
            if key:
                new = _free_port()
                line = f"{key.group(1)} = {new}"
                if sec.startswith("gate") and key.group(1) == "port":
                    gate = new
            out.append(line)
    assert gate is not None and set(sections) <= set(
        ln.strip("[]") for ln in out if ln.startswith("["))
    with open(os.path.join(dst, "goworld_tpu.ini"), "w") as f:
        f.write("[deployment]\nentry = server_cpu.py\n\n"
                + "\n".join(out) + "\n")
    with open(os.path.join(dst, "server_cpu.py"), "w") as f:
        f.write(ON_CPU)
    return dst, gate


class Bots:
    """Bots over TCP with their receive loops; ``close`` ends them all
    (``seen`` keeps every bot for the strict mirrors' errors)."""

    def __init__(self, port: int):
        self.port = port
        self.bots: list[BotClient] = []
        self.tasks: list = []
        self.seen: list[BotClient] = []

    async def add(self) -> BotClient:
        bot = BotClient("127.0.0.1", self.port, strict=True,
                        bot_id=len(self.seen))
        await bot.connect()
        self.tasks.append(asyncio.ensure_future(bot._recv_loop()))
        self.bots.append(bot)
        self.seen.append(bot)
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        return bot

    async def close(self) -> None:
        for b, t in zip(self.bots, self.tasks):
            t.cancel()
            await b.conn.close()
        self.bots, self.tasks = [], []

    def errors(self) -> list:
        return [e for b in self.seen for e in b.errors]


async def _until(pred, what: str, dst: str, timeout: float = WAIT):
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}\n"
                                 + _logs(dst))
        await asyncio.sleep(0.05)


def _got(bot: BotClient, method: str) -> list:
    return [args for _, m, args in bot.rpc_log if m == method]


async def _login(bots: Bots, typ: str, name: str, dst: str) -> BotClient:
    bot = await bots.add()
    bot.call_server("Login_Client", name)
    await _until(lambda: bot.player is not None
                 and bot.player.type_name == typ
                 and bot.player.attrs.get("name") == name,
                 f"{name}'s {typ}", dst)
    return bot


def _serve(dst: str, play) -> None:
    """start, ``play`` (a coroutine function), stop; killed in finally."""
    try:
        assert cli.main(["start", dst]) == 0, _logs(dst)
        with open(os.path.join(dst, "run", "game1.log")) as f:
            assert "on cpu" in f.read(), _logs(dst)
        asyncio.run(play())
        assert cli.main(["stop", dst]) == 0, _logs(dst)
    finally:
        _kill_all(dst)


def test_nil_game(tmp_path):
    dst, gate = _copy_example("nil_game", str(tmp_path / "nil"))

    async def play():
        bots = Bots(gate)
        try:
            bot = await bots.add()
            assert bot.player.type_name == "Account"
            await _until(lambda: bot.player.attrs.get("status") == "online",
                         "the Account's status", dst)
        finally:
            await bots.close()
        assert not bots.errors(), bots.errors()

    _serve(dst, play)


def test_chatroom_demo_rooms(tmp_path):
    dst, gate = _copy_example("chatroom_demo", str(tmp_path / "chat"))

    async def play():
        bots = Bots(gate)
        try:
            a = await _login(bots, "ChatAvatar", "ann", dst)
            b = await _login(bots, "ChatAvatar", "ben", dst)
            c = await _login(bots, "ChatAvatar", "cid", dst)
            for bot in (a, b, c):
                await _until(lambda bot=bot: bot.player.attrs.get("room")
                             == 1, "room 1", dst)
            c.call_server("EnterRoom_Client", 2)
            await _until(lambda: c.player.attrs.get("room") == 2,
                         "cid in room 2", dst)
            a.call_server("Say_Client", "hello room 1")
            await _until(lambda: all(["ann", "hello room 1"] in
                                     _got(x, "OnRoomSay") for x in (a, b)),
                         "room 1's line", dst)
            c.call_server("Say_Client", "hello room 2")
            await _until(lambda: ["cid", "hello room 2"] in
                         _got(c, "OnRoomSay"), "room 2's line", dst)
            b.call_server("Shout_Client", "all")
            want = ["ben", "(shout) all"]
            await _until(lambda: all(want in _got(x, "OnRoomSay")
                                     for x in (a, b, c)), "the shout", dst)
            # every line sent before the shout has arrived where it goes
            assert _got(c, "OnRoomSay") == [["cid", "hello room 2"], want]
            for x in (a, b):
                assert _got(x, "OnRoomSay") == [["ann", "hello room 1"],
                                                want]
        finally:
            await bots.close()
        assert not bots.errors(), bots.errors()

    _serve(dst, play)


@pytest.fixture()
def stores():
    """The port's minimongo, a plain miniredis and a three-node cluster
    (its slots split in three), on ports bound here."""
    mongo = MiniMongo().start()
    redis = MiniRedis().start()
    split = [(0, 5460), (5461, 10922), (10923, 16383)]
    nodes = [MiniRedis(cluster_slots=r).start() for r in split]
    for n in nodes:
        n.peers = {m.addr: m.cluster_slots for m in nodes if m is not n}
    yield dict(mongodb=mongo.addr + "/goworld", redis=redis.addr,
               redis_cluster=",".join(n.addr for n in nodes),
               nodes=nodes)
    ts = [threading.Thread(target=s.stop) for s in [mongo, redis, *nodes]]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


@pytest.mark.parametrize("store,kv", [("mongodb", "redis_cluster"),
                                      ("redis", "redis"),
                                      ("mongodb", "mongodb")])
def test_test_game_on_networked_stores(tmp_path, stores, store, kv):
    dst, gate = _copy_example("test_game", str(tmp_path / "tg"), {
        "storage": f"kind = {store}\ndirectory = {stores[store]}",
        "kvdb": f"kind = {kv}\npath = {stores[kv]}",
    })
    ids: dict = {}

    async def play():
        bots = Bots(gate)
        try:
            a = await _login(bots, "Avatar", "alice", dst)
            b = await _login(bots, "Avatar", "bob", dst)
            ids["alice"], ids["bob"] = a.player.eid, b.player.eid
            # the Pubsub shards are placed a reconcile or two after the
            # deployment is ready (the service claims ride the
            # dispatcher's kvreg), and a call before that is dropped:
            # subscribe (a set: idempotent) and publish until both
            # subscribers received a delivery
            t_end = time.monotonic() + WAIT
            while not all(["news.tpu", "hello"] in _got(x, "OnPublish")
                          for x in (a, b)):
                assert time.monotonic() < t_end, _logs(dst)
                for bot in (a, b):
                    bot.call_server("Subscribe_Client", "news.*")
                await asyncio.sleep(0.5)
                a.call_server("Publish_Client", "news.tpu", "hello")
                await asyncio.sleep(1.0)
            a.call_server("SendMail_Client", "bob", "see you")
            await bots.close()
            # the second login of a name finds its Avatar by the kvdb
            again = await _login(bots, "Avatar", "alice", dst)
            assert again.player.eid == ids["alice"]
        finally:
            await bots.close()
        assert not bots.errors(), bots.errors()

    _serve(dst, play)
    # read back through fresh backends, after the processes are gone
    kvb = kvdb.open_kvdb_backend(kv, stores[kv])
    st = storage.open_backend(store, stores[store])
    try:
        for name, eid in ids.items():
            assert kvb.get(f"avatarOf/{name}") == eid
        saved = {eid: st.read("Avatar", eid) for eid in
                 st.list_entity_ids("Avatar")}
        assert {e: d["name"] for e, d in saved.items()} == {
            eid: name for name, eid in ids.items()}
        assert all(d["level"] >= 1 for d in saved.values())
    finally:
        kvb.close()
        st.close()
