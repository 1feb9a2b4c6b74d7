"""The port's client edges against the JAX package's, through a gate.

A JAX ``BotClient(ws=True)`` logs into the port's gate over WebSocket
(the JAX bot speaks through the third-party ``websockets`` package where
it is installed, the port's gate through its own ``net/ws.py``), and the
port's bot logs into the JAX package's gate. The same holds over KCP and
over TCP with the snappy stream codec, and the port's bot on the port's
gate over each. Each bot logs in strict, gets its Account, asks for an
Avatar and gets it. The last cases run the port's ``net/ws.py`` against
itself and against the ``websockets`` package: handshake, both frame
types, the three length forms, ping and close.

Each package's stack (dispatchers and a gate with TCP + snappy, WS and
KCP listeners, and a game on a World on the CPU) starts once for the
module; every wait has its own timeout, sized for a loaded worker."""

from __future__ import annotations

import asyncio
import os
import threading
import time

import pytest
import torch

import goworld_tpu.core.state as jstate
import goworld_tpu.entity as jent
import goworld_tpu.net.botclient as jbot
import goworld_tpu.net.game as jgame
import goworld_tpu.net.standalone as jstandalone
import goworld_tpu.ops.aoi as jaoi
import goworld_tpu_torch.core.state as tstate
import goworld_tpu_torch.entity as tent
import goworld_tpu_torch.net.botclient as tbot
import goworld_tpu_torch.net.game as tgame
import goworld_tpu_torch.net.standalone as tstandalone
import goworld_tpu_torch.ops.aoi as taoi
from goworld_tpu_torch.net import ws

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

WAIT = 120

STACKS = {
    "port": (tent, tstate, taoi, tgame, tstandalone, dict(device="cpu")),
    "jax": (jent, jstate, jaoi, jgame, jstandalone, {}),
}
BOTS = {"port": tbot.BotClient, "jax": jbot.BotClient}


def _types(pkg) -> dict:
    class Account(pkg.Entity):
        ATTRS = {"status": "client"}

        def OnClientConnected(self):
            self.attrs["status"] = "online"

        def Login_Client(self, name):
            avatar = self.world.create_entity(
                "Avatar", space=self.world._arena, pos=(50.0, 0.0, 50.0))
            avatar.attrs["name"] = name
            self.give_client_to(avatar)
            self.destroy()

    class Avatar(pkg.Entity):
        ATTRS = {"name": "allclients"}

    class Arena(pkg.Space):
        pass

    return dict(Account=Account, Avatar=Avatar, Arena=Arena)


def _start(stack: str):
    pkg, state, aoi, game, standalone, world_kw = STACKS[stack]
    harness = standalone.ClusterHarness(
        n_dispatchers=1, n_gates=1, desired_games=1, with_ws=True,
        with_kcp=True, compress=True)
    harness.start(timeout=WAIT)
    stop = threading.Event()
    gs, t = None, None
    try:
        world = pkg.World(state.WorldConfig(
            capacity=128, grid=aoi.GridSpec(radius=50.0, extent_x=200.0,
                                            extent_z=200.0)),
            n_spaces=1, **world_kw)
        for name, c in _types(pkg).items():
            if name == "Arena":
                world.register_space(name, c)
            else:
                world.register_entity(name, c)
        world.create_nil_space()
        world._arena = world.create_space("Arena")
        gs = game.GameServer(1, world, list(harness.dispatcher_addrs),
                             boot_entity="Account")
        gs.start_network()

        def loop():
            while not stop.is_set():
                gs.pump()
                gs.tick()
                time.sleep(0.01)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        assert gs.ready_event.wait(WAIT), "deployment never became ready"
    except BaseException:
        _stop(harness, gs, stop, t)
        raise
    return harness, (lambda: _stop(harness, gs, stop, t))


def _stop(harness, gs, stop, t) -> None:
    stop.set()
    if t is not None:
        t.join(timeout=30)
    if gs is not None:
        gs.stop()
    harness.stop()


@pytest.fixture(scope="module")
def stacks():
    started: dict = {}
    try:
        for name in ("port", "jax"):
            started[name] = _start(name)
        yield {name: h for name, (h, _) in started.items()}
    finally:
        for _, stop in started.values():
            stop()


async def _login(bot, name: str) -> None:
    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        assert bot.player.type_name == "Account"
        bot.call_server("Login_Client", name)
        for _ in range(WAIT * 20):
            p = bot.player
            if p is not None and p.type_name == "Avatar" \
                    and p.attrs.get("name") == name:
                break
            await asyncio.sleep(0.05)
    finally:
        recv.cancel()
        await bot.conn.close()


@pytest.mark.parametrize("transport", ["ws", "kcp", "tcp_snappy"])
@pytest.mark.parametrize("bot_pkg,gate_pkg", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_bot_logs_in_across_packages(stacks, bot_pkg, gate_pkg, transport):
    harness = stacks[gate_pkg]
    if transport == "ws":
        addr, kw = harness.gate_ws_addrs[0], dict(ws=True)
    elif transport == "kcp":
        addr, kw = harness.gate_kcp_addrs[0], dict(
            kcp=True, compress=True, compress_codec="snappy")
    else:
        addr, kw = harness.gate_addrs[0], dict(
            compress=True, compress_codec="snappy")
    name = f"{bot_pkg}-{transport}"
    bot = BOTS[bot_pkg](*addr, strict=True, **kw)
    harness.submit(_login(bot, name)).result(timeout=3 * WAIT)
    assert not bot.errors, bot.errors
    assert bot.player is not None and bot.player.type_name == "Avatar"
    assert bot.player.attrs.get("name") == name


async def _echo_server(lib):
    async def handler(sock):
        async for msg in sock:
            await sock.send(msg)

    srv = await lib.serve(handler, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def _roundtrip(client) -> None:
    for msg in (b"\x00\x01bin", "text", os.urandom(1000),
                os.urandom(70 * 1024)):
        await client.send(msg)
        assert await client.recv() == msg


@pytest.mark.parametrize("server_lib,client_lib", [
    ("port", "port"), ("websockets", "port"), ("port", "websockets")])
def test_ws_roundtrip(server_lib, client_lib):
    """Echo through the port's ``net/ws.py`` on one side or both, the
    ``websockets`` package on the other: binary and text frames, the 7,
    16 and 64-bit length forms, a ping answered without disturbing the
    stream (port client), and a clean close."""
    websockets = pytest.importorskip("websockets")
    libs = {"port": ws, "websockets": websockets}

    async def main():
        srv, port = await _echo_server(libs[server_lib])
        client = await libs[client_lib].connect(f"ws://127.0.0.1:{port}")
        await _roundtrip(client)
        if client_lib == "port":
            await client._send_frame(ws.OP_PING, b"hb")
            await client.send(b"after-ping")
            assert await client.recv() == b"after-ping"
        await client.close()
        if client_lib == "port":
            assert not client.open
        srv.close()
        await srv.wait_closed()

    asyncio.run(asyncio.wait_for(main(), WAIT))
