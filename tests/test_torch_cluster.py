"""The port's cluster end to end over localhost sockets: its dispatchers
and gate (``ClusterHarness``), its ``GameServer`` over a World on the CPU
and its strict ``BotClient``s, in the cases of ``tests/test_cluster.py``
(bots log in, get a boot Account, RPC to create an Avatar in a space,
walk, and strict-mode mirrors stay consistent). Two more cases wire the
packages across: the JAX package's ``BotClient`` against the port's
gate, and the port's ``BotClient`` against the JAX package's cluster.

Every socket wait has its own timeout, sized for a loaded test worker;
ports are ephemeral and every harness stops in ``finally``.
"""

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
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.net.botclient import BotClient

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

# waits sized for six loaded test workers
WAIT = 120
LOOPS = 1200   # x 0.05 s


def game_types(pkg) -> dict:
    class Account(pkg.Entity):
        ATTRS = {"status": "client"}

        def OnClientConnected(self):
            self.attrs["status"] = "online"

        def Login_Client(self, name):
            avatar = self.world.create_entity(
                "Avatar", space=self.world._test_space,
                pos=(50.0, 0.0, 50.0),
            )
            avatar.attrs["name"] = name
            self.give_client_to(avatar)
            self.destroy()

    class Avatar(pkg.Entity):
        ATTRS = {"name": "allclients", "level": "client",
                 "hp": "allclients"}

        def OnClientConnected(self):
            self.attrs["level"] = 1

        def Say_Client(self, text):
            self.call_all_clients("OnSay", self.id, text)

    class Arena(pkg.Space):
        pass

    return dict(Account=Account, Avatar=Avatar, Arena=Arena)


# (the World's package, its config modules, the server and the harness)
STACKS = {
    "port": (tent, tstate, taoi, tgame, tstandalone, dict(device="cpu")),
    "jax": (jent, jstate, jaoi, jgame, jstandalone, {}),
}


def start_cluster(stack: str):
    """(harness, world, game server, stop) of one package's stack."""
    pkg, state, aoi, game, standalone, world_kw = STACKS[stack]
    harness = standalone.ClusterHarness(
        n_dispatchers=2, n_gates=1, desired_games=1,
        position_sync_interval_ms=20,
    )
    harness.start(timeout=WAIT)
    gs = None
    stop = threading.Event()
    t = None
    try:
        cfg = state.WorldConfig(
            capacity=256,
            grid=aoi.GridSpec(radius=50.0, extent_x=200.0, extent_z=200.0),
            input_cap=256,
        )
        world = pkg.World(cfg, n_spaces=1, **world_kw)
        for name, c in game_types(pkg).items():
            if name == "Arena":
                world.register_space(name, c)
            else:
                world.register_entity(name, c)
        world.create_nil_space()
        world._test_space = world.create_space("Arena")

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
        stop_cluster(harness, gs, stop, t)
        raise
    return harness, world, gs, (lambda: stop_cluster(harness, gs, stop, t))


def stop_cluster(harness, gs, stop, t) -> None:
    stop.set()
    if t is not None:
        t.join(timeout=30)
    if gs is not None:
        gs.stop()
    harness.stop()


@pytest.fixture()
def cluster():
    harness, world, gs, stop = start_cluster("port")
    try:
        yield harness, world, gs
    finally:
        stop()


def _run_bot(harness, bot: BotClient, duration: float):
    return harness.submit(bot.run(duration))


def test_login_creates_boot_entity_and_avatar(cluster):
    harness, world, gs = cluster
    host, port = harness.gate_addrs[0]
    bot = BotClient(host, port, strict=True)

    def bound() -> bool:
        avatars = [e for e in list(world.entities.values())
                   if e.type_name == "Avatar" and not e.destroyed]
        return len(avatars) == 1 and avatars[0].client is not None

    seen: dict = {}
    done = harness.submit(_bot_login_script(bot, world_check=(bound, seen)))
    done.result(timeout=5 * WAIT)

    assert not bot.errors, bot.errors
    # bot saw its Account first, then the Avatar after Login
    assert bot.player is not None
    assert bot.player.type_name == "Avatar"
    assert bot.player.attrs.get("name") == "bob"
    # the server-side avatar exists and owned the client while the bot
    # was connected (read before the bot hung up: a loaded host may
    # already have unbound it by the time the test reads it after)
    assert seen["bound"]


async def _bot_login_script(bot: BotClient, world_check=None):
    import asyncio

    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        assert bot.player.type_name == "Account"
        # status attr set in OnClientConnected must reach the mirror
        for _ in range(LOOPS):
            if bot.player.attrs.get("status") == "online":
                break
            await asyncio.sleep(0.05)
        assert bot.player.attrs.get("status") == "online"
        bot.call_server("Login_Client", "bob")
        # wait for the Avatar handoff
        for _ in range(LOOPS):
            if bot.player is not None and bot.player.type_name == "Avatar":
                break
            await asyncio.sleep(0.05)
        assert bot.player is not None
        assert bot.player.type_name == "Avatar"
        for _ in range(LOOPS):
            if bot.player.attrs.get("name") == "bob":
                break
            await asyncio.sleep(0.05)
        if world_check is not None:
            check, seen = world_check
            await _until(check)
            seen["bound"] = check()
    finally:
        recv.cancel()
        await bot.conn.close()


def test_two_bots_see_each_other_and_sync(cluster):
    harness, world, gs = cluster
    host, port = harness.gate_addrs[0]
    b1 = BotClient(host, port, bot_id=1, strict=True)
    b2 = BotClient(host, port, bot_id=2, strict=True)

    f1 = harness.submit(_bot_play_script(b1, "alice"))
    f2 = harness.submit(_bot_play_script(b2, "bob"))
    f1.result(timeout=5 * WAIT)
    f2.result(timeout=5 * WAIT)

    assert not b1.errors, b1.errors
    assert not b2.errors, b2.errors
    # both avatars spawn at the same point -> each mirror contains the
    # other avatar (AOI enter -> create_entity on client)
    names1 = {e.attrs.get("name") for e in b1.entities.values()
              if e.type_name == "Avatar"}
    assert "bob" in names1, f"alice's mirror: {names1}"
    names2 = {e.attrs.get("name") for e in b2.entities.values()
              if e.type_name == "Avatar"}
    assert "alice" in names2
    # position syncs flowed (b2 moved -> b1 receives records)
    assert b1.sync_count > 0 or b2.sync_count > 0
    # RPC broadcast: alice Say -> both clients got OnSay
    assert any(m == "OnSay" for _, m, _ in b1.rpc_log)
    assert any(m == "OnSay" for _, m, _ in b2.rpc_log)


def _names(bot) -> set:
    return {e.attrs.get("name") for e in bot.entities.values()
            if e.type_name == "Avatar"}


async def _until(cond) -> None:
    """Wait (bounded) until ``cond()`` holds: a loaded host ticks the
    World slowly, so every step waits for what it needs, not a time."""
    import asyncio

    for _ in range(LOOPS):
        if cond():
            return
        await asyncio.sleep(0.05)


async def _bot_play_script(bot, name: str):
    import asyncio

    other = {"alice": "bob", "bob": "alice"}[name]
    await bot.connect()
    recv = asyncio.ensure_future(bot._recv_loop())
    try:
        await asyncio.wait_for(bot.player_ready.wait(), WAIT)
        bot.call_server("Login_Client", name)
        await _until(lambda: bot.player is not None
                     and bot.player.type_name == "Avatar")
        assert bot.player is not None and bot.player.type_name == "Avatar"
        # both avatars spawn at the same point: wait to see the other
        await _until(lambda: other in _names(bot))
        # move around for a while
        for i in range(20):
            x, y, z = bot.player.pos
            bot.send_position(x + 1.0, y, z + 1.0, 0.1)
            bot.player.pos = (x + 1.0, y, z + 1.0)
            await asyncio.sleep(0.05)
        if name == "alice":
            bot.call_server("Say_Client", "hello world")
        await _until(lambda: any(m == "OnSay" for _, m, _ in bot.rpc_log))
        await _until(lambda: bot.sync_count > 0)
    finally:
        recv.cancel()
        await bot.conn.close()


def test_client_disconnect_detaches_entity(cluster):
    harness, world, gs = cluster
    host, port = harness.gate_addrs[0]
    bot = BotClient(host, port, strict=True)
    harness.submit(_bot_login_script(bot)).result(timeout=5 * WAIT)
    # bot's connection is closed by the script; the gate notifies the
    # dispatcher which notifies the game
    deadline = time.time() + WAIT
    while time.time() < deadline:
        avatars = [e for e in world.entities.values()
                   if e.type_name == "Avatar" and not e.destroyed]
        if avatars and avatars[0].client is None:
            break
        time.sleep(0.1)
    avatars = [e for e in world.entities.values()
               if e.type_name == "Avatar" and not e.destroyed]
    assert avatars and avatars[0].client is None


def test_create_space_anywhere_and_kvreg_traverse(cluster):
    """CreateSpaceAnywhere rides the anywhere placement path (reference
    goworld.go) and kvreg.TraverseByPrefix walks the local mirror."""
    harness, world, gs = cluster
    world.register_space("Lobby", Space, use_aoi=False)
    n_before = sum(1 for s in world.spaces.values()
                   if s.type_name == "Lobby")
    gs.create_entity_anywhere("Lobby", None)
    deadline = time.time() + WAIT
    while time.time() < deadline:
        lobbies = [s for s in world.spaces.values()
                   if s.type_name == "Lobby"]
        if len(lobbies) > n_before:
            break
        time.sleep(0.05)
    assert len(lobbies) == n_before + 1, "space never placed anywhere"

    gs.kvreg_register("Zone/alpha", "1")
    gs.kvreg_register("Zone/beta", "2")
    gs.kvreg_register("Other/x", "9")
    deadline = time.time() + WAIT
    while time.time() < deadline and len(
        [k for k in gs.kvreg if k.startswith("Zone/")]
    ) < 2:
        time.sleep(0.05)
    seen = []
    gs.kvreg_traverse("Zone/", lambda k, v: seen.append((k, v)))
    assert seen == [("Zone/alpha", "1"), ("Zone/beta", "2")]


def test_nosync_bot_mirrors_without_sending(cluster):
    """-nosync parity: the bot logs in and mirrors entities but never
    sends a position sync upstream (reference test_client -nosync)."""
    import asyncio

    harness, world, gs = cluster
    host, port = harness.gate_addrs[0]
    bot = BotClient(host, port, strict=True, nosync=True)

    sent = []
    orig = bot.send_position
    bot.send_position = lambda *a: sent.append(a) or orig(*a)

    async def script():
        await bot.connect()
        recv = asyncio.ensure_future(bot._recv_loop())
        move = asyncio.ensure_future(bot._move_loop())
        try:
            await asyncio.wait_for(bot.player_ready.wait(), WAIT)
            await asyncio.sleep(1.0)   # move loop runs; must stay silent
        finally:
            move.cancel()
            recv.cancel()
            await bot.conn.close()

    harness.submit(script()).result(timeout=WAIT)
    assert bot.player is not None
    assert not sent, "nosync bot sent position syncs"


@pytest.mark.parametrize("stack,bot_mod", [("port", jbot), ("jax", tbot)],
                         ids=["jax_bot_on_port_gate", "port_bot_on_jax"])
def test_cross_wired_bots_play(stack, bot_mod):
    """The JAX package's strict bots against the port's cluster, and the
    port's against the JAX package's: both log in, see each other, sync
    and hear the OnSay, with 0 mirror errors."""
    harness, world, gs, stop = start_cluster(stack)
    try:
        host, port = harness.gate_addrs[0]
        b1 = bot_mod.BotClient(host, port, bot_id=1, strict=True)
        b2 = bot_mod.BotClient(host, port, bot_id=2, strict=True)
        f1 = harness.submit(_bot_play_script(b1, "alice"))
        f2 = harness.submit(_bot_play_script(b2, "bob"))
        f1.result(timeout=5 * WAIT)
        f2.result(timeout=5 * WAIT)
        assert not b1.errors and not b2.errors, (b1.errors, b2.errors)
        for b, other in ((b1, "bob"), (b2, "alice")):
            names = {e.attrs.get("name") for e in b.entities.values()
                     if e.type_name == "Avatar"}
            assert other in names, names
            assert any(m == "OnSay" for _, m, _ in b.rpc_log)
        assert b1.sync_count > 0 or b2.sync_count > 0
    finally:
        stop()
