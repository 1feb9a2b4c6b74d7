"""Bot client — headless game client swarm for integration testing.

Reference being rebuilt: ``examples/test_client`` (``ClientBot.go:200-300``,
``ClientEntity.go``): N bots connect to gates over the real wire protocol,
mirror server entities/attrs locally, random-walk their player entity with
position syncs, and in *strict* mode assert that mirrored state stays
consistent. The bot client is the de-facto fake-client fixture of the whole
test strategy (``SURVEY.md#4``).

This implementation drives one asyncio task per bot; a swarm runner spins
up N bots against a gate address.
"""

from __future__ import annotations

import asyncio
import random
import time

from goworld_tpu_torch.net import codec, proto
from goworld_tpu_torch.net.packet import (
    HEADER_SIZE,
    Packet,
    PacketConnection,
    frame,
    new_packet,
)
from goworld_tpu_torch.utils import log

logger = log.get("bot")


class BotProfiler:
    """Client-side per-second op profiler (reference
    ``examples/test_client/profile.go:20-52``): every op records into the
    current 1-second window; a reporter task prints count / avg / max per
    op each second and folds the window into a cumulative table readable
    at the end (``summary()``). One instance is shared by a whole swarm —
    the reference's profiler is likewise process-global across its bot
    goroutines."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self._window: dict[str, list] = {}   # op -> [count, total, max]
        self._total: dict[str, list] = {}
        self.lines: list[str] = []           # printed per-second reports

    def record(self, op: str, seconds: float) -> None:
        for table in (self._window, self._total):
            row = table.get(op)
            if row is None:
                row = table[op] = [0, 0.0, 0.0]
            row[0] += 1
            row[1] += seconds
            if seconds > row[2]:
                row[2] = seconds

    def op(self, name: str):
        """``with profiler.op("sync"): ...`` timing context."""
        return _ProfOp(self, name)

    def flush(self) -> str | None:
        """Format + reset the current window (one per-second report)."""
        if not self._window:
            return None
        parts = [
            f"{op}: {c}x avg {t / c * 1e3:.2f}ms max {m * 1e3:.2f}ms"
            for op, (c, t, m) in sorted(self._window.items())
        ]
        self._window = {}
        line = " | ".join(parts)
        self.lines.append(line)
        return line

    async def reporter(self) -> None:
        """Per-second print loop; run as a task, cancel to stop."""
        try:
            while True:
                await asyncio.sleep(self.interval)
                line = self.flush()
                if line:
                    logger.info("bot profile: %s", line)
        except asyncio.CancelledError:
            line = self.flush()
            if line:
                logger.info("bot profile: %s", line)

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            op: {
                "count": c,
                "avg_ms": t / c * 1e3 if c else 0.0,
                "max_ms": m * 1e3,
            }
            for op, (c, t, m) in sorted(self._total.items())
        }


class _ProfOp:
    __slots__ = ("_p", "_name", "_t0")

    def __init__(self, p: BotProfiler, name: str):
        self._p = p
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._p.record(self._name, time.perf_counter() - self._t0)


class MirrorEntity:
    """Client-side mirror of a server entity (reference ``clientEntity``)."""

    __slots__ = ("eid", "type_name", "is_player", "attrs", "pos", "yaw")

    def __init__(self, eid: str, type_name: str, is_player: bool,
                 attrs: dict, pos: tuple, yaw: float):
        self.eid = eid
        self.type_name = type_name
        self.is_player = is_player
        self.attrs = attrs
        self.pos = pos
        self.yaw = yaw

    def apply_deltas(self, deltas: list[dict]) -> None:
        """Apply server attr deltas to the local mirror (reference
        ``ClientBot.go:240-300`` applyMapAttrChange et al)."""
        for d in deltas:
            path, op, value = d["path"], d["op"], d.get("value")
            node = self.attrs
            for key in path[:-1]:
                if isinstance(node, list):
                    node = node[int(key)]
                else:
                    node = node.setdefault(key, {})
            last = path[-1] if path else None
            if op == "set":
                if isinstance(node, list):
                    node[int(last)] = value
                else:
                    node[last] = value
            elif op == "del":
                if isinstance(node, list):
                    del node[int(last)]
                else:
                    node.pop(last, None)
            elif op == "append":
                node2 = node[last] if last is not None else node
                node2.append(value)
            elif op == "pop":
                node2 = node[last] if last is not None else node
                if node2:
                    node2.pop()


class WSPacketConnection:
    """PacketConnection interface over a websocket: one binary WS message
    per framed packet (matches the gate's ``_serve_ws``, which mirrors the
    reference's websocket edge, ``GateService.go:121-168``)."""

    def __init__(self, ws):
        self.ws = ws
        self._closed = False

    def send(self, p: Packet, release: bool = True) -> None:
        if not self._closed:
            data = bytes(frame(p))
            asyncio.ensure_future(self.ws.send(data))
        if release:
            p.release()

    async def drain(self) -> None: ...

    async def recv(self) -> tuple[int, Packet]:
        msg = await self.ws.recv()
        if not isinstance(msg, (bytes, bytearray)):
            raise ConnectionError("non-binary ws message")
        p = Packet(bytes(msg)[HEADER_SIZE:])
        return p.read_u16(), p

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            await self.ws.close()
        except Exception:
            pass

    @property
    def closed(self) -> bool:
        # mirror PacketConnection.closed (the bot's heartbeat loop
        # keys its liveness check on it); the underlying websocket may
        # also be closed by the peer without close() ever being called
        return self._closed or not getattr(self.ws, "open", True)


class BotClient:
    """One bot: connects, waits for its player entity, random-walks.

    ``ws=True`` connects through the gate's websocket listener instead of
    TCP (the reference test_client's ``-ws`` flag); ``kcp=True`` dials the
    gate's reliable-UDP listener (the ``-kcp`` flag, GateService.go:
    129-161); ``compress``/``tls`` mirror the gate's client-edge
    transport flags (the reference client reads the same ini the gate
    does)."""

    def __init__(self, host: str, port: int, *, bot_id: int = 0,
                 strict: bool = False, move_interval: float = 0.1,
                 speed: float = 5.0, seed: int | None = None,
                 ws: bool = False, kcp: bool = False,
                 compress: bool = False, compress_codec: str = "snappy",
                 tls: bool = False,
                 nosync: bool = False,
                 profiler: BotProfiler | None = None):
        self.host = host
        self.port = port
        self.ws = ws
        self.kcp = kcp
        self.compress = compress
        self.compress_codec = compress_codec
        self.tls = tls
        # reference test_client -nosync: connect and mirror but never
        # send position syncs (isolates the downstream pipeline)
        self.nosync = nosync
        self.bot_id = bot_id
        self.strict = strict
        self.move_interval = move_interval
        self.speed = speed
        self.rng = random.Random(seed if seed is not None else bot_id)
        self.conn: PacketConnection | None = None
        self.entities: dict[str, MirrorEntity] = {}
        self.player: MirrorEntity | None = None
        self.player_ready = asyncio.Event()
        self.rpc_log: list[tuple[str, str, list]] = []
        self.sync_count = 0
        self.errors: list[str] = []
        self.profiler = profiler
        self._stop = False
        self._hb_task: asyncio.Task | None = None

    # periodic client heartbeat (reference ClientBot sends heartbeats on
    # a timer): keeps a quiet bot alive under the gate's default
    # heartbeat_timeout (30 s reap; docs/ROBUSTNESS.md). Well under half
    # the timeout so one lost heartbeat never kicks the session.
    HEARTBEAT_INTERVAL = 10.0

    async def _heartbeat_loop(self) -> None:
        try:
            while not self._stop and self.conn is not None \
                    and not getattr(self.conn, "closed", False):
                try:
                    self.send_heartbeat()
                except Exception:
                    return  # transport gone (e.g. closed websocket)
                await asyncio.sleep(self.HEARTBEAT_INTERVAL)
        except asyncio.CancelledError:
            pass

    # ------------------------------------------------------------------
    async def connect(self) -> None:
        await self._connect_transport()
        self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    async def _connect_transport(self) -> None:
        if self.ws:
            from goworld_tpu_torch.net import ws as ws_mod

            sock = await ws_mod.connect(
                f"ws://{self.host}:{self.port}"
            )
            self.conn = WSPacketConnection(sock)
            return
        if self.kcp:
            from goworld_tpu_torch.net.kcp import open_kcp_connection

            reader, writer = await open_kcp_connection(
                self.host, self.port
            )
            self.conn = PacketConnection(
                reader, writer, compress=self.compress,
                compress_codec=self.compress_codec)
            return
        ssl_ctx = None
        if self.tls:
            from goworld_tpu_torch.net.transport import client_ssl_context

            ssl_ctx = client_ssl_context(verify=False)
        reader, writer = await asyncio.open_connection(
            self.host, self.port, ssl=ssl_ctx
        )
        self.conn = PacketConnection(
            reader, writer, compress=self.compress,
            compress_codec=self.compress_codec)

    async def run(self, duration: float = 5.0) -> None:
        """Connect and play for ``duration`` seconds."""
        await self.connect()
        recv = asyncio.ensure_future(self._recv_loop())
        move = asyncio.ensure_future(self._move_loop())
        try:
            await asyncio.sleep(duration)
        finally:
            self._stop = True
            move.cancel()
            recv.cancel()
            if self._hb_task is not None:
                self._hb_task.cancel()
            await self.conn.close()

    async def _recv_loop(self) -> None:
        try:
            while True:
                msgtype, pkt = await self.conn.recv()
                self._handle(msgtype, pkt)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass

    # op names for the per-second profiler, keyed by msgtype
    _PROF_OPS = {
        proto.MT_CREATE_ENTITY_ON_CLIENT: "create_entity",
        proto.MT_DESTROY_ENTITY_ON_CLIENT: "destroy_entity",
        proto.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT: "attr_change",
        proto.MT_CALL_ENTITY_METHOD_ON_CLIENT: "rpc_on_client",
        proto.MT_CLIENT_SYNC_POSITION_YAW: "sync_batch",
    }

    def _handle(self, msgtype: int, pkt: Packet) -> None:
        if self.profiler is not None:
            op = self._PROF_OPS.get(msgtype, f"msgtype_{msgtype}")
            with self.profiler.op(op):
                self._handle_inner(msgtype, pkt)
            return
        self._handle_inner(msgtype, pkt)

    def _handle_inner(self, msgtype: int, pkt: Packet) -> None:
        if msgtype == proto.MT_CREATE_ENTITY_ON_CLIENT:
            eid = pkt.read_entity_id()
            type_name = pkt.read_var_str()
            is_player = pkt.read_bool()
            x, y, z, yaw = (pkt.read_f32() for _ in range(4))
            attrs = pkt.read_data()
            prev = self.entities.get(eid)
            if prev is not None:
                # re-create is an UPSERT, matching the reference client
                # (ClientBot.go:240-300 overwrites silently): interest is
                # re-announced after a hot reload re-enters AOI. A TYPE
                # change for a live id is still a real inconsistency.
                if self.strict and prev.type_name != type_name:
                    self.errors.append(
                        f"create_entity {eid} changed type "
                        f"{prev.type_name} -> {type_name}"
                    )
            me = MirrorEntity(eid, type_name, is_player, attrs, (x, y, z),
                              yaw)
            self.entities[eid] = me
            if is_player:
                self.player = me
                self.player_ready.set()
        elif msgtype == proto.MT_DESTROY_ENTITY_ON_CLIENT:
            eid = pkt.read_entity_id()
            is_player = pkt.read_bool()
            gone = self.entities.pop(eid, None)
            if self.strict and gone is None:
                self.errors.append(f"destroy of unknown entity {eid}")
            if is_player and self.player is not None \
                    and self.player.eid == eid:
                self.player = None
                self.player_ready.clear()
        elif msgtype == proto.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT:
            eid = pkt.read_entity_id()
            deltas = pkt.read_data()
            me = self.entities.get(eid)
            if me is not None:
                me.apply_deltas(deltas)
            elif self.strict:
                self.errors.append(f"attr change for unknown entity {eid}")
        elif msgtype == proto.MT_CALL_ENTITY_METHOD_ON_CLIENT:
            eid = pkt.read_entity_id()
            method = pkt.read_var_str()
            args = pkt.read_args()
            self.rpc_log.append((eid, method, args))
        elif msgtype == proto.MT_CLIENT_SYNC_POSITION_YAW:
            eids, vals = codec.decode_sync_batch(
                memoryview(pkt.buf)[pkt.rpos:]
            )
            for eid_b, v in zip(eids, vals):
                me = self.entities.get(eid_b.decode("ascii", "replace"))
                if me is not None:
                    me.pos = (float(v[0]), float(v[1]), float(v[2]))
                    me.yaw = float(v[3])
                    self.sync_count += 1
        elif msgtype == proto.MT_HEARTBEAT:
            pass
        else:
            logger.warning("bot%d: unhandled msgtype %d", self.bot_id,
                           msgtype)

    # ------------------------------------------------------------------
    async def _move_loop(self) -> None:
        """Random-walk + position sync every move interval (reference
        ``ClientBot.go:214-227``: 50% move probability per 100 ms)."""
        try:
            await self.player_ready.wait()
            while not self._stop:
                await asyncio.sleep(self.move_interval)
                if self.nosync or self.player is None \
                        or self.rng.random() < 0.5:
                    continue
                x, y, z = self.player.pos
                x += self.rng.uniform(-self.speed, self.speed)
                z += self.rng.uniform(-self.speed, self.speed)
                yaw = self.rng.uniform(0, 6.28)
                self.player.pos = (x, y, z)
                self.player.yaw = yaw
                self.send_position(x, y, z, yaw)
        except asyncio.CancelledError:
            pass

    def send_position(self, x: float, y: float, z: float,
                      yaw: float) -> None:
        if self.player is None or self.conn is None:
            return
        p = new_packet(proto.MT_CLIENT_SYNC_POSITION_YAW)
        p.append_bytes(
            codec.encode_sync_batch([self.player.eid], [[x, y, z, yaw]])
        )
        self.conn.send(p)
        if self.profiler is not None:
            self.profiler.record("send_position", 0.0)

    def call_server(self, method: str, *args) -> None:
        """Client->server RPC on the player entity."""
        if self.player is None or self.conn is None:
            return
        p = new_packet(proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
        p.append_entity_id(self.player.eid)
        p.append_var_str(method)
        p.append_args(args)
        self.conn.send(p)

    def send_heartbeat(self) -> None:
        if self.conn is not None:
            self.conn.send(new_packet(proto.MT_HEARTBEAT))


async def run_swarm(host: str, port: int, n_bots: int, duration: float,
                    *, strict: bool = True, compress: bool = False,
                    tls: bool = False, kcp: bool = False,
                    nosync: bool = False,
                    profile: bool = False) -> list[BotClient]:
    """Run N bots concurrently (reference ``test_client -N``; mirrors
    the ``-strict``/``-kcp``/``-nosync`` flags; per-bot ``ws`` is a
    BotClient option). ``profile=True`` shares one :class:`BotProfiler`
    across the swarm with a per-second report task (the reference's
    ``profile.go`` loop); read ``bots[0].profiler.summary()`` after."""
    profiler = BotProfiler() if profile else None
    bots = [
        BotClient(host, port, bot_id=i, strict=strict, compress=compress,
                  tls=tls, kcp=kcp, nosync=nosync, profiler=profiler)
        for i in range(n_bots)
    ]
    rep = (
        asyncio.ensure_future(profiler.reporter())
        if profiler is not None else None
    )
    try:
        await asyncio.gather(*(b.run(duration) for b in bots))
    finally:
        if rep is not None:
            rep.cancel()
            try:
                await rep
            except asyncio.CancelledError:
                pass
    return bots
