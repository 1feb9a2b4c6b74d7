"""Dispatcher-cluster client: every game/gate holds one connection per
dispatcher and routes by EntityID hash.

Reference being rebuilt: ``engine/dispatchercluster`` (``Initialize``,
``SelectByEntityID/ByGateID``, send wrappers — ``dispatchercluster.go:18-135``)
and ``engine/dispatchercluster/dispatcherclient`` (connect-forever loop,
re-handshake with entity census on reconnect — ``DispatcherConnMgr.go:63-131``).

Routing (reference ``hash.go:7-12``): hash the last two bytes of the
16-char EntityID modulo dispatcher count; gates route themselves by
``(gate_id - 1) % n``. Identical hashing on every process is what makes the
sharded star consistent.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Awaitable, Callable

from goworld_tpu_torch.net.packet import Packet, PacketConnection, wire_payload
from goworld_tpu_torch.utils import consts, log, metrics

logger = log.get("cluster")


def entity_shard(eid: str, n: int) -> int:
    """Dispatcher index for an EntityID (reference ``hash.go:7-12``)."""
    if n == 1:
        return 0
    b = eid.encode("ascii", "replace")
    return (b[-2] << 8 | b[-1]) % n


def srv_shard(srv_id: str, n: int) -> int:
    """Dispatcher index for a service/registry key (string hash)."""
    if n == 1:
        return 0
    h = 0
    for ch in srv_id.encode():
        h = (h * 31 + ch) & 0xFFFFFFFF
    return h % n


class DispatcherConn:
    """Connect-forever manager for ONE dispatcher (reference
    ``DispatcherConnMgr``). ``handshake`` is awaited after every (re)connect;
    received packets go to ``on_packet``; sends while disconnected queue."""

    def __init__(
        self,
        index: int,
        addr: tuple[str, int],
        on_packet: Callable[[int, int, Packet], None],
        handshake: Callable[["DispatcherConn"], Awaitable[None]],
        reconnect_delay: float = 1.0,
        edge: str = "",
        pend_max_packets: int = consts.MAX_RECONNECT_PEND_PACKETS,
        pend_max_bytes: int = consts.MAX_RECONNECT_PEND_BYTES,
    ):
        self.index = index
        self.addr = addr
        self.on_packet = on_packet
        self.handshake = handshake
        self.reconnect_delay = reconnect_delay
        self.edge = edge  # fault-injection label (utils/faults.py)
        self.conn: PacketConnection | None = None
        # reconnect pend queue, BOUNDED by a packet + byte budget with a
        # drop-oldest policy: a long dispatcher outage must degrade to
        # bounded message loss (counted below), never to unbounded
        # process growth. Oldest-first because queued cluster messages
        # age badly — the census re-handshake on reconnect re-asserts
        # current state anyway.
        self._pending: deque[bytes] = deque()
        self._pending_bytes = 0
        self.pend_max_packets = pend_max_packets
        self.pend_max_bytes = pend_max_bytes
        self._m_pend_dropped = metrics.counter(
            "cluster_pend_dropped_total",
            help="queued-while-disconnected packets dropped on overflow",
            dispatcher=str(index),
        )
        self._pend_warned = False
        self.connected = asyncio.Event()
        self._stopped = False
        # fired on every connection loss (before the reconnect sleep);
        # the gate uses this to terminate instead of reconnecting
        # (reference gate.go:137-143)
        self.on_disconnect = None

    async def run(self) -> None:
        """The assureConnected/serve loop; returns only when stopped."""
        while not self._stopped:
            try:
                reader, writer = await asyncio.open_connection(*self.addr)
            except OSError:
                await asyncio.sleep(self.reconnect_delay)
                continue
            self.conn = PacketConnection(reader, writer, edge=self.edge)
            try:
                await self.handshake(self)
                while self._pending:
                    self.conn.send(Packet(self._pending.popleft()),
                                   release=False)
                self._pending_bytes = 0
                self._pend_warned = False
                self.connected.set()
                while True:
                    msgtype, pkt = await self.conn.recv()
                    self.on_packet(self.index, msgtype, pkt)
            except (EOFError, ConnectionError, OSError):
                # EOFError also covers a malformed/truncated packet
                # whose decode underran (IncompleteReadError is an
                # EOFError subclass): sever + reconnect, never wedge
                pass
            finally:
                self.connected.clear()
                await self.conn.close()
                self.conn = None
            if not self._stopped:
                logger.warning(
                    "lost dispatcher%d at %s; reconnecting",
                    self.index, self.addr,
                )
                if self.on_disconnect is not None:
                    self.on_disconnect(self.index)
                await asyncio.sleep(self.reconnect_delay)

    def send(self, p: Packet, release: bool = True) -> None:
        if self.conn is not None and not self.conn.closed:
            self.conn.send(p, release=release)
        else:
            # wire_payload keeps a trace trailer through the reconnect
            # queue (byte-identical to p.buf when untraced); the flush
            # sends the stored bytes verbatim
            raw = wire_payload(p)
            self._pending.append(raw)
            self._pending_bytes += len(raw)
            while self._pending and (
                len(self._pending) > self.pend_max_packets
                or self._pending_bytes > self.pend_max_bytes
            ):
                self._pending_bytes -= len(self._pending.popleft())
                self._m_pend_dropped.inc()
                if not self._pend_warned:
                    self._pend_warned = True
                    logger.warning(
                        "dispatcher%d reconnect queue over budget "
                        "(%d pkts / %d B): dropping oldest (counted in "
                        "cluster_pend_dropped_total)", self.index,
                        self.pend_max_packets, self.pend_max_bytes,
                    )
            if release:
                p.release()

    def stop(self) -> None:
        self._stopped = True


class DispatcherCluster:
    """All dispatcher connections of one game/gate process."""

    def __init__(
        self,
        addrs: list[tuple[str, int]],
        on_packet: Callable[[int, int, Packet], None],
        handshake: Callable[[DispatcherConn], Awaitable[None]],
        edge: str = "",
        pend_max_packets: int = consts.MAX_RECONNECT_PEND_PACKETS,
        pend_max_bytes: int = consts.MAX_RECONNECT_PEND_BYTES,
    ):
        self.conns = [
            DispatcherConn(i, a, on_packet, handshake, edge=edge,
                           pend_max_packets=pend_max_packets,
                           pend_max_bytes=pend_max_bytes)
            for i, a in enumerate(addrs)
        ]
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        self._tasks = [
            asyncio.ensure_future(c.run()) for c in self.conns
        ]

    async def wait_connected(self, timeout: float = 30.0) -> None:
        await asyncio.wait_for(
            asyncio.gather(*(c.connected.wait() for c in self.conns)),
            timeout,
        )

    def stop(self) -> None:
        for c in self.conns:
            c.stop()
        for t in self._tasks:
            t.cancel()

    # -- selection (reference dispatchercluster.go:115-135) -------------
    def select_by_entity_id(self, eid: str) -> DispatcherConn:
        return self.conns[entity_shard(eid, len(self.conns))]

    def select_by_gate_id(self, gate_id: int) -> DispatcherConn:
        return self.conns[(gate_id - 1) % len(self.conns)]

    def select_by_srv_id(self, srv_id: str) -> DispatcherConn:
        return self.conns[srv_shard(srv_id, len(self.conns))]

    def broadcast(self, p: Packet) -> None:
        for c in self.conns:
            c.send(Packet(bytes(p.buf)), release=False)
        p.release()
