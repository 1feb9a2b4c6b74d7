"""Gate — terminates client connections and routes client<->dispatcher.

Reference being rebuilt: ``components/gate/GateService.go`` (TCP/WebSocket
listeners, ClientProxy bookkeeping, boot-entity id generated ON the gate,
heartbeat timeout, per-dispatcher upstream sync batching, downstream sync
de-mux) and ``components/gate/FilterTree.go`` (filter-prop indexes driving
``CallFilteredClients`` broadcasts).

A client's wire protocol is the same framed packet format as the server
side; the redirect message range (1000-1499) arrives from the dispatcher
with a ``[gate_id u16][client_id 16B]`` routing prefix which the gate strips
before forwarding the rest to the client socket verbatim.
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict

import numpy as np

from goworld_tpu_torch.net import codec, proto
from goworld_tpu_torch.net import ws as ws_mod
from goworld_tpu_torch.net.cluster import DispatcherCluster, DispatcherConn
from goworld_tpu_torch.net.packet import (
    HEADER_SIZE,
    MSGTYPE_MASK,
    Packet,
    PacketConnection,
    decode_wire,
    frame,
    new_packet,
)
from goworld_tpu_torch.utils import consts, faults, flightrec, ids, log, \
    metrics, opmon, overload, syncage, tracing

logger = log.get("gate")


class ClientProxy:
    """One connected game client (reference ``ClientProxy.go:29-53``)."""

    __slots__ = ("client_id", "conn", "owner_eid", "filter_props",
                 "last_heartbeat", "bucket", "byte_bucket",
                 "down_full_since")

    def __init__(self, conn: PacketConnection):
        self.client_id = ids.gen_entity_id()
        self.conn = conn
        self.owner_eid = ""      # set when the game binds a player entity
        self.filter_props: dict[str, str] = {}
        self.last_heartbeat = 0.0
        # admission control (set by the gate when rate limits are on)
        self.bucket: overload.TokenBucket | None = None
        self.byte_bucket: overload.TokenBucket | None = None
        # monotonic instant the downstream buffer FIRST refused a send
        # (None = healthy); a client stuck past the kick window is
        # disconnected rather than wedging memory
        self.down_full_since: float | None = None

    def downstream_buffered(self) -> int:
        """Bytes sitting unsent in this client's socket buffer (0 when
        the transport cannot say — e.g. the WS adapter)."""
        try:
            return self.conn.writer.transport.get_write_buffer_size()
        except (AttributeError, RuntimeError):
            return 0

    def send(self, p: Packet, release: bool = True) -> None:
        self.conn.send(p, release=release)


class FilterIndex:
    """Per-key prop index for filtered broadcasts (reference
    ``FilterTree.go:13-102``; the LLRB becomes sort-at-query over a val->
    clients map — updates are the hot side, broadcasts are rare)."""

    def __init__(self):
        self._by_key: dict[str, dict[str, set[ClientProxy]]] = \
            defaultdict(lambda: defaultdict(set))

    def set_prop(self, cp: ClientProxy, key: str, val: str) -> None:
        old = cp.filter_props.get(key)
        if old is not None:
            self._by_key[key][old].discard(cp)
        cp.filter_props[key] = val
        self._by_key[key][val].add(cp)

    def drop_client(self, cp: ClientProxy) -> None:
        for key, val in cp.filter_props.items():
            self._by_key[key][val].discard(cp)
        cp.filter_props.clear()

    def query(self, key: str, op: int, val: str) -> set[ClientProxy]:
        vals = self._by_key.get(key)
        if not vals:
            return set()
        out: set[ClientProxy] = set()
        for v, clients in vals.items():
            if (
                (op == proto.FILTER_EQ and v == val)
                or (op == proto.FILTER_NE and v != val)
                or (op == proto.FILTER_GT and v > val)
                or (op == proto.FILTER_LT and v < val)
                or (op == proto.FILTER_GTE and v >= val)
                or (op == proto.FILTER_LTE and v <= val)
            ):
                out |= clients
        return out


class GateService:
    """One gate process (``serve()`` runs until cancelled)."""

    def __init__(
        self,
        gate_id: int,
        host: str,
        port: int,
        dispatcher_addrs: list[tuple[str, int]],
        *,
        ws_port: int = 0,
        kcp_port: int = 0,
        kcp_idle_timeout: float = 60.0,
        heartbeat_timeout: float = 0.0,
        position_sync_interval_ms: int = 100,
        compress: bool = False,
        compress_codec: str = "snappy",
        ssl_context=None,
        exit_on_dispatcher_loss: bool = True,
        pend_max_packets: int = consts.MAX_RECONNECT_PEND_PACKETS,
        pend_max_bytes: int = consts.MAX_RECONNECT_PEND_BYTES,
        max_clients: int = 0,
        rate_limit_pps: float = 0.0,
        rate_limit_bps: float = 0.0,
        downstream_max_bytes: int = consts.GATE_DOWNSTREAM_MAX_BYTES,
        downstream_kick_secs: float = consts.GATE_DOWNSTREAM_KICK_SECS,
        sync_age_target_ms: float = syncage.DEFAULT_TARGET_MS,
        flightrec_ring: int = 256,
        flightrec_cooldown_secs: float = flightrec.DEFAULT_COOLDOWN_SECS,
    ):
        self.gate_id = gate_id
        self.host = host
        self.port = port
        self.ws_port = ws_port
        # reliable-UDP client edge (reference GateService.go:129-161
        # serveKCP with turbo tuning): same framed protocol over
        # net/kcp.py sessions; 0 = no KCP listener
        self.kcp_port = kcp_port
        # KCP sessions self-reap after this many seconds without an
        # inbound datagram — independent of heartbeat_timeout, which
        # defaults off; without it a vanished UDP peer (no connection_lost,
        # no unacked data) would pin its session forever
        self.kcp_idle_timeout = kcp_idle_timeout
        # client-edge transport options (reference ClientProxy.go:38-53
        # snappy + TLS; see net/transport.py for the codec choice and the
        # KCP deviation note). Compression/TLS apply to the TCP listener;
        # WebSocket clients get compression from the WS layer itself.
        self.compress = compress
        self.compress_codec = compress_codec
        self.ssl_context = ssl_context
        self.heartbeat_timeout = heartbeat_timeout
        self.sync_interval = position_sync_interval_ms / 1000.0
        self.clients: dict[str, ClientProxy] = {}
        self.filter_index = FilterIndex()
        # delta-compressed sync decoders, one PER SENDING
        # GAME: pure functions of each game's byte stream —
        # baselines/handles all arrive in-band
        self._sync_delta_dec: dict[int, codec.DeltaSyncDecoder] = {}
        self.cluster = DispatcherCluster(
            dispatcher_addrs, self._on_dispatcher_packet, self._handshake,
            edge="gate->dispatcher",
            pend_max_packets=pend_max_packets,
            pend_max_bytes=pend_max_bytes,
        )
        # a gate that lost a dispatcher is routing into a black hole:
        # the reference kills itself and lets the supervisor restart it
        # (gate.go:137-143). Harness/tests may opt out to exercise
        # reconnect paths.
        self.exit_on_dispatcher_loss = exit_on_dispatcher_loss
        self.terminated = asyncio.Event()
        if exit_on_dispatcher_loss:
            for c in self.cluster.conns:
                c.on_disconnect = self._on_dispatcher_lost
        # per-dispatcher pending upstream sync records
        # (reference GateService.go:402-429)
        self._sync_pending: dict[int, bytearray] = defaultdict(bytearray)
        self._server: asyncio.AbstractServer | None = None
        self._ws_server = None
        self._kcp_server = None
        self.started = asyncio.Event()
        self.ws_started = asyncio.Event()
        # scrapeable gate series (debug_http /metrics): client packet
        # handle latency and downstream batch sizes (the reference wraps
        # handling in opmon, GateService.go:435-442 — same signal, now
        # as a histogram a scraper can take percentiles from)
        self._m_handle_ms = metrics.histogram(
            "gate_packet_handle_ms",
            help="client packet handle latency")
        self._m_down_batch = metrics.histogram(
            "gate_downstream_batch_records",
            buckets=metrics.DEFAULT_SIZE_BUCKETS,
            help="records per downstream batch from games")
        # admission control (utils/overload.py; docs/ROBUSTNESS.md
        # "Overload & degradation"): connection cap, per-client
        # token-bucket rate limits, bounded per-client downstream
        # buffers with a kick-never-wedge policy, and the gate's own
        # overload ladder (REJECTING refuses new handshakes)
        self.max_clients = int(max_clients)
        self.rate_limit_pps = float(rate_limit_pps)
        self.rate_limit_bps = float(rate_limit_bps)
        self.downstream_max_bytes = int(downstream_max_bytes)
        self.downstream_kick_secs = float(downstream_kick_secs)
        self.overload = overload.register(overload.OverloadGovernor(
            f"gate{gate_id}",
            # the gate is evaluated at the flush cadence (~10 Hz), not
            # 60 Hz, so the descent run is shorter in observations
            down_ticks=max(8, consts.OVERLOAD_DOWN_TICKS // 4),
        ))
        self._m_down_dropped = metrics.counter(
            "gate_downstream_dropped_total",
            help="client-bound packets dropped on a full per-client "
                 "downstream buffer")
        self._m_kicked = metrics.counter(
            "gate_downstream_kicked_total",
            help="clients disconnected after their downstream buffer "
                 "stayed full past the kick window")
        self._m_rejected = metrics.counter(
            "gate_rejected_connects_total",
            help="client handshakes refused (REJECTING state or "
                 "max_clients cap)")
        # clients whose downstream buffer is currently refusing sends,
        # maintained incrementally by _send_to_client/_drop_client so
        # the governor reads an O(1) FRACTION — one stalled phone must
        # not read as gate-wide pressure, and a per-flush O(clients)
        # buffer scan would itself be load at 1M clients
        self._down_full: set[str] = set()
        # end-to-end sync-age plane (utils/syncage.py): every STAMPED
        # sync batch from a game is aged HERE, at the per-client flush
        # — the instant a position update actually leaves toward a
        # client — into the sync_age_ms / sync_age_hop_ms{hop}
        # histograms, record-weighted. The paper's 16 ms target is the
        # default verdict line ([gateN] sync_age_target_ms overrides).
        self.syncage = syncage.register(
            f"gate{gate_id}",
            syncage.AgeTracker(sync_age_target_ms,
                               name=f"gate{gate_id}"))
        # correctness audit census probe (utils/audit.py):
        # the client map is the edge's ownership view — client count +
        # the CRC fold over BOUND player EntityIDs, so the aggregator
        # can spot a gate still mirroring an entity no game owns
        from goworld_tpu_torch.utils import audit as audit_mod
        import weakref as _weakref

        _wgate = _weakref.ref(self)

        def _gate_census(eids: bool = False) -> dict:
            g = _wgate()
            if g is None:
                return {"error": "gate discarded"}
            bound = [c.owner_eid for c in list(g.clients.values())
                     if c.owner_eid]
            out: dict = {
                "kind": "gate",
                "clients": len(g.clients),
                "bound_entities": len(bound),
                "crc": audit_mod.crc_fold(bound),
            }
            if eids:
                out["eids"] = (sorted(bound)
                               if len(bound) <= audit_mod.EIDS_CAP
                               else {"truncated": len(bound)})
            return out

        self._audit_probe = audit_mod.register(
            f"gate{gate_id}", audit_mod.CensusProbe(_gate_census))
        # gate-side incident flight recorder: one frame per flush-loop
        # window carrying the window's e2e p99 + per-hop breakdown;
        # a window whose p99 blows the target freezes a
        # ``sync_age_breach`` bundle at /incidents (per-kind cooldown,
        # like every game-side trigger). flightrec_ring=0 disables.
        self.flightrec: flightrec.FlightRecorder | None = None
        if flightrec_ring > 0:
            import weakref

            wself = weakref.ref(self)

            def _ctx() -> dict:
                s = wself()
                if s is None:
                    return {}
                # the full per-hop p50/p90/p99 table, frozen with the
                # bundle (paid at freeze time only)
                snap = s.syncage.snapshot()
                return {
                    "sync_age": {
                        "target_ms": snap["target_ms"],
                        "e2e": snap["e2e"],
                        "hops": snap["hops"],
                        "clock_warp_total": snap["clock_warp_total"],
                    },
                    "overload": s.overload.state_name,
                    "clients": len(s.clients),
                }

            self.flightrec = flightrec.register(
                f"gate{gate_id}",
                flightrec.FlightRecorder(
                    ring=flightrec_ring,
                    cooldown_secs=flightrec_cooldown_secs,
                    context_fn=_ctx,
                ),
            )
        self._flush_count = 0

    # ------------------------------------------------------------------
    async def _handshake(self, conn: DispatcherConn) -> None:
        p = proto.pack_set_gate_id(self.gate_id)
        conn.conn.send(p)
        await conn.conn.drain()

    async def serve(self) -> None:
        self.cluster.start()
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port,
            ssl=self.ssl_context,
        )
        tasks = [asyncio.ensure_future(self._flush_loop())]
        if self.heartbeat_timeout > 0:
            tasks.append(asyncio.ensure_future(self._heartbeat_loop()))
        if self.ws_port:
            tasks.append(asyncio.ensure_future(self._serve_ws()))
            await self.ws_started.wait()  # bind before declaring ready
        if self.kcp_port:
            from goworld_tpu_torch.net.kcp import start_kcp_server

            # KCP sessions reuse the SAME handler as TCP: the adapters
            # present (reader, writer) so ClientProxy/PacketConnection
            # run unchanged (no TLS over KCP — parity with kcp-go, whose
            # crypto is a kcp-layer option the reference leaves off).
            # kcp_port=-1 binds an ephemeral UDP port (tests).
            self._kcp_server = await start_kcp_server(
                self._handle_client, self.host,
                max(self.kcp_port, 0),
                idle_timeout=self.kcp_idle_timeout,
                # datagram-level fault injection (drop rules on the
                # gate->client edge exercise the KCP ARQ/retransmit
                # path; utils/faults.py)
                loss_hook=faults.kcp_loss_hook("gate->client"),
            )
        self.started.set()
        logger.info("gate%d listening on %s:%d", self.gate_id, self.host,
                    self.port)
        serve_task = asyncio.ensure_future(self._server.serve_forever())
        term_task = asyncio.ensure_future(self.terminated.wait())
        try:
            await asyncio.wait(
                [serve_task, term_task],
                return_when=asyncio.FIRST_COMPLETED,
            )
        finally:
            serve_task.cancel()
            term_task.cancel()
            for t in tasks:
                t.cancel()
            for cp in list(self.clients.values()):
                await cp.conn.close()
            self._server.close()
            if self._kcp_server is not None:
                self._kcp_server.close()
            self.cluster.stop()

    def _on_dispatcher_lost(self, didx: int) -> None:
        logger.error(
            "gate%d: dispatcher%d connection lost; terminating "
            "(reference gate.go:137-143 — a gate without its dispatchers "
            "is a black hole for clients)", self.gate_id, didx,
        )
        self.terminated.set()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    @property
    def bound_kcp_port(self) -> int:
        assert self._kcp_server is not None
        return self._kcp_server.bound_port

    # -- client side -----------------------------------------------------
    def _refuse_new_client(self) -> str | None:
        """Reason string when a new handshake must be refused: the
        connection cap binds in ANY state; the REJECTING rung refuses
        everyone (an overloaded gate that keeps admitting clients only
        digs deeper)."""
        if self.max_clients and len(self.clients) >= self.max_clients:
            return f"max_clients={self.max_clients} reached"
        if self.overload.state >= overload.REJECTING:
            return "overload state REJECTING"
        return None

    async def _handle_client(self, reader, writer) -> None:
        refuse = self._refuse_new_client()
        if refuse is not None:
            self._m_rejected.inc()
            if int(self._m_rejected.value) % 256 == 1:
                logger.warning(
                    "gate%d: refusing new client (%s; %d refused so "
                    "far)", self.gate_id, refuse,
                    int(self._m_rejected.value),
                )
            try:
                writer.close()
            except Exception:
                pass
            return
        conn = PacketConnection(reader, writer, compress=self.compress,
                                compress_codec=self.compress_codec,
                                edge="gate->client")
        cp = ClientProxy(conn)
        if self.rate_limit_pps > 0:
            cp.bucket = overload.TokenBucket(
                self.rate_limit_pps, burst=2 * self.rate_limit_pps)
        if self.rate_limit_bps > 0:
            cp.byte_bucket = overload.TokenBucket(
                self.rate_limit_bps, burst=2 * self.rate_limit_bps)
        cp.last_heartbeat = asyncio.get_event_loop().time()
        self.clients[cp.client_id] = cp
        # boot entity id is generated ON the gate
        # (reference GateService.go:209-214)
        boot_eid = ids.gen_entity_id()
        self.cluster.select_by_entity_id(boot_eid).send(
            proto.pack_notify_client_connected(
                boot_eid, cp.client_id, self.gate_id
            )
        )
        try:
            while True:
                msgtype, pkt = await conn.recv()
                # reference wraps gate packet handling in opmon
                # (GateService.go:435-442)
                t0 = time.perf_counter()
                with opmon.monitor.op("gate.handleClientPacket"):
                    self._handle_client_packet(cp, msgtype, pkt)
                self._m_handle_ms.observe(
                    (time.perf_counter() - t0) * 1e3)
        except (EOFError, ConnectionError, OSError):
            # EOFError (superset of IncompleteReadError) also covers a
            # malformed client packet underrunning its handler: kick
            # the client instead of killing the serve task
            pass
        finally:
            await conn.close()
            self._drop_client(cp)

    def _drop_client(self, cp: ClientProxy) -> None:
        if self.clients.pop(cp.client_id, None) is None:
            return
        self._down_full.discard(cp.client_id)
        self.filter_index.drop_client(cp)
        key = cp.owner_eid or cp.client_id
        self.cluster.select_by_entity_id(key).send(
            proto.pack_notify_client_disconnected(
                cp.client_id, cp.owner_eid
            )
        )

    def _handle_client_packet(self, cp: ClientProxy, msgtype: int,
                              pkt: Packet) -> None:
        """Trace ingress: the gate is where a client request enters the
        cluster, so the sampling decision is made HERE and only here —
        a context a client ships itself is untrusted and discarded
        (honoring it would let any client bypass the sampling rate and
        get trailer bytes echoed onto the client wire). Heartbeats are
        never sampled. The root span's context is installed as current,
        so the packets forwarded below carry it and the dispatcher's
        route span parents to ``gate_ingress``."""
        pkt.trace = None  # client-supplied contexts are not trusted
        # admission control FIRST: a rate-limited or shed packet must
        # cost neither a trace root nor handler work. Dropped packets
        # still count as liveness (the client is demonstrably alive —
        # reaping it for talking too MUCH would be perverse);
        # heartbeats are exempt from the rate limiter for the same
        # reason.
        cls = overload.classify(msgtype)
        if msgtype != proto.MT_HEARTBEAT and (
            (cp.bucket is not None and not cp.bucket.allow())
            or (cp.byte_bucket is not None
                and not cp.byte_bucket.allow(len(pkt.buf) + HEADER_SIZE))
        ):
            cp.last_heartbeat = asyncio.get_event_loop().time()
            overload.shed_counter(cls, "gate_ratelimit").inc()
            return
        if cls != overload.CLASS_NOISE and self.overload.should_shed(cls):
            cp.last_heartbeat = asyncio.get_event_loop().time()
            overload.shed_counter(cls, "gate_ingress").inc()
            return
        if msgtype not in (proto.MT_HEARTBEAT,
                           proto.MT_CLIENT_SYNC_POSITION_YAW):
            # heartbeats are noise; sync records are staged into a
            # batch and flushed OUTSIDE any handler context, so
            # sampling them would only mint orphan single-span traces
            # at 10 Hz per client — flooding the span ring
            root = tracing.maybe_sample()
            if root is not None:
                with tracing.root("gate_ingress", f"gate{self.gate_id}",
                                  root, msgtype=msgtype):
                    self._handle_client_packet_body(cp, msgtype, pkt)
                return
        self._handle_client_packet_body(cp, msgtype, pkt)

    def _handle_client_packet_body(self, cp: ClientProxy, msgtype: int,
                                   pkt: Packet) -> None:
        """Reference ``handleClientProxyPacket`` (``:236-256``): stamp the
        client id onto entity RPCs; batch sync records per dispatcher."""
        cp.last_heartbeat = asyncio.get_event_loop().time()
        if msgtype == proto.MT_HEARTBEAT:
            if self.overload.should_shed(overload.CLASS_NOISE):
                # liveness was recorded above; the REPLY is the
                # cheapest bytes on the wire and goes first
                overload.shed_counter(
                    overload.CLASS_NOISE, "gate_ingress").inc()
                return
            self._send_to_client(cp, new_packet(proto.MT_HEARTBEAT))
            return
        if msgtype == proto.MT_CLIENT_SYNC_POSITION_YAW:
            rec = pkt.read_bytes(proto.SYNC_RECORD_SIZE)
            eid = rec[:16].decode("ascii", "replace")
            didx = self.cluster.select_by_entity_id(eid).index
            self._sync_pending[didx].extend(rec)
            return
        if msgtype == proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT:
            eid = pkt.read_entity_id()
            method = pkt.read_var_str()
            args_raw = memoryview(pkt.buf)[pkt.rpos:]
            out = new_packet(proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
            out.append_entity_id(eid)
            out.append_entity_id(cp.client_id)
            out.append_var_str(method)
            out.append_bytes(bytes(args_raw))
            self.cluster.select_by_entity_id(eid).send(out)
            return
        logger.warning("gate%d: client sent unhandled msgtype %d",
                       self.gate_id, msgtype)

    # -- dispatcher side --------------------------------------------------
    def _on_dispatcher_packet(self, didx: int, msgtype: int,
                              pkt: Packet) -> None:
        ctx = pkt.trace
        if ctx is not None and ctx.sampled:
            # egress leaf: record the client-delivery span but do NOT
            # install a current context — the relayed client-bound
            # packets must stay unstamped (client wire unchanged)
            my = ctx.child()
            with tracing.recorder.span(
                    "gate_egress", f"gate{self.gate_id}", my,
                    ctx.span_hex, msgtype=msgtype):
                self._on_dispatcher_packet_body(didx, msgtype, pkt)
            return
        self._on_dispatcher_packet_body(didx, msgtype, pkt)

    def _on_dispatcher_packet_body(self, didx: int, msgtype: int,
                                   pkt: Packet) -> None:
        if proto.MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_START <= msgtype <= \
                proto.MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_STOP:
            pkt.read_u16()  # gate_id (ours)
            self._relay_to_client(msgtype, pkt)
            return
        if msgtype == proto.MT_CLIENT_EVENTS_BATCH:
            # one per-tick bundle from a game: unbundle and relay each
            # record exactly like the per-message redirect path above
            # (same bytes on the client wire, in the same order)
            pkt.read_u16()  # gate_id (ours)
            n = pkt.read_u32()
            self._m_down_batch.observe(n)
            for _ in range(n):
                mt = pkt.read_u16()
                ln = pkt.read_u32()
                # read_bytes underrun-checks a corrupt length field
                rec = Packet(pkt.read_bytes(ln))
                self._relay_to_client(mt, rec)
            return
        if msgtype == proto.MT_SYNC_POSITION_YAW_ON_CLIENTS:
            pkt.read_u16()  # gate_id routing prefix (ours)
            self._handle_sync_on_clients(pkt, age=pkt.age)
            return
        if msgtype == proto.MT_SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
            # delta-compressed sync leg: reconstruct full
            # records bit-deterministically from the in-band keyframed
            # baselines, then relay exactly like the full-record path.
            # Decoder state is PER SENDING GAME — each game assigns
            # handles from its own counter, so one shared table would
            # collide (and one game's reset would wipe the others)
            pkt.read_u16()
            sender = pkt.read_u16()
            dec = self._sync_delta_dec.get(sender)
            if dec is None:
                dec = self._sync_delta_dec[sender] = \
                    codec.DeltaSyncDecoder()
            try:
                cids, eids, vals = dec.decode_batch(
                    memoryview(pkt.buf)[pkt.rpos:])
            except ConnectionError as exc:
                logger.warning("gate%d: bad delta-sync batch from "
                               "game%d: %s", self.gate_id, sender, exc)
                return
            self._relay_sync_records(cids, eids, vals, age=pkt.age)
            return
        if msgtype == proto.MT_SET_CLIENT_FILTER_PROP:
            pkt.read_u16()
            client_id = pkt.read_entity_id()
            cp = self.clients.get(client_id)
            if cp is not None:
                self.filter_index.set_prop(
                    cp, pkt.read_var_str(), pkt.read_var_str()
                )
            return
        if msgtype == proto.MT_CALL_FILTERED_CLIENTS:
            op = pkt.read_u8()
            key = pkt.read_var_str()
            val = pkt.read_var_str()
            eid = pkt.read_var_str()
            method = pkt.read_var_str()
            args_raw = bytes(memoryview(pkt.buf)[pkt.rpos:])
            targets = self.filter_index.query(key, op, val)
            for cp in targets:
                out = new_packet(proto.MT_CALL_ENTITY_METHOD_ON_CLIENT)
                out.append_entity_id(
                    eid if len(eid) == ids.ENTITYID_LENGTH
                    else cp.owner_eid or cp.client_id
                )
                out.append_var_str(method)
                out.append_bytes(args_raw)
                self._send_to_client(cp, out)
            return
        logger.warning("gate%d: dispatcher sent unhandled msgtype %d",
                       self.gate_id, msgtype)

    def _send_to_client(self, cp: ClientProxy, p: Packet) -> bool:
        """Downstream send with a per-client byte bound: a consumer
        whose socket buffer is full gets SELF-HEALING packets (sync
        records — the next tick re-sends current state) dropped,
        counted in ``gate_downstream_dropped_total``, instead of
        growing process memory without limit; it is disconnected once
        the buffer stays full past ``downstream_kick_secs``, or
        IMMEDIATELY when a correctness-critical message (create/
        destroy/RPC — nothing ever re-sends those) would have to drop,
        because a silently desynced world view is worse than a
        reconnect — kick, never wedge (a 1M-user gate cannot carry
        dead weight). Returns True iff the packet was actually handed
        to the socket — the sync-age plane must weight by DELIVERED
        records, and a dropped-under-overload batch is precisely the
        case the breach trigger exists for."""
        if self.downstream_max_bytes <= 0:
            cp.send(p)
            return True
        buffered = cp.downstream_buffered()
        if buffered + len(p.buf) <= self.downstream_max_bytes:
            if cp.down_full_since is not None:
                cp.down_full_since = None
                self._down_full.discard(cp.client_id)
            cp.send(p)
            return True
        self._m_down_dropped.inc()
        now = asyncio.get_event_loop().time()
        mt = (int.from_bytes(bytes(p.buf[:2]), "little") & MSGTYPE_MASK
              if len(p.buf) >= 2 else 0)
        p.release()
        if overload.classify(mt) < overload.CLASS_SYNC:
            self._kick_stalled(cp, buffered,
                               f"cannot take msgtype {mt}")
            return False
        if cp.down_full_since is None:
            cp.down_full_since = now
            self._down_full.add(cp.client_id)
            logger.warning(
                "gate%d: client %s downstream buffer full (%d B); "
                "dropping (kick in %.0fs unless it drains)",
                self.gate_id, cp.client_id, buffered,
                self.downstream_kick_secs,
            )
        elif now - cp.down_full_since >= self.downstream_kick_secs:
            self._kick_stalled(
                cp, buffered,
                f"full for {now - cp.down_full_since:.1f}s")
        return False

    def _kick_stalled(self, cp: ClientProxy, buffered: int,
                      why: str) -> None:
        self._m_kicked.inc()
        logger.warning(
            "gate%d: kicking client %s — downstream buffer stalled at "
            "%d B (%s)", self.gate_id, cp.client_id, buffered, why,
        )
        asyncio.ensure_future(cp.conn.close())
        self._drop_client(cp)

    def _relay_to_client(self, msgtype: int, pkt: Packet) -> None:
        """Relay one redirect-range message to its client proxy; ``pkt``
        is positioned at the 16-byte client id (reference
        ``GateService.go:258-306``)."""
        client_id = pkt.read_entity_id()
        cp = self.clients.get(client_id)
        if cp is None:
            return
        if msgtype == proto.MT_CREATE_ENTITY_ON_CLIENT:
            # peek is_player to learn the owner entity
            # (reference GateService.go:266-297)
            save = pkt.rpos
            eid = pkt.read_entity_id()
            pkt.read_var_str()
            if pkt.read_bool():
                cp.owner_eid = eid
            pkt.rpos = save
        out = new_packet(msgtype)
        out.append_bytes(bytes(memoryview(pkt.buf)[pkt.rpos:]))
        self._send_to_client(cp, out)

    def _handle_sync_on_clients(self, pkt: Packet, age=None) -> None:
        """Regroup 48B (cid+eid+pos) records per client and send each its
        own 32B-record bundle (reference ``:350-375``). Grouping is a
        vectorized unique+argsort over the 16B client ids — Python work
        scales with CLIENTS, not records."""
        buf = memoryview(pkt.buf)[pkt.rpos:]
        cids, eids, vals = codec.decode_client_sync_batch(buf)
        self._relay_sync_records(cids, eids, vals, age=age)

    def _relay_sync_records(self, cids, eids, vals, age=None) -> None:
        """The shared back half of both sync legs (full-record and
        delta-decoded): per-client regroup + relay. ``age`` is the
        batch's sync-age stamp (or None): delivered records are aged
        ONCE per batch at the flush instant, weighted by how many
        records actually left toward clients."""
        n = len(cids)
        self._m_down_batch.observe(n)
        if n == 0:
            return
        keys = np.ascontiguousarray(cids).view("V16").ravel()
        uniq, inv = np.unique(keys, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.cumsum(np.bincount(inv, minlength=len(uniq)))
        start = 0
        delivered = 0
        for u, stop in zip(uniq, bounds):
            idxs = order[start:start + (stop - start)]
            start = stop
            cp = self.clients.get(bytes(u).decode("ascii", "replace"))
            if cp is None:
                continue
            out = new_packet(proto.MT_CLIENT_SYNC_POSITION_YAW)
            out.append_bytes(
                codec.encode_sync_batch(eids[idxs], vals[idxs])
            )
            # only records the socket actually took count as delivered
            # (a full-buffer drop under overload must not pollute the
            # age-at-delivery SLO it exists to trip)
            if self._send_to_client(cp, out):
                delivered += len(idxs)
        if age is not None and delivered:
            # age-at-delivery: the whole point of the stamp — measured
            # HERE, after the last per-client send of the batch
            self.syncage.observe(age, syncage.now_us(), delivered)

    # -- periodic work ----------------------------------------------------
    async def _flush_loop(self) -> None:
        """Flush pending upstream sync batches every sync interval
        (reference ``tryFlushPendingSyncPackets`` ``:402-429``); the
        same cadence drives the gate's overload governor."""
        while True:
            await asyncio.sleep(self.sync_interval)
            for didx, buf in self._sync_pending.items():
                if not buf:
                    continue
                p = new_packet(proto.MT_SYNC_POSITION_YAW_FROM_CLIENT)
                p.append_bytes(bytes(buf))
                self.cluster.conns[didx].send(p)
                buf.clear()
            self._observe_overload()
            self._flightrec_window()

    def _flightrec_window(self) -> None:
        """One flight-recorder frame per flush window: the window's
        sync-age e2e p99 vs target plus the freshest per-hop lanes —
        a window over target fires the ``sync_age_breach`` trigger
        (utils/flightrec.py) with the breakdown frozen in the bundle."""
        if self.flightrec is None:
            return
        self._flush_count += 1
        try:
            p99, n = self.syncage.window_verdict()
            frame: dict = {
                "tick": self._flush_count,
                "stage": self.overload.state_name,
                "clients": len(self.clients),
            }
            if p99 is not None:
                # non-finite stringifies as "inf" (the syncage.ptiles
                # convention): a raw float('inf') would serialize as
                # the non-standard JSON token Infinity at /incidents
                frame["sync_age_p99_ms"] = round(p99, 3) \
                    if p99 != float("inf") else "inf"
                frame["sync_age_target_ms"] = self.syncage.target_ms
                frame["sync_age_samples"] = n
                if self.syncage.last_lanes_ms:
                    frame["sync_age_hops"] = {
                        h: round(v, 3) for h, v in
                        self.syncage.last_lanes_ms.items()}
            self.flightrec.record(frame)
        except Exception:  # observability must never kill the flush
            logger.exception("gate%d: flight-recorder window failed",
                             self.gate_id)

    def _observe_overload(self) -> None:
        """Feed the gate governor: the FRACTION of clients whose
        downstream buffer is refusing sends (maintained incrementally
        by ``_send_to_client`` — O(1) here, and one stalled phone
        among thousands of healthy clients reads as ~0 pressure, not
        gate-wide overload) and the reconnect-pend fraction (a gate
        has no tick, so latency/backlog stay 0)."""
        down_frac = (
            len(self._down_full) / len(self.clients)
            if self.clients else 0.0
        )
        pend_frac = 0.0
        for c in self.cluster.conns:
            if c.pend_max_bytes > 0:
                pend_frac = max(
                    pend_frac, c._pending_bytes / c.pend_max_bytes
                )
        self.overload.observe(0.0, 0.0, down_frac, pend_frac)

    async def _heartbeat_loop(self) -> None:
        """Kick clients that stopped heartbeating (reference ``:197-207``)."""
        while True:
            await asyncio.sleep(self.heartbeat_timeout / 2)
            now = asyncio.get_event_loop().time()
            for cp in list(self.clients.values()):
                if now - cp.last_heartbeat > self.heartbeat_timeout:
                    logger.info("gate%d: client %s heartbeat timeout",
                                self.gate_id, cp.client_id)
                    await cp.conn.close()
                    self._drop_client(cp)

    # -- websocket listener ----------------------------------------------
    async def _serve_ws(self) -> None:
        """WebSocket edge (reference ``handleWebSocketConn`` ``:121-168``):
        each binary WS message is one framed packet, over the port's
        stdlib websocket module (:mod:`goworld_tpu_torch.net.ws`).
        ``ws_started`` is set whatever the bind does, so ``serve()``
        never waits on it forever; a failed bind is logged."""

        async def handle(ws):
            loop = asyncio.get_event_loop()
            if self._refuse_new_client() is not None:
                self._m_rejected.inc()
                await ws.close()
                return
            # adapt the websocket into the PacketConnection interface via
            # an in-memory stream pair
            reader = asyncio.StreamReader()

            class _WSWriter:
                def write(self, data: bytes) -> None:
                    # strip our framing: WS messages are already framed
                    asyncio.ensure_future(ws.send(bytes(data)))

                async def drain(self) -> None: ...
                def close(self) -> None:
                    asyncio.ensure_future(ws.close())

                async def wait_closed(self) -> None: ...
                def get_extra_info(self, _): return None

            conn = PacketConnection(reader, _WSWriter())  # type: ignore
            cp = ClientProxy(conn)
            if self.rate_limit_pps > 0:
                cp.bucket = overload.TokenBucket(
                    self.rate_limit_pps, burst=2 * self.rate_limit_pps)
            if self.rate_limit_bps > 0:
                cp.byte_bucket = overload.TokenBucket(
                    self.rate_limit_bps, burst=2 * self.rate_limit_bps)
            cp.last_heartbeat = loop.time()
            self.clients[cp.client_id] = cp
            boot_eid = ids.gen_entity_id()
            self.cluster.select_by_entity_id(boot_eid).send(
                proto.pack_notify_client_connected(
                    boot_eid, cp.client_id, self.gate_id
                )
            )
            try:
                async for msg in ws:
                    if not isinstance(msg, (bytes, bytearray)):
                        continue
                    # strip size prefix; decode_wire also strips any
                    # trace trailer like the TCP recv path
                    mt, p = decode_wire(msg[HEADER_SIZE:])
                    self._handle_client_packet(cp, mt, p)
            except Exception:
                pass
            finally:
                self._drop_client(cp)

        try:
            self._ws_server = await ws_mod.serve(
                handle, self.host, self.ws_port
            )
        except Exception:
            logger.exception(
                "gate%d: websocket listener on port %d failed; "
                "continuing without ws", self.gate_id, self.ws_port,
            )
            return
        finally:
            # serve() awaits this before declaring ready; never leave it
            # hanging on a bind failure
            self.ws_started.set()
        await asyncio.Future()  # run until cancelled
