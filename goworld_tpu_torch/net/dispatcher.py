"""Dispatcher — the cluster's message router (one process per shard).

Reference being rebuilt: ``components/dispatcher/DispatcherService.go``:
owns the EntityID->game table, blocks + queues packets for entities that are
migrating/loading, load-balanced entity placement (min-load choose,
round-robin boot entities), the deployment-readiness barrier, kvreg
first-writer-wins registry, freeze orchestration, and disconnect cleanup.

N dispatchers form a sharded star (``engine/dispatchercluster``): every game
and gate connects to all of them; senders pick the dispatcher by EntityID
hash (:func:`goworld_tpu_torch.net.cluster.entity_shard`), so each dispatcher's
entity table only covers its hash shard.

Asyncio single-task message loop = the reference's single-goroutine
dispatcher loop (``DispatcherService.go:205-278``).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

import numpy as np

from goworld_tpu_torch.net import proto
from goworld_tpu_torch.net.packet import (
    MSGTYPE_MASK,
    Packet,
    PacketConnection,
    new_packet,
    wire_payload,
)
from goworld_tpu_torch.utils import consts, ids, log, metrics, overload, \
    tracing

logger = log.get("dispatcher")

# one 32-byte upstream sync record: 16-char eid + x/y/z/yaw f32 payload,
# kept opaque ("V16") — the dispatcher routes, it never interprets
_SYNC_REC_DTYPE = np.dtype([("eid", "S16"), ("v", "V16")])


# bumped on ANY change to entity routing (eid->game assignment or table
# membership, in any dispatcher instance): the vectorized upstream-sync
# route index (see _h_sync_upstream) caches against it. Module-global so
# _EntityDispatchInfo's setter can bump it without a dispatcher backref;
# a bump in one instance merely costs the others one lazy rebuild.
_route_version = 0


def _bump_route_version() -> None:
    global _route_version
    _route_version += 1


class _EntityDispatchInfo:
    """Per-entity routing record (reference ``entityDispatchInfo``,
    ``DispatcherService.go:28-77``)."""

    __slots__ = ("_game_id", "block_until", "pending")

    def __init__(self):
        self._game_id = 0
        self.block_until = 0.0
        self.pending: deque[Packet] = deque()

    @property
    def game_id(self) -> int:
        return self._game_id

    @game_id.setter
    def game_id(self, v: int) -> None:
        self._game_id = v
        _bump_route_version()

    @property
    def blocked(self) -> bool:
        return time.monotonic() < self.block_until

    def block(self, duration: float) -> None:
        self.block_until = time.monotonic() + duration

    def unblock(self) -> None:
        self.block_until = 0.0


class _GameInfo:
    """Per-game connection state (reference ``gameDispatchInfo``).

    The queue-while-blocked/disconnected buffer is CLASS-PRIORITIZED
    (utils/overload.py): one deque per traffic class, flushed
    highest-priority first, and bounded by a packet AND byte budget
    whose overflow evicts the *cheapest* queued class first — a
    position-sync flood during a game's freeze window can therefore
    never push out a migration leg or an RPC, and eviction is counted
    per class in ``shed_total{class,stage="dispatcher_pend"}``."""

    __slots__ = ("game_id", "conn", "blocked_until", "pending", "load",
                 "ban_boot", "pending_count", "pending_bytes",
                 "rebalance_paused")

    def __init__(self, game_id: int):
        self.game_id = game_id
        self.conn: PacketConnection | None = None
        self.blocked_until = 0.0
        self.pending: tuple[deque[bytes], ...] = tuple(
            deque() for _ in range(overload.N_CLASSES)
        )
        self.pending_count = 0
        self.pending_bytes = 0
        self.load = 0.0   # CPU% analog reported via MT_GAME_LBC_INFO
        self.ban_boot = False
        # a donor game mid-handoff pauses its own NEW-entity admission
        # deployment-wide via the kvreg key rebalance/pause/gameN
        # (goworld_tpu/rebalance/); _choose_game skips it while set
        self.rebalance_paused = False

    @property
    def blocked(self) -> bool:
        return time.monotonic() < self.blocked_until

    def send(self, p: Packet, release: bool = True) -> None:
        if self.conn is not None and not self.blocked:
            self.conn.send(p, release=release)
        else:
            # wire_payload keeps a trace trailer through the queue
            # (identical to bytes(p.buf) when untraced); the flush
            # sends the stored bytes verbatim and the receiver's
            # decode_wire strips the trailer as usual
            raw = wire_payload(p)
            cls = overload.classify(
                (raw[0] | (raw[1] << 8)) & MSGTYPE_MASK
                if len(raw) >= 2 else 0
            )
            self.pending[cls].append(raw)
            self.pending_count += 1
            self.pending_bytes += len(raw)
            self._evict_over_budget()
            if release:
                p.release()

    def _evict_over_budget(self) -> None:
        """Drop-oldest from the cheapest non-empty class until both
        budgets hold; each eviction counted per class."""
        while (self.pending_count > consts.MAX_PENDING_PACKETS_PER_GAME
               or self.pending_bytes > consts.MAX_PENDING_BYTES_PER_GAME):
            for cls in range(overload.N_CLASSES - 1, -1, -1):
                q = self.pending[cls]
                if q:
                    self.pending_bytes -= len(q.popleft())
                    self.pending_count -= 1
                    overload.shed_counter(cls, "dispatcher_pend").inc()
                    break
            else:
                return  # all empty (budgets misconfigured tiny)

    def flush_pending(self) -> None:
        for q in self.pending:
            while q and self.conn is not None:
                raw = q.popleft()
                self.pending_count -= 1
                self.pending_bytes -= len(raw)
                self.conn.send(Packet(raw), release=False)


class DispatcherService:
    """One dispatcher shard. ``serve()`` runs until cancelled."""

    def __init__(self, dispatcher_id: int, host: str, port: int,
                 desired_games: int, desired_gates: int):
        self.id = dispatcher_id
        self.host = host
        self.port = port
        self.desired_games = desired_games
        self.desired_gates = desired_gates

        self.games: dict[int, _GameInfo] = {}
        self.gates: dict[int, PacketConnection] = {}
        self.entities: dict[str, _EntityDispatchInfo] = {}
        self.kvreg: dict[str, str] = {}
        self.deployment_ready = False
        self._boot_rr = 0
        self._server: asyncio.AbstractServer | None = None
        # per-game re-batched upstream sync records, flushed on a short
        # timer like the reference's 5ms tick (DispatcherService.go:797-808)
        self._sync_pending: dict[int, bytearray] = {}
        # vectorized upstream-sync routing: (version, sorted S16 eids,
        # aligned i32 game_ids), rebuilt lazily when _route_version moves
        self._route_cache: tuple | None = None
        # eid(bytes) -> block_until deadline, maintained at the block/
        # unblock sites so the vectorized path can drop blocked records
        # (the reference's per-record `blocked` skip, :770-795) without
        # touching per-entity Python
        self._blocked_until: dict[bytes, float] = {}
        self.open_conns: set[PacketConnection] = set()
        # boot requests that arrived while NO game was live (mid-crash /
        # mid-restart window): a silently dropped boot leaves the client
        # hanging forever, so queue bounded (with a TTL — a client that
        # gave up and disconnected during a long outage must not mint an
        # orphan entity when a game finally returns) and flush on the
        # next game handshake (chaos finding: a client connecting in the
        # ~200 ms between game death and supervised restart never got a
        # world). Entries carry the client id so a disconnect CANCELS
        # the parked boot (a client that gave up must not mint an
        # orphan entity when a game returns seconds later).
        self._boot_pending: deque[tuple[float, str, Packet]] = deque()
        self._m_boot_queued = metrics.counter(
            "dispatcher_boot_queued_total",
            help="boot requests queued while no game was live")
        self.started = asyncio.Event()
        # per-msgtype route counters (debug_http /metrics): children of
        # one ``dispatcher_route_total`` family, cached by msgtype so
        # the hot path is one dict hit + one locked increment
        self._route_counters: dict[int, metrics.Counter] = {}

        # correctness audit census (utils/audit.py): the
        # routing table is the deployment's independent view of entity
        # ownership — served at /audit as per-game counts + CRC census
        # digests so the aggregator can cross-check every game's own
        # ledger without either side shipping an eid list. Weakref'd
        # like every plane registration: the registry must not pin a
        # discarded service.
        import weakref

        from goworld_tpu_torch.utils import audit as audit_mod

        wself = weakref.ref(self)

        def _census(eids: bool = False) -> dict:
            s = wself()
            if s is None:
                return {"error": "dispatcher discarded"}
            # snapshot the items first: the scrape runs on the http
            # thread while the event loop mutates the table
            routes = list(s.entities.items())
            by_game: dict[int, list[str]] = {}
            for eid, info in routes:
                by_game.setdefault(int(info.game_id), []).append(eid)
            out: dict = {
                "kind": "dispatcher",
                "entities": len(routes),
                "games": {
                    gid: {"count": len(v), "crc": audit_mod.crc_fold(v)}
                    for gid, v in sorted(by_game.items())
                },
            }
            if eids:
                out["eids"] = {
                    gid: (sorted(v) if len(v) <= audit_mod.EIDS_CAP
                          else {"truncated": len(v)})
                    for gid, v in sorted(by_game.items())
                }
            return out

        self._audit_probe = audit_mod.register(
            f"dispatcher{dispatcher_id}", audit_mod.CensusProbe(_census))

    # ------------------------------------------------------------------
    async def serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.started.set()
        logger.info("dispatcher%d listening on %s:%d",
                    self.id, self.host, self.port)
        flusher = asyncio.ensure_future(self._flush_loop())
        try:
            async with self._server:
                await self._server.serve_forever()
        finally:
            flusher.cancel()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(consts.HOST_TICK_INTERVAL)
            self._flush_sync_pending()

    def _flush_sync_pending(self) -> None:
        for game_id, buf in self._sync_pending.items():
            if not buf:
                continue
            gi = self.games.get(game_id)
            if gi is None:
                buf.clear()
                continue
            p = new_packet(proto.MT_SYNC_POSITION_YAW_FROM_CLIENT)
            p.append_bytes(bytes(buf))
            gi.send(p)
            buf.clear()

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader, writer) -> None:
        conn = PacketConnection(reader, writer)
        self.open_conns.add(conn)
        role: tuple[str, int] | None = None  # ("game"|"gate", id)
        try:
            while True:
                msgtype, pkt = await conn.recv()
                role = self._handle_packet(conn, role, msgtype, pkt)
                await conn.drain()
        except (EOFError, ConnectionError, OSError):
            # EOFError (superset of IncompleteReadError) also covers a
            # truncated/corrupt packet underrunning its handler: drop
            # the connection (the peer reconnects + re-handshakes)
            # instead of killing the serve task
            pass
        finally:
            self.open_conns.discard(conn)
            await conn.close()
            if role is not None:
                self._on_disconnect(role)

    async def kill(self) -> None:
        """Hard-stop: close the listener and sever every live connection
        (crash simulation for failure-path tests; also the tail of a
        graceful shutdown)."""
        if self._server is not None:
            self._server.close()
        for conn in list(self.open_conns):
            await conn.close()

    # ------------------------------------------------------------------
    def _handle_packet(self, conn, role, msgtype: int, pkt: Packet):
        ctx = pkt.trace
        if ctx is not None and ctx.sampled:
            # one route span per traced packet; the forwarded packet is
            # re-stamped with OUR span so the next hop parents to it,
            # and acks built inside (new_packet under the installed
            # context) carry it back to the caller automatically
            with tracing.hop("route", f"dispatcher{self.id}", ctx,
                             msgtype=msgtype) as my:
                pkt.trace = my
                return self._route_packet(conn, role, msgtype, pkt)
        return self._route_packet(conn, role, msgtype, pkt)

    def _route_packet(self, conn, role, msgtype: int, pkt: Packet):
        c = self._route_counters.get(msgtype)
        if c is None:
            c = self._route_counters[msgtype] = metrics.counter(
                "dispatcher_route_total",
                help="packets routed, by wire msgtype",
                msgtype=str(msgtype),
            )
        c.inc()
        if msgtype == proto.MT_SET_GAME_ID:
            return self._handle_set_game_id(conn, pkt)
        if msgtype == proto.MT_SET_GATE_ID:
            gate_id = pkt.read_u16()
            self.gates[gate_id] = conn
            conn.edge = "dispatcher->gate"  # fault-injection label
            logger.info("dispatcher%d: gate%d connected", self.id, gate_id)
            self._check_deployment_ready()
            return ("gate", gate_id)

        if proto.MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_START <= msgtype <= \
                proto.MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_STOP:
            # forward to the gate named in the routing prefix, verbatim
            gate_id = pkt.read_u16()
            g = self.gates.get(gate_id)
            if g is not None:
                g.send(pkt, release=False)
            return role

        handler = {
            proto.MT_CALL_ENTITY_METHOD: self._h_call_entity,
            proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT: self._h_call_entity,
            proto.MT_NOTIFY_CREATE_ENTITY: self._h_create_entity,
            proto.MT_NOTIFY_DESTROY_ENTITY: self._h_destroy_entity,
            proto.MT_CREATE_ENTITY_ANYWHERE: self._h_create_anywhere,
            proto.MT_LOAD_ENTITY_ANYWHERE: self._h_load_anywhere,
            proto.MT_NOTIFY_CLIENT_CONNECTED: self._h_client_connected,
            proto.MT_NOTIFY_CLIENT_DISCONNECTED: self._h_client_disconnected,
            proto.MT_SYNC_POSITION_YAW_FROM_CLIENT: self._h_sync_upstream,
            proto.MT_SYNC_POSITION_YAW_ON_CLIENTS: self._h_sync_downstream,
            # delta-compressed variant: same gate-routing
            # leg, opaque payload — the gate's decoder owns the format
            proto.MT_SYNC_POSITION_YAW_DELTA_ON_CLIENTS:
                self._h_sync_downstream,
            # per-tick client event bundle: forward to its gate whole
            # (the gate unbundles) — same leg as the sync batch
            proto.MT_CLIENT_EVENTS_BATCH: self._h_to_gate,
            proto.MT_SET_CLIENT_FILTER_PROP: self._h_to_gate,
            proto.MT_CALL_FILTERED_CLIENTS: self._h_filtered_broadcast,
            proto.MT_KVREG_REGISTER: self._h_kvreg,
            proto.MT_GAME_LBC_INFO: self._h_lbc,
            proto.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE: self._h_query_space,
            proto.MT_MIGRATE_REQUEST: self._h_migrate_request,
            proto.MT_REAL_MIGRATE: self._h_real_migrate,
            proto.MT_CANCEL_MIGRATE: self._h_cancel_migrate,
            proto.MT_CALL_NIL_SPACES: self._h_broadcast_games,
            proto.MT_START_FREEZE_GAME: self._h_start_freeze,
            # replication leg: both messages lead with the TARGET game
            # id — forward verbatim, body stays opaque
            proto.MT_REPLICATION_SUBSCRIBE: self._h_to_game,
            proto.MT_REPLICATION_FRAME: self._h_to_game,
        }.get(msgtype)
        if handler is None:
            logger.warning("dispatcher%d: unhandled msgtype %d",
                           self.id, msgtype)
            return role
        handler(conn, role, msgtype, pkt)
        return role

    # -- handshake ------------------------------------------------------
    def _handle_set_game_id(self, conn, pkt: Packet):
        game_id = pkt.read_u16()
        is_reconnect = pkt.read_bool()
        is_restore = pkt.read_bool()
        ban_boot = pkt.read_bool()
        census = pkt.read_data()  # entity ids this game already hosts
        gi = self.games.get(game_id)
        if gi is None:
            gi = self.games[game_id] = _GameInfo(game_id)
        gi.conn = conn
        conn.edge = "dispatcher->game"  # fault-injection label
        gi.ban_boot = ban_boot
        gi.blocked_until = 0.0

        # census reconciliation (reference DispatcherService.go:369-391):
        # entities the game claims but we route elsewhere get rejected
        rejects = []
        for eid in census:
            info = self.entities.get(eid)
            if info is None:
                info = self.entities[eid] = _EntityDispatchInfo()
                info.game_id = game_id
            elif info.game_id != game_id:
                rejects.append(eid)
        ack = new_packet(proto.MT_SET_GAME_ID_ACK)
        ack.append_u16(self.id)
        ack.append_data(self.kvreg)
        ack.append_data(rejects)
        # seed the joiner's online-games view (reference GetOnlineGames,
        # goworld.go:226; games that joined earlier never re-broadcast)
        ack.append_data(sorted(
            g.game_id for g in self.games.values() if g.conn is not None
        ))
        conn.send(ack)
        gi.flush_pending()
        self._flush_boot_pending()
        logger.info(
            "dispatcher%d: game%d connected (reconnect=%s restore=%s, "
            "%d entities)", self.id, game_id, is_reconnect, is_restore,
            len(census),
        )
        self._broadcast_to_games(
            self._mk_game_connected(game_id), exclude=game_id
        )
        if self.deployment_ready:
            # late joiner (reconnect, or a multihost follower controller
            # connecting after the threshold): it missed the broadcast
            # and would never learn the cluster is live
            conn.send(new_packet(proto.MT_NOTIFY_DEPLOYMENT_READY))
        self._check_deployment_ready()
        return ("game", game_id)

    @staticmethod
    def _mk_game_connected(game_id: int) -> Packet:
        p = new_packet(proto.MT_NOTIFY_GAME_CONNECTED)
        p.append_u16(game_id)
        return p

    def _check_deployment_ready(self) -> None:
        """Reference ``checkDeploymentReady`` (``:439-469``): when desired
        process counts are met, tell everyone."""
        if self.deployment_ready:
            return
        # multihost FOLLOWER controllers (ids >= MH_FOLLOWER_GAME_ID_BASE)
        # are extra connections of an already-counted logical game — they
        # must not inflate the readiness count past desired_games
        live_games = sum(
            1 for g in self.games.values()
            if g.conn is not None
            and g.game_id < consts.MH_FOLLOWER_GAME_ID_BASE
        )
        if live_games >= self.desired_games and \
                len(self.gates) >= self.desired_gates:
            self.deployment_ready = True
            p = new_packet(proto.MT_NOTIFY_DEPLOYMENT_READY)
            self._broadcast_to_games(p)
            logger.info("dispatcher%d: deployment ready", self.id)

    def _broadcast_to_games(self, p: Packet, exclude: int = 0) -> None:
        for gid, gi in self.games.items():
            if gid != exclude:
                gi.send(Packet(bytes(p.buf)), release=False)
        p.release()

    # -- entity table ---------------------------------------------------
    def _entity_info(self, eid: str) -> _EntityDispatchInfo:
        info = self.entities.get(eid)
        if info is None:
            info = self.entities[eid] = _EntityDispatchInfo()
        return info

    def _dispatch_to_entity(self, eid: str, pkt: Packet) -> None:
        """Queue-while-blocked routing (reference ``dispatchPacket``)."""
        info = self.entities.get(eid)
        if info is None or info.game_id == 0:
            logger.warning(
                "dispatcher%d: no route for entity %s; dropped",
                self.id, eid,
            )
            return
        if info.blocked:
            if len(info.pending) < consts.MAX_PENDING_PACKETS_PER_ENTITY:
                q = Packet(bytes(pkt.buf))
                # carry the trace across the migration-block queue: the
                # queueing delay is exactly the hop a p99 investigation
                # needs attributed, and the post-unblock forward must
                # still reach the game traced
                q.trace = pkt.trace
                info.pending.append(q)
            return
        gi = self.games.get(info.game_id)
        if gi is not None:
            gi.send(pkt, release=False)

    def _unblock_entity(self, eid: str) -> None:
        self._blocked_until.pop(eid.encode("ascii"), None)
        info = self.entities.get(eid)
        if info is None:
            return
        info.unblock()
        gi = self.games.get(info.game_id)
        while info.pending:
            q = info.pending.popleft()
            if gi is not None:
                gi.send(q, release=False)

    # -- handlers -------------------------------------------------------
    def _h_call_entity(self, conn, role, msgtype, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        pkt.rpos = 2  # rewind past msgtype: forward the original packet
        self._dispatch_to_entity(eid, pkt)

    def _h_create_entity(self, conn, role, msgtype, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        game_id = pkt.read_u16()
        info = self._entity_info(eid)
        info.game_id = game_id

    def _h_destroy_entity(self, conn, role, msgtype, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        if self.entities.pop(eid, None) is not None:
            _bump_route_version()

    def _choose_game(self, boot: bool = False) -> _GameInfo | None:
        """Load-balanced placement (reference ``chooseGame`` min-CPU heap
        ``:523-536``; boot entities round-robin over non-banned games
        ``:539-549``)."""
        live = [
            g for g in self.games.values()
            if g.conn is not None and not (boot and g.ban_boot)
        ]
        # a donor mid-handoff stops taking NEW entities (rebalance
        # admission pause) — unless every live game is paused, in
        # which case placement beats refusal
        unpaused = [g for g in live if not g.rebalance_paused]
        if unpaused:
            live = unpaused
        if not live:
            return None
        if boot:
            live.sort(key=lambda g: g.game_id)
            self._boot_rr = (self._boot_rr + 1) % len(live)
            return live[self._boot_rr]
        chosen = min(live, key=lambda g: g.load)
        chosen.load += 0.1  # reference lbcheap.go:71-77 chosen() penalty
        return chosen

    def _h_create_anywhere(self, conn, role, msgtype, pkt: Packet) -> None:
        want = pkt.read_u16()          # 0 = min-load choice
        gi = self.games.get(want) if want else self._choose_game()
        if gi is None:
            logger.error(
                "dispatcher%d: no game (want=%d) for CreateEntityAnywhere",
                self.id, want,
            )
            return
        # a known-but-reconnecting pinned target queues (gi.send pends
        # while conn is None, flushed on reconnect) — same survival the
        # min-load path gets
        pkt.rpos = 2
        gi.send(pkt, release=False)

    def _h_load_anywhere(self, conn, role, msgtype, pkt: Packet) -> None:
        want = pkt.read_u16()          # 0 = min-load choice
        pkt.read_var_str()  # type_name
        eid = pkt.read_entity_id()
        info = self._entity_info(eid)
        if info.game_id != 0 or info.blocked:
            return  # already loaded/loading: single-load guard (:673-702)
        gi = self.games.get(want) if want else self._choose_game()
        if gi is None:
            logger.error(
                "dispatcher%d: no game (want=%d) for LoadEntityAnywhere",
                self.id, want,
            )
            return
        info.game_id = gi.game_id
        info.block(consts.LOAD_TIMEOUT)
        self._blocked_until[eid.encode("ascii")] = info.block_until
        pkt.rpos = 2
        gi.send(pkt, release=False)

    BOOT_PENDING_MAX = 1024
    BOOT_PENDING_TTL = 30.0  # s; past this the client has long given up

    def _h_client_connected(self, conn, role, msgtype, pkt: Packet) -> None:
        boot_eid = pkt.read_entity_id()
        gi = self._choose_game(boot=True)
        if gi is None:
            if len(self._boot_pending) < self.BOOT_PENDING_MAX:
                client_id = pkt.read_entity_id()
                q = Packet(bytes(pkt.buf))
                q.trace = pkt.trace
                self._boot_pending.append(
                    (time.monotonic(), client_id, q))
                self._m_boot_queued.inc()
                logger.warning(
                    "dispatcher%d: no game for boot entity; queued "
                    "(%d pending)", self.id, len(self._boot_pending),
                )
            else:
                logger.error(
                    "dispatcher%d: no game for boot entity and queue "
                    "full; dropped", self.id,
                )
            return
        self._entity_info(boot_eid).game_id = gi.game_id
        pkt.rpos = 2
        gi.send(pkt, release=False)

    def _flush_boot_pending(self) -> None:
        """Re-route boot requests parked during a zero-game outage (a
        game just handshaked, so re-choosing usually finds one).
        Entries older than the TTL are expired instead: their clients
        disconnected long ago and would only become orphan entities
        with dead client bindings. A still-unroutable entry (the new
        game has ban_boot) is RE-PARKED with its original timestamp so
        the TTL keeps counting and the queued metric stays one-per-
        arrival."""
        if not self._boot_pending:
            return
        pending, self._boot_pending = list(self._boot_pending), deque()
        now = time.monotonic()
        routed = expired = 0
        for t, cid, q in pending:
            if now - t > self.BOOT_PENDING_TTL:
                expired += 1
                continue
            gi = self._choose_game(boot=True)
            if gi is None:
                self._boot_pending.append((t, cid, q))
                continue
            q.rpos = 2
            boot_eid = q.read_entity_id()
            self._entity_info(boot_eid).game_id = gi.game_id
            q.rpos = 2
            gi.send(q, release=False)
            routed += 1
        logger.info(
            "dispatcher%d: routed %d queued boot requests "
            "(%d expired, %d re-parked)",
            self.id, routed, expired, len(self._boot_pending),
        )

    def _h_client_disconnected(self, conn, role, msgtype, pkt: Packet) -> None:
        client_id = pkt.read_entity_id()
        owner = pkt.read_var_str()
        if self._boot_pending:
            # cancel any parked boot for this client: it gave up during
            # the zero-game window and must not mint an orphan entity
            self._boot_pending = deque(
                e for e in self._boot_pending if e[1] != client_id
            )
        pkt.rpos = 2
        if owner and owner in self.entities:
            self._dispatch_to_entity(owner, pkt)
        else:
            # no known owner: all games check their client bindings
            for gi in self.games.values():
                gi.send(Packet(bytes(pkt.buf)), release=False)

    def _route_index(self) -> tuple[bool, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """(hashed?, sorted keys, aligned S16 eids, aligned i32
        game_ids) over the routing table, cached against
        ``_route_version`` and rebuilt lazily on the first sync batch
        after any routing change. Built/probed via
        :func:`ids.build_eid_index` (u64 hash keys with byte-exact
        verification, raw-S16 fallback on collision). Rebuild is
        O(E log E) vectorized — paid per routing churn, not per record."""
        ver = _route_version
        if self._route_cache is None or self._route_cache[0] != ver:
            eids = np.array(list(self.entities.keys()), dtype="S16") \
                if self.entities else np.empty(0, "S16")
            games = np.fromiter(
                (i.game_id for i in self.entities.values()),
                np.int32, count=len(self.entities),
            )
            hashed, keys, sorted_eids, order = ids.build_eid_index(eids)
            self._route_cache = (ver, hashed, keys, sorted_eids,
                                 games[order])
        return self._route_cache[1:]

    def _h_sync_upstream(self, conn, role, msgtype, pkt: Packet) -> None:
        """Split a gate's 32B-record batch by eid->game and re-batch per
        game (reference ``handleSyncPositionYawFromClient`` ``:770-795``)
        — vectorized: one searchsorted against the cached route index
        routes the whole batch; unroutable and blocked records drop, as
        in the reference's per-record skip."""
        buf = memoryview(pkt.buf)[pkt.rpos:]
        nrec = len(buf) // proto.SYNC_RECORD_SIZE
        if nrec == 0:
            return
        rec = np.frombuffer(
            buf[: nrec * proto.SYNC_RECORD_SIZE], dtype=_SYNC_REC_DTYPE
        )
        hashed, keys, sorted_eids, games = self._route_index()
        if keys.size == 0:
            return
        eids = rec["eid"]
        p, ok = ids.probe_eid_index(hashed, keys, sorted_eids, eids)
        gm = np.where(ok, games[p], 0)
        if self._blocked_until:
            now = time.monotonic()
            for k in [k for k, t in self._blocked_until.items()
                      if t <= now]:
                del self._blocked_until[k]
            if self._blocked_until:
                gm = np.where(
                    np.isin(eids, np.array(list(self._blocked_until),
                                           dtype="S16")),
                    0, gm,
                )
        for g in np.unique(gm):
            if g == 0:
                continue
            self._sync_pending.setdefault(int(g), bytearray()).extend(
                rec[gm == g].tobytes()
            )

    def _h_sync_downstream(self, conn, role, msgtype, pkt: Packet) -> None:
        """Game -> gate leg: the packet is [gate_id][48B records...]
        (reference ``handleSyncPositionYawOnClients`` ``:765-768``)."""
        gate_id = pkt.read_u16()
        g = self.gates.get(gate_id)
        if g is not None:
            if pkt.age is not None:
                # close the dispatcher lane of the sync-age stamp: the
                # forward instant separates game->dispatcher residence
                # from dispatcher->gate (utils/syncage.py); the trailer
                # is re-applied by wire_payload with this value
                pkt.age.t_disp_us = int(time.time() * 1e6)
            g.send(pkt, release=False)

    def _h_to_gate(self, conn, role, msgtype, pkt: Packet) -> None:
        gate_id = pkt.read_u16()
        g = self.gates.get(gate_id)
        if g is not None:
            g.send(pkt, release=False)

    def _h_filtered_broadcast(self, conn, role, msgtype, pkt: Packet) -> None:
        for g in self.gates.values():
            g.send(Packet(bytes(pkt.buf)), release=False)

    def _h_to_game(self, conn, role, msgtype, pkt: Packet) -> None:
        """Forward a game-targeted packet verbatim (leading u16 = the
        target game id; the replication leg). A dead/unknown target is
        dropped loudly — replication self-heals by keyframe, so a lost
        frame costs lag, never correctness."""
        target = pkt.read_u16()
        gi = self.games.get(target)
        if gi is None:
            logger.warning(
                "dispatcher%d: msgtype %d for unknown game%d dropped",
                self.id, msgtype, target,
            )
            return
        pkt.rpos = 2
        gi.send(pkt, release=False)

    def _h_kvreg(self, conn, role, msgtype, pkt: Packet) -> None:
        """First-writer-wins registry write + broadcast (reference
        ``DispatcherService.go:728-742``)."""
        key = pkt.read_var_str()
        val = pkt.read_var_str()
        force = pkt.read_bool()
        if key in self.kvreg and not force:
            val = self.kvreg[key]  # lost the race: broadcast the winner
        else:
            self.kvreg[key] = val
        if key.startswith("rebalance/pause/game"):
            # the rebalance admission-pause lane (goworld_tpu/
            # rebalance/): a donor mid-handoff takes itself out of
            # boot/min-load placement until the move resolves
            try:
                gid = int(key[len("rebalance/pause/game"):])
            except ValueError:
                gid = 0
            gi = self.games.get(gid)
            if gi is not None:
                gi.rebalance_paused = val not in ("", "0", "false")
        out = proto.pack_kvreg_register(key, val, False)
        self._broadcast_to_games(out)

    def _h_lbc(self, conn, role, msgtype, pkt: Packet) -> None:
        if role is not None and role[0] == "game":
            gi = self.games.get(role[1])
            if gi is not None:
                gi.load = pkt.read_f32()

    # -- migration (reference :834-891) ---------------------------------
    def _h_query_space(self, conn, role, msgtype, pkt: Packet) -> None:
        space_id = pkt.read_entity_id()
        eid = pkt.read_entity_id()
        info = self.entities.get(space_id)
        ack = new_packet(proto.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK)
        ack.append_entity_id(space_id)
        ack.append_entity_id(eid)
        ack.append_u16(info.game_id if info is not None else 0)
        conn.send(ack)

    def _h_migrate_request(self, conn, role, msgtype, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        space_id = pkt.read_entity_id()
        space_game = pkt.read_u16()
        info = self._entity_info(eid)
        info.block(consts.MIGRATE_TIMEOUT)
        self._blocked_until[eid.encode("ascii")] = info.block_until
        ack = new_packet(proto.MT_MIGRATE_REQUEST_ACK)
        ack.append_entity_id(eid)
        ack.append_entity_id(space_id)
        ack.append_u16(space_game)
        conn.send(ack)

    def _h_real_migrate(self, conn, role, msgtype, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        target_game = pkt.read_u16()
        info = self._entity_info(eid)
        info.game_id = target_game
        gi = self.games.get(target_game)
        if gi is not None:
            pkt.rpos = 2
            gi.send(pkt, release=False)
        self._unblock_entity(eid)

    def _h_cancel_migrate(self, conn, role, msgtype, pkt: Packet) -> None:
        self._unblock_entity(pkt.read_entity_id())

    def _h_broadcast_games(self, conn, role, msgtype, pkt: Packet) -> None:
        pkt.rpos = 2
        self._broadcast_to_games(Packet(bytes(pkt.buf)))

    def _h_start_freeze(self, conn, role, msgtype, pkt: Packet) -> None:
        """Block the whole game for the freeze window and ack (reference
        ``DispatcherService.go:471-488``)."""
        if role is None or role[0] != "game":
            return
        gi = self.games.get(role[1])
        if gi is None:
            return
        gi.blocked_until = time.monotonic() + consts.FREEZE_BLOCK_TIMEOUT
        ack = new_packet(proto.MT_START_FREEZE_GAME_ACK)
        ack.append_u16(self.id)
        conn.send(ack)

    # -- disconnects (reference :551-634) -------------------------------
    def _on_disconnect(self, role: tuple[str, int]) -> None:
        kind, rid = role
        if kind == "game":
            gi = self.games.get(rid)
            if gi is not None:
                gi.conn = None
            if gi is not None and gi.blocked:
                # freezing: keep routing entries, queue packets for restore
                logger.info(
                    "dispatcher%d: game%d gone while frozen; awaiting "
                    "restore", self.id, rid,
                )
            else:
                stale = [
                    eid for eid, info in self.entities.items()
                    if info.game_id == rid
                ]
                for eid in stale:
                    del self.entities[eid]
                if stale:
                    _bump_route_version()
                p = new_packet(proto.MT_NOTIFY_GAME_DISCONNECTED)
                p.append_u16(rid)
                self._broadcast_to_games(p, exclude=rid)
                logger.info(
                    "dispatcher%d: game%d disconnected (%d entities "
                    "dropped)", self.id, rid, len(stale),
                )
        else:
            self.gates.pop(rid, None)
            p = new_packet(proto.MT_NOTIFY_GATE_DISCONNECTED)
            p.append_u16(rid)
            self._broadcast_to_games(p)
            logger.info("dispatcher%d: gate%d disconnected", self.id, rid)
