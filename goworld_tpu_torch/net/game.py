"""Game server — hosts a :class:`World` and connects it to the cluster.

Reference being rebuilt: ``components/game/GameService.go`` (the packet
switch + tick serve loop, ``:77-190``) and ``components/game/game.go``
(boot sequence ``:65-135``). The reference's single logic goroutine becomes
a single logic *thread* driving ``World.tick()``; asyncio networking runs on
a background thread and exchanges packets with the logic thread through a
queue — the same "logic is single-threaded, I/O is concurrent" shape
(``SURVEY.md#1``).

Outbound client traffic: per-record messages (create/destroy/attr/rpc) are
sent as they happen; position sync records batch per gate per tick into one
``MT_SYNC_POSITION_YAW_ON_CLIENTS`` packet (the reference collects these in
``CollectEntitySyncInfos`` and ships per-gate packets, ``Entity.go:1208-1267``).
"""

from __future__ import annotations

import asyncio
import collections
import gc as _gc
import os
import threading
import time
from typing import Callable

import numpy as np
import torch

from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.net import codec, proto
from goworld_tpu_torch.net.cluster import DispatcherCluster, DispatcherConn
from goworld_tpu_torch.net.packet import Packet, new_packet
from goworld_tpu_torch.utils import consts, faults, flightrec, log, metrics, \
    opmon, overload, syncage, tracing

logger = log.get("game")

# module-level like the opmon.expose twins (one game per process; tests
# drive _mh_drain_pending on stubs that bypass __init__)
_m_mh_backlog_pkts = metrics.gauge("mh_mutation_backlog_packets")
_m_mh_backlog_bytes = metrics.gauge("mh_mutation_backlog_bytes")

# Dispatcher packets that MUTATE the World. Under a multi-controller
# (multihost) World these land on ONE controller's dispatcher connection
# but must be applied on ALL controllers in the same tick (the SPMD
# contract, parallel/multihost.py) — so they are queued raw and exchanged
# through a per-tick all-gather before World.tick (see
# _mh_exchange_mutations). The reference has no analog: its dispatcher
# star routes each packet to the single game hosting the entity
# (DispatcherService.go); here one World spans every controller.
_MH_WORLD_MSGTYPES = frozenset({
    proto.MT_NOTIFY_CLIENT_CONNECTED,
    proto.MT_NOTIFY_CLIENT_DISCONNECTED,
    proto.MT_NOTIFY_GATE_DISCONNECTED,
    proto.MT_SYNC_POSITION_YAW_FROM_CLIENT,
    proto.MT_CALL_ENTITY_METHOD,
    proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT,
    proto.MT_CREATE_ENTITY_ANYWHERE,
    proto.MT_LOAD_ENTITY_ANYWHERE,
    proto.MT_CALL_NIL_SPACES,
    # kvreg updates drive service-shard decisions (entity/service.py);
    # logging them makes the kvreg mirror SPMD-consistent at the
    # tick-driven reconcile points, so every controller of the group
    # reaches the same claim/create conclusions
    proto.MT_KVREG_REGISTER,
})

# The subset of _MH_WORLD_MSGTYPES the dispatcher BROADCASTS to every
# game connection (the rest are eid/owner-routed and reach exactly one
# controller). Each of a group's N controllers receives its own copy,
# so only the LEADER logs them — otherwise the all-gather union would
# replay every broadcast N times (N nil-space invocations per
# call_nil_spaces, N-fold kvreg watcher fires, ...).
_MH_BROADCAST_MSGTYPES = frozenset({
    proto.MT_KVREG_REGISTER,
    proto.MT_CALL_NIL_SPACES,
    proto.MT_NOTIFY_GATE_DISCONNECTED,
})


class GameServer:
    """One game process: a World + connections to every dispatcher."""

    def __init__(
        self,
        game_id: int,
        world: World,
        dispatcher_addrs: list[tuple[str, int]],
        *,
        boot_entity: str = "Account",
        ban_boot: bool = False,
        tick_interval: float = 1.0 / consts.TICK_HZ,
        freeze_dir: str = ".",
        restore: bool = False,
        checkpoint_interval: float = 0.0,
        gc_freeze_on_boot: bool = True,
        pend_max_packets: int = consts.MAX_RECONNECT_PEND_PACKETS,
        pend_max_bytes: int = consts.MAX_RECONNECT_PEND_BYTES,
        overload_enabled: bool = True,
        overload_up_ticks: int = consts.OVERLOAD_UP_TICKS,
        overload_down_ticks: int = consts.OVERLOAD_DOWN_TICKS,
        overload_latency_ratio: float = consts.OVERLOAD_LATENCY_RATIO,
        degraded_sync_stride: int = consts.DEGRADED_SYNC_STRIDE,
        degraded_event_coalesce: int = consts.DEGRADED_EVENT_COALESCE_TICKS,
        flightrec_ring: int = flightrec.DEFAULT_RING,
        flightrec_cooldown_secs: float = flightrec.DEFAULT_COOLDOWN_SECS,
        sync_delta: bool = False,
        sync_keyframe_every: int = 16,
        sync_age: bool = True,
        governor_enabled: bool = False,
        governor_window_ticks: int = 64,
        governor_up_windows: int = 2,
        governor_down_windows: int = 2,
        governor_cooldown_windows: int = 4,
        governor_regret_pct: float = 0.25,
        governor_table: str = "",
        audit_scrub_every: int = 0,
        standby_of: int = 0,
        replication_keyframe_every: int = 0,
        replication_queue: int = 4,
        replication_lag_budget_ticks: int = 16,
        rebalance_enabled: bool = False,
        rebalance_batch: int = 64,
    ):
        self.game_id = game_id
        self.world = world
        # SnapshotChain CRC-scrub cadence (ticks; 0 = off): every Nth
        # tick the audit worker walks this game's chain files with
        # read_freeze_file, turning latent on-disk corruption into a
        # named snapshot_crc violation instead of a surprise at the
        # next -restore boot (utils/audit.py)
        self.audit_scrub_every = max(0, int(audit_scrub_every))
        self.gc_freeze_on_boot = gc_freeze_on_boot
        self.boot_entity = boot_entity
        self.ban_boot = ban_boot
        self.tick_interval = tick_interval
        # freeze/restore (reference GameService.go:220-313 rs* states)
        self.freeze_dir = freeze_dir
        self.run_state = "running"  # running | freezing | frozen | stopped
        self._freeze_acks: set[int] = set()
        # periodic crash-recovery checkpoint cadence (seconds; 0 = off)
        self.checkpoint_interval = checkpoint_interval
        self._last_ckpt_mono = time.monotonic()
        self._is_restore = False
        if restore:
            from goworld_tpu_torch import freeze as _freeze

            _freeze.restore_from_file(world, freeze_dir)
            self._is_restore = True

        # prioritized ingress: bounded per-class queues drained
        # highest-priority first, so a sync/event flood can neither
        # evict nor delay-behind-it the migration/RPC control plane
        # (utils/overload.py; replaces the old single FIFO queue)
        self._packet_q = overload.ClassQueues(stage="game_queue")
        # overload ladder: observed once per serve-loop tick; NORMAL
        # when disabled (observe() is simply never called)
        self.overload = overload.register(overload.OverloadGovernor(
            f"game{game_id}",
            up_ticks=overload_up_ticks,
            down_ticks=overload_down_ticks,
            latency_ratio=overload_latency_ratio,
        ))
        self.overload_enabled = overload_enabled
        self.degraded_sync_stride = max(1, int(degraded_sync_stride))
        self.degraded_event_coalesce = max(1, int(degraded_event_coalesce))
        self._fanout_tick = 0  # coalesce phase counter (DEGRADED+)
        # shed counters captured at the last sustained-backlog alarm so
        # the alarm can report what was shed SINCE the previous interval
        self._shed_at_alarm: dict[str, float] = {}
        self.cluster = DispatcherCluster(
            dispatcher_addrs, self._on_packet_netthread, self._handshake,
            edge="game->dispatcher",
            pend_max_packets=pend_max_packets,
            pend_max_bytes=pend_max_bytes,
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._net_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.deployment_ready = False
        self.ready_event = threading.Event()
        # dispatcher ids that acked our SET_GAME_ID (handshake barrier)
        self.handshake_acks: set[int] = set()
        self.kvreg: dict[str, str] = {}
        # cluster view (reference gameService.onlineGames / GetOnlineGames)
        self.online_games: set[int] = {game_id}
        self.kvreg_watchers: list[Callable[[str, str], None]] = []
        # in-flight outbound migrations: eid -> (entity, space_id, pos)
        self._migrating_out: dict[str, tuple[Entity, str, tuple]] = {}
        # per-gate downstream sync batches for the current tick
        self._sync_out: dict[int, list] = {}
        # delta-compressed sync fan-out ([gameN] sync_delta):
        # per-gate DeltaSyncEncoder state; step derived from the
        # world's precision lattice when active (ONE quantizer across
        # device, wire and snapshots), else from the world extent
        self.sync_delta = bool(sync_delta)
        self.sync_keyframe_every = max(1, int(sync_keyframe_every))
        self._sync_encoders: dict[int, "codec.DeltaSyncEncoder"] = {}
        # end-to-end sync-age stamping (utils/syncage.py, [gameN]
        # sync_age, default ON): every sync fan-out batch carries the
        # device-tick epoch that produced it as a 45 B flagged trailer;
        # the gate turns it into age-at-delivery histograms. Off =
        # byte-identical legacy wire.
        self.sync_age = bool(sync_age)
        # downstream sync bytes split BY WIRE MODE so the age plane can
        # correlate staleness with what actually went on the wire:
        # full 48 B records vs delta-codec keyframe vs delta records
        self._m_sync_bytes = {
            kind: metrics.counter(
                "sync_bytes_out",
                help="downstream sync payload bytes by wire mode",
                kind=kind)
            for kind in ("full", "keyframe", "delta")
        }
        self._sync_bytes_mark = {"keyframe": 0, "delta": 0}
        # per-gate ordered (inner_msgtype, body) client messages staged
        # this tick; flushed as ONE MT_CLIENT_EVENTS_BATCH packet per
        # gate (before syncs, so a create precedes its entity's first
        # position sync). Emission order per gate is preserved, so the
        # per-client message order matches the per-message path.
        self._events_out: dict[int, list] = {}
        self._event_recs_flushed = 0  # per-tick gauge accumulator
        # trace context staged per gate for the current tick's client
        # event bundle: set by _client_sink when a traced handler emits
        # client messages, applied to the bundle packet at flush so the
        # gate's egress span stays linked to the inbound RPC's trace
        self._events_trace: dict[int, tracing.TraceContext] = {}
        self.on_deployment_ready: Callable[[], None] | None = None
        # multihost World-mutation log (see _MH_WORLD_MSGTYPES)
        self._mh_pending: list[tuple[int, bytes]] = []
        self._mh_backlog_ticks = 0  # consecutive ticks with carry-over
        self._mh_replaying = False
        self._mh_all_ready = False       # all-gathered group readiness
        self._mh_leader_game_id = self.game_id  # all-gathered, row 0
        self._mh_freeze_requested = False  # leader sets; exchange spreads
        self._mh_ckpt_due = False          # leader's wall-clock verdict

        # scrapeable serve-loop series (debug_http /metrics): tick
        # latency distribution, fell-behind backlog, queue depths and
        # drop counters — every silent saturation signal gets a name
        self._m_tick_hist = metrics.histogram(
            "tick_latency_ms", help="serve-loop tick wall time")
        # the /costs SLO verdict reads tick_latency_ms against this
        # process's OWN budget (one tick interval) — the paper's 16 ms
        # at the default 60 Hz (utils/devprof, cli status)
        from goworld_tpu_torch.utils import devprof

        devprof.set_slo_target(1000.0 * self.tick_interval)
        self._m_backlog = metrics.gauge(
            "backlog_ticks",
            help="ticks the serve loop is behind its cadence")
        self._m_queue_depth = metrics.gauge(
            "input_queue_depth", help="pending dispatcher packets")
        self._m_pkt_drop = metrics.counter(
            "packet_queue_drop_total",
            help="dispatcher packets dropped on a full input queue")
        self._m_event_records = metrics.counter(
            "client_event_records_total",
            help="client event records flushed downstream")

        # incident flight recorder + live workload signature (
        # utils/flightrec.py): one correlated frame per tick; an SLO
        # breach vs this process's OWN tick budget, an overload-ladder
        # transition, an over_cap-after-quiet oracle anomaly or a
        # signature class change freezes a ring-tail bundle served at
        # debug-http /incidents. flightrec_ring=0 disables. Weakrefs
        # throughout: the registries are process-global and must never
        # pin a discarded server's World (the devprof convention).
        import weakref

        wself = weakref.ref(self)
        self.flightrec: flightrec.FlightRecorder | None = None
        self._last_sig: str | None = None
        from goworld_tpu_torch.utils import devprof as _devprof

        # tolerate stub worlds (tests drive GameServer with bare
        # namespaces that carry no device config)
        grid = getattr(getattr(world, "cfg", None), "grid", None)
        self._kernel_key = ",".join(
            f"{k}={v}" for k, v in sorted(
                _devprof.grid_config_key(grid).items())
        ) if grid is not None else "unknown"
        if flightrec_ring > 0:

            def _ctx() -> dict:
                s = wself()
                return {} if s is None else s._incident_context()

            self.flightrec = flightrec.register(
                f"game{game_id}",
                flightrec.FlightRecorder(
                    ring=flightrec_ring,
                    cooldown_secs=flightrec_cooldown_secs,
                    context_fn=_ctx,
                ),
            )

        def _workload() -> dict | None:
            s = wself()
            return None if s is None else s.world.workload_signature()

        flightrec.set_workload_provider(_workload)

        # online kernel governor (goworld_tpu/autotune): the
        # workload signature hot-swaps the resolved tick config between
        # ticks. Only the single-shard non-mesh shape qualifies (the
        # candidates toggle the skin's runtime branches); ineligible or
        # telemetry-less worlds get a loud warning, never a crash.
        self.governor = None
        self._gov_last_win = -1
        self._gov_hist_mark: list | None = None
        if governor_enabled:
            try:
                from goworld_tpu_torch import autotune

                table = dict(autotune.seed_table())
                if governor_table:
                    table.update(autotune.parse_table(governor_table))
                self.governor = autotune.register(
                    f"game{game_id}",
                    autotune.KernelGovernor(
                        world, name=f"game{game_id}", table=table,
                        up_windows=governor_up_windows,
                        down_windows=governor_down_windows,
                        cooldown_windows=governor_cooldown_windows,
                        regret_pct=governor_regret_pct,
                    ),
                )
                # the governor's window IS the signature rotation: one
                # decision per drained window (instance attr shadows
                # the class default)
                world.SIG_WINDOW_TICKS = max(8,
                                             int(governor_window_ticks))
                if not getattr(world, "telemetry_live", False):
                    logger.warning(
                        "game%d: governor enabled but telemetry_live "
                        "is off — no signature windows will arrive, "
                        "the config stays static", game_id,
                    )
            except Exception as exc:
                logger.warning(
                    "game%d: kernel governor disabled (%s)", game_id,
                    exc,
                )

        # hot-standby replication (goworld_tpu_torch/replication/):
        # primary side lazily builds a bounded worker when a standby
        # subscribes or the chain-checkpoint cadence fires; standby
        # side ([gameN] standby_of = M) mirrors the primary's frame
        # stream instead of ticking, until promoted
        self.standby_of = int(standby_of)
        self.replication_keyframe_every = int(replication_keyframe_every)
        self.replication_queue = int(replication_queue)
        self.repl_worker = None
        self._repl_subscribers: set[int] = set()
        self._repl_disk_due = False
        self._repl_late_frames = 0
        self._standby_applier = None
        self.standby_tracker = None
        self._promoted = False
        self._promote_pending: int | None = None
        self._promote_claim: str | None = None
        self._promote_epoch = 0
        self._promote_log = None
        # dispatcher legs whose dispatcher still holds the primary (its
        # latest handshake ack listed it, or it connected since): the
        # standby claims only once every one dropped it, its connection
        # was lost, or PROMOTE_LEG_WAIT_S passed (see _standby_tick).
        # Lost legs arrive from the net thread through _lost_legs.
        self._primary_online_legs: set[int] = set()
        self._lost_legs: collections.deque[int] = collections.deque()
        self._promote_waiting_since: float | None = None
        for conn in self.cluster.conns:
            conn.on_disconnect = self._lost_legs.append
        self._repl_attached = False
        self._repl_resub = 0
        self._standby_warmed = False
        if self.standby_of:
            if world._multihost:
                raise ValueError(
                    "standby_of is single-controller only (a multihost "
                    "group's collectives cannot pause for mirroring)")
            from goworld_tpu_torch.replication import standby as _standby

            self.standby_tracker = _standby.register(
                f"game{game_id}",
                _standby.StandbyTracker(
                    game_id, self.standby_of,
                    tick_hz=1.0 / max(tick_interval, 1e-6),
                    lag_budget_ticks=int(replication_lag_budget_ticks),
                ),
            )
            self._standby_applier = _standby.StandbyApplier(
                world, self.standby_of, tracker=self.standby_tracker)
            self.standby_tracker.on_promote = self._request_promotion
            self.kvreg_watchers.append(self._on_promotion_kvreg)

        # self-healing rebalance plane (goworld_tpu_torch/rebalance/): a
        # per-game handoff agent drives bounded entity cohorts to an
        # underloaded peer through the PRODUCTION migration protocol
        # (wire mode: the agent only initiates _remote_enter_space; the
        # QUERY_SPACE -> MIGRATE_REQUEST -> REAL_MIGRATE handlers do the
        # removal, so an abandoned move leaves the entity live on the
        # source by construction). The agent also answers the
        # /rebalance?handoff= manual drain.
        self.rebalance_enabled = bool(rebalance_enabled)
        self.rebalance_agent = None
        self._rebalance_pub_tick = 0
        self._rebalance_paused_pub = False
        if self.rebalance_enabled:
            from goworld_tpu_torch import rebalance as _rebalance

            self.rebalance_agent = _rebalance.register(
                f"game{game_id}",
                _rebalance.HandoffExecutor(
                    world, game_id=game_id,
                    batch=max(1, int(rebalance_batch))))
            _rebalance.set_handoff_hook(self._request_handoff)

        # wire the world's pluggable edges to the cluster
        w = world
        w.client_sink = self._client_sink
        w.sync_sink = self._sync_sink
        w.remote_router = self._remote_call
        w.remote_space_router = self._remote_enter_space
        w.filtered_sink = self._filtered_sink
        w.on_entity_created = self._notify_entity_created
        w.on_entity_destroyed = self._notify_entity_destroyed

    # ==================================================================
    # lifecycle
    # ==================================================================
    def start_network(self) -> None:
        """Spawn the asyncio networking thread and connect to dispatchers."""
        started = threading.Event()

        def run() -> None:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self.cluster.start()
            started.set()
            self._loop.run_forever()

        self._net_thread = threading.Thread(
            target=run, name=f"game{self.game_id}-net", daemon=True
        )
        self._net_thread.start()
        started.wait()

    def stop(self) -> None:
        from goworld_tpu_torch.net.loops import drain_and_close

        self._stop.set()
        drain_and_close(self._loop, self._net_thread,
                        pre_stop=self.cluster.stop)

    def serve_forever(self) -> None:
        """The logic loop: drain packets, tick the world, repeat."""
        if self.gc_freeze_on_boot:
            # Move everything alive at boot (the spawned entity
            # population, attr trees, numpy mirrors, handler tables)
            # into the GC's permanent generation: a gen-2 collection
            # otherwise walks the whole world — ~100 ms at a 131K-entity
            # shard, the p95 frame spike tools/probe_fanout.py measured
            # (the 16 ms frame can't absorb a 6x stall). Post-boot
            # allocations stay tracked, so normal churn still collects;
            # ini [gameN] gc_freeze=false opts out.
            _gc.collect()
            _gc.freeze()
            logger.info(
                "game%d: froze %d boot objects out of the collector",
                self.game_id, _gc.get_freeze_count(),
            )
        next_tick = time.monotonic()
        tl = metrics.timeline
        while not self._stop.is_set():
            if faults.active:
                # chaos crashpoint: `crash:game.tick@n=N` dies at the
                # Nth serve-loop iteration (deterministic, unlike a
                # wall-clock kill racing the boot compile)
                faults.maybe_crash("game.tick")
            # the serve loop owns the tick record: the pump and fan-out
            # spans land in the same trace row as the World's phases
            tl.begin_tick()
            self._m_queue_depth.set(self._packet_q.qsize())
            # residency accounting (utils/residency.py): the pump below
            # is useful host work between device dispatches, the pacing
            # sleep at the bottom is idle by design — declare both so
            # neither reads as a bubble
            rt = getattr(self.world, "residency", None)
            t_pump = time.perf_counter()
            with tl.span("drain_inputs"):
                # 1.5 frames of handler work per tick keeps the loop
                # observing (and the p99 near 2x the interval) under a
                # flood; the surplus waits in the class queues
                self.pump(
                    budget=1.5 * self.tick_interval
                    if self.overload_enabled else None
                )
            if rt is not None:
                rt.add_host(time.perf_counter() - t_pump)
            self.tick()
            dur = tl.end_tick()
            if dur is not None:
                self._m_tick_hist.observe(dur * 1e3)
            if self.run_state == "freezing":
                self._do_freeze()
                return
            next_tick += self.tick_interval
            delay = next_tick - time.monotonic()
            backlog = max(0.0, -delay / self.tick_interval)
            self._m_backlog.set(backlog)
            if self.overload_enabled:
                self._observe_overload(dur, backlog)
            if delay > 0:
                time.sleep(delay)
                if rt is not None:
                    rt.add_idle(delay)
            else:
                next_tick = time.monotonic()  # fell behind; don't spiral

    def _observe_overload(self, dur: float | None,
                          backlog: float) -> None:
        """Feed this tick's measured signals to the overload governor
        and push the resulting degradation knobs into the fan-out."""
        pend_frac = 0.0
        for c in self.cluster.conns:
            if c.pend_max_bytes > 0:
                pend_frac = max(
                    pend_frac, c._pending_bytes / c.pend_max_bytes
                )
        st = self.overload.observe(
            (dur / self.tick_interval) if dur else 0.0,
            backlog,
            self._packet_q.depth_frac(),
            pend_frac,
        )
        # DEGRADED+: AOI/attr-sync fan-out strides entity cohorts
        # (entity/manager.py applies the mask vectorized); back to 1 the
        # tick the ladder returns to NORMAL
        self.world.sync_stride = (
            self.degraded_sync_stride if st >= overload.DEGRADED else 1
        )

    # ==================================================================
    # freeze (hot reload; reference GameService.go:220-313, SURVEY.md#3.6)
    # ==================================================================
    def request_freeze(self) -> None:
        """Ask every dispatcher to block this game's traffic; freezing
        starts once all of them ack (reference ``startFreeze``,
        ``GameService.go:474-478``)."""
        if self.run_state != "running":
            return
        if self.world._multihost and self.world.mh_rank != 0:
            # the CLI signals the LEADER; a follower cannot drive the
            # dispatcher ack dance (its wire id owns no entity routes)
            logger.warning(
                "game%d: multihost freeze must be requested on the "
                "leader controller", self.game_id,
            )
            return
        self._freeze_acks.clear()
        p = new_packet(proto.MT_START_FREEZE_GAME)
        for conn in self.cluster.conns:
            self._send(conn, Packet(bytes(p.buf)))
        p.release()

    def _do_freeze(self) -> None:
        """All dispatchers acked: drain deferred work, snapshot, exit.
        The CLI restarts the process with ``-restore``."""
        import os

        from goworld_tpu_torch import freeze as _freeze

        w = self.world
        w.post_q.tick()
        # the deferred work just drained may have staged client
        # messages; the tick loop will never flush again, so do it now
        # (pre-batching they were sent immediately)
        self._flush_sync_out(force=True)
        # an in-flight ASYNC checkpoint must finish before the freeze
        # file is written: its atomic rename landing afterwards would
        # give an OLDER-state checkpoint a NEWER mtime, and the
        # -restore boot picks snapshots by mtime
        # (freeze.latest_snapshot_path)
        deadline = time.monotonic() + 30.0
        while getattr(w, "_ckpt_inflight", False) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        # snapshot FIRST: OnFreeze hooks may enqueue storage saves, which
        # the drain below must still execute (reference doFreeze ordering).
        # Multihost: EVERY controller reaches here after the same tick
        # (the exchange spread the decision) and freeze_world's device
        # snapshot is an all-gather, so all ranks hold the identical
        # global snapshot — the LEADER alone writes the file, which every
        # rank reads back on the -restore start.
        data = _freeze.freeze_world(w)
        if w.storage is not None:
            w.storage.shutdown()
        path = os.path.join(
            self.freeze_dir, _freeze.freeze_filename(w.game_id)
        )
        if not self._mh_follower():
            _freeze.write_freeze_file(path, data)
            logger.info("game%d: frozen to %s", self.game_id, path)
        # OnFreeze hooks may have emitted client messages after the
        # first flush — put them on the wire before exiting
        self._flush_sync_out(force=True)
        self.run_state = "frozen"
        self.stop()

    def pump(self, budget: float | None = None) -> int:
        """Drain and handle queued dispatcher packets (logic thread),
        highest traffic class first — under backlog the migration/RPC
        control plane is applied before sync/event noise.

        ``budget`` (seconds) TIME-BOXES the drain: without it, an
        arrival rate above the service rate turns one "tick" into a
        minutes-long grind — the tick deadline is obliterated AND the
        overload governor starves (one observation per mega-tick, so
        the ladder can never climb). With a budget the loop returns
        mid-queue once the box is spent; the remainder stays queued
        (bounded per class) for the next tick, the serve loop keeps
        its cadence, and sustained pressure becomes a SIGNAL instead
        of a stall."""
        n = 0
        deadline = (
            time.monotonic() + budget if budget is not None else None
        )
        while True:
            try:
                didx, msgtype, pkt = self._packet_q.pop()
            except IndexError:
                return n
            try:
                self._handle_packet(didx, msgtype, pkt)
            except Exception:
                logger.exception(
                    "game%d: handler for msgtype %d failed",
                    self.game_id, msgtype,
                )
            n += 1
            if deadline is not None and time.monotonic() > deadline:
                return n

    def tick(self) -> None:
        if self._standby_applier is not None and not self._promoted:
            # a standby's world evolves ONLY by applied frames (the
            # pump above already ran the applier); no device tick, no
            # fan-out, until promotion flips this gate off
            self._standby_tick()
            return
        # wall clock measured HERE (not in serve_forever) so manual
        # pump()/tick() loops — tests, embedded harnesses — feed the
        # flight recorder the same SLO signal as the real serve loop
        t0 = time.perf_counter()
        tl = metrics.timeline
        rt = getattr(self.world, "residency", None)
        if self.world._multihost:
            # the exchange also publishes world.mh_group_ready, which
            # gates the World's own tick-cadence service reconcile
            with tl.span("mh_exchange"):
                self._mh_exchange_mutations()
            if rt is not None:
                rt.add_host(time.perf_counter() - t0)
        self.world.tick()
        # everything from here to the end of tick() is useful host work
        # between device dispatches — declared to the residency plane
        # so the bubble verdict only counts genuinely idle time
        t_host = time.perf_counter()
        with tl.span("fan_out"):
            self._flush_sync_out()
            self._maybe_checkpoint()
        self._replication_pump()
        if self.rebalance_agent is not None:
            try:
                self._rebalance_service()
            except Exception:  # must never break a tick
                logger.exception("rebalance service failed")
        ap = getattr(self.world, "audit", None)
        if (ap is not None and self.audit_scrub_every > 0
                and self.world.tick_count % self.audit_scrub_every == 0):
            # hand the chain walk to the audit worker — file IO + CRC
            # math never touch the tick; a busy worker drops the walk
            gid, fdir, tick = (self.game_id, self.freeze_dir,
                               self.world.tick_count)
            ap.submit(lambda: ap.scrub_snapshots(fdir, gid, tick))
        gov_ev = None
        if self.governor is not None:
            # between-ticks commit point: the world's device step for
            # this tick is done, the next tick runs the (possibly)
            # swapped executable
            try:
                gov_ev = self._drive_governor()
            except Exception:  # the governor must never break a tick
                logger.exception("kernel governor window failed")
        if self.flightrec is not None:
            # own span: frame cost stays attributed in the timeline's
            # >=95% per-tick coverage bound
            with tl.span("flightrec"):
                try:
                    self._flightrec_frame(time.perf_counter() - t0,
                                          gov_ev)
                except Exception:  # must never break the tick
                    logger.exception("flight-recorder frame failed")
        if rt is not None:
            rt.add_host(time.perf_counter() - t_host)

    # workload-signature refresh cadence (ticks): how often the tick
    # loop re-reduces the signature for the flight-recorder frame and
    # the [gameN] recommendation line (the /workload endpoint always
    # reduces fresh on demand)
    SIG_LOG_TICKS = 64
    # residency windowed-verdict cadence (ticks): how often the frame
    # carries the bubble p99 of the ticks since the previous window —
    # the residency_regression trigger's input (utils/flightrec.py)
    RESIDENCY_WIN_TICKS = 16
    # rebalance send-window cadence (ticks): a busy handoff agent
    # initiates at most one rate-limited batch window per this many
    # ticks, so the migration path never becomes its own overload
    REBALANCE_PUMP_TICKS = 16
    # kvreg advert cadence for this game's receiving space
    REBALANCE_PUB_TICKS = 64

    def _rebalance_service(self) -> None:
        """Per-tick rebalance housekeeping (logic thread): advertise
        this game's receiving space in kvreg, pump the active handoff
        one send window on its cadence, observe wire completions, and
        publish/clear the deployment-wide admission pause."""
        agent = self.rebalance_agent
        w = self.world
        tick = w.tick_count
        if self._rebalance_pub_tick == 0 \
                or tick - self._rebalance_pub_tick \
                >= self.REBALANCE_PUB_TICKS:
            self._rebalance_pub_tick = max(1, tick)
            nil_id = getattr(w.nil_space, "id", None)
            sid = next(
                (s for s in sorted(w.spaces) if s != nil_id), None)
            if sid is not None:
                self.kvreg_register(
                    f"rebalance/space/game{self.game_id}", sid,
                    force=True)
        if agent.busy:
            if tick % self.REBALANCE_PUMP_TICKS == 0:
                agent.pump()
            agent.wire_poll(self._migrating_out)
        paused = agent.busy
        if paused != self._rebalance_paused_pub:
            self._rebalance_paused_pub = paused
            self.kvreg_register(
                f"rebalance/pause/game{self.game_id}",
                "1" if paused else "0", force=True)

    def _request_handoff(self, target: int,
                         batch: int | None = None) -> dict:
        """The ``/rebalance?handoff=GAMEID`` poke (debug-http thread):
        validate against the kvreg mirror, then post the actual start
        onto the logic thread — the world is single-threaded, and no
        World or CUDA call runs on the HTTP thread."""
        agent = self.rebalance_agent
        if agent is None:
            return {"error": "rebalance disabled on this process"}
        if int(target) == self.game_id:
            return {"error": "cannot hand off to self"}
        space = self.kvreg.get(f"rebalance/space/game{int(target)}")
        if not space:
            return {"error":
                    f"game{int(target)} advertises no receiving space"}
        if agent.busy:
            return {"error": "a handoff is already in flight"}
        tgt, sp = int(target), space

        def _start() -> None:
            if agent.busy:
                return
            try:
                n = agent.start(
                    tgt, "manual",
                    send=lambda eid, e: self._remote_enter_space(
                        e, sp, tuple(e.position)),
                    batch=batch, detach=False)
                logger.info(
                    "game%d: manual handoff of %d entities to game%d "
                    "(space %s)", self.game_id, n, tgt, sp)
            except Exception:
                logger.exception("game%d: manual handoff failed",
                                 self.game_id)

        self.world.post_q.post(_start)
        return {"requested": True, "target": f"game{tgt}",
                "space": sp, "batch": int(batch or agent.batch)}

    def _drive_governor(self):
        """One governor observation per rotated signature window: hand
        it the freshest signature + this window's measured tick-ms p90
        (from the tick_latency_ms histogram delta — wall truth, not the
        modeled device lane), and commit/revert whatever it decides.
        Returns the swap event (stamped into the flight-recorder frame
        as the ``governor_swap`` trigger) or None."""
        w = self.world
        win_tick = getattr(w, "_telem_win_tick", 0)
        if win_tick == self._gov_last_win:
            return None
        self._gov_last_win = win_tick
        from goworld_tpu_torch.utils import devprof

        snap = self._m_tick_hist.snapshot()
        counts = [c for _u, c in snap["buckets"]] + [snap["inf"]]
        p90 = None
        if self._gov_hist_mark is not None \
                and len(self._gov_hist_mark) == len(counts):
            delta = [max(0, a - b) for a, b in
                     zip(counts, self._gov_hist_mark)]
            if sum(delta) > 0:
                # INTERPOLATED quantile: the regret guard compares two
                # p90s, and 2x-spaced bucket UPPER edges would make
                # regret_pct unenforceable (any cross-bucket move reads
                # as >= 2x, any within-bucket regression as 0). An inf
                # p90 (mass beyond the top bucket) is KEPT — it is the
                # strongest possible regression signal and must revert,
                # not disarm; only NaN (impossible here) drops.
                p90 = devprof.hist_quantile_interp(
                    [u for u, _c in snap["buckets"]], delta, 0.9)
                if p90 != p90:
                    p90 = None
        self._gov_hist_mark = counts
        ev = self.governor.on_window(w.window_signature(),
                                     tick_ms_p90=p90)
        if ev is not None:
            # the commit itself RESET the world's signature window
            # (apply_tick_config): resync so the reset is never
            # misread as a rotation one tick later — a 1-sample
            # "window" of pre-swap latency would feed the regret
            # guard garbage. The hist mark drops too: the next
            # genuine window judges a full post-swap distribution.
            self._gov_last_win = getattr(w, "_telem_win_tick",
                                         win_tick)
            self._gov_hist_mark = None
            # the resolved kernel key follows the swap (incident
            # context + the recommendation log line read it)
            self._kernel_key = ",".join(
                f"{k}={v}" for k, v in sorted(
                    devprof.grid_config_key(w.cfg.grid).items()))
            logger.info(
                "[game%d] governor swap %s -> %s (%s); resolved %s",
                self.world.game_id, ev["from"], ev["to"],
                ev["reason"], self._kernel_key,
            )
        return ev

    def _flightrec_frame(self, dur_s: float, gov_ev=None) -> None:
        """One correlated flight-recorder frame per tick: measured tick
        wall time vs this process's budget, ladder stage, AOI oracle
        gauges and event volumes (all host-resident already — zero
        device traffic), plus the workload-signature class string on
        its refresh cadence. A signature class change stamps the
        ``[gameN]`` kernel-config recommendation line — the exact input
        ROADMAP item 2's governor will consume (recommend, not swap)."""
        w = self.world
        st = getattr(w, "op_stats", None) or {}
        tick = getattr(w, "tick_count", 0)
        frame = {
            "tick": tick,
            "tick_ms": round(dur_s * 1e3, 3),
            "budget_ms": round(self.tick_interval * 1e3, 3),
            "stage": self.overload.state_name,
            "over_k": int(st.get("aoi_over_k_rows", 0)),
            "over_cap": int(st.get("aoi_over_cap_cells", 0)),
            "enter": int(st.get("aoi_enter_events", 0)),
            "leave": int(st.get("aoi_leave_events", 0)),
            "backlog": float(self._m_backlog.value),
        }
        if gov_ev is not None:
            # fires the flight recorder's governor_swap trigger: the
            # decision context (signature, from/to, reason, regret
            # numbers) freezes into the incident bundle
            frame["governor"] = (
                f"{gov_ev['from']}->{gov_ev['to']} ({gov_ev['reason']})"
            )
        ap = getattr(w, "audit", None)
        if ap is not None:
            # each recorded violation fires the audit_violation trigger
            # at most once: the ledger tail + cohort diff freeze with
            # the bundle (utils/flightrec.py)
            av = ap.take_violation()
            if av is not None:
                frame["audit_violation"] = av
        if self.rebalance_agent is not None:
            # each terminal handoff transition (start/done/abort) fires
            # the rebalance_action trigger at most once
            ra = self.rebalance_agent.take_action_note()
            if ra is not None:
                frame["rebalance"] = ra
        rt = getattr(w, "residency", None)
        if rt is not None and tick % self.RESIDENCY_WIN_TICKS == 0:
            # windowed bubble verdict on a cadence: the p99 of the host
            # bubble over the ticks since the previous window, vs the
            # tracker's budget — fires the residency_regression trigger
            p99, n_win = rt.window_verdict()
            if p99 is not None and n_win > 0:
                frame["residency_bubble_p99_ms"] = (
                    "inf" if p99 == float("inf") else round(p99, 3))
                frame["residency_bubble_budget_ms"] = rt.bubble_budget_ms
                frame["residency_window"] = n_win
        if getattr(w, "telemetry_live", False) \
                and tick % self.SIG_LOG_TICKS == 0:
            sig = w.workload_signature()
            if sig and "sig" in sig:
                frame["signature"] = sig["sig"]
                if sig["sig"] != self._last_sig:
                    self._last_sig = sig["sig"]
                    rec = " ".join(
                        f"{k}={v}" for k, v in
                        sig.get("recommendation", {}).items())
                    logger.info(
                        "[game%d] workload signature %s -> "
                        "recommend: %s (resolved %s)",
                        self.game_id, sig["sig"], rec or "none",
                        self._kernel_key,
                    )
        self.flightrec.record(frame)

    def _incident_context(self) -> dict:
        """Correlation payload attached to a frozen incident bundle
        (paid at freeze time only, never per tick): the resolved
        kernel config, ladder stage, the last sampled trace ids and
        the freshest workload signature."""
        ctx: dict = {
            "kernel_config": self._kernel_key,
            "overload": self.overload.state_name,
        }
        tail = tracing.recorder.tail(8)
        if tail:
            ctx["trace_ids"] = sorted({t[2] for t in tail})
        sig = self.world.workload_signature()
        if sig:
            ctx["workload_signature"] = sig
        ap = getattr(self.world, "audit", None)
        if ap is not None:
            # ledger event tail + oracle/probe stats: an
            # audit_violation incident answers "which EntityID, which
            # hook sequence" from the bundle alone
            ctx["audit"] = ap.incident_context()
        if self.governor is not None:
            # the governor's decision context, frozen with the bundle
            # (a governor_swap incident answers "why did it swap" from
            # the bundle alone)
            g = self.governor.snapshot()
            ctx["governor"] = {
                "current": g["current"],
                "pending": g["pending"],
                "swaps": g["swaps"][-8:],
                "decisions": g["policy"]["transitions"][-8:],
                "regret_guard": g["regret_guard"],
            }
        return ctx

    def _maybe_checkpoint(self) -> None:
        """Periodic crash-recovery snapshot (``checkpoint_interval`` ini
        knob): keeps a restorable file fresh so a crashed game can be
        restarted ``-restore`` without losing the world since the last
        reload. The snapshot is asynchronous
        (``freeze.checkpoint_async``: the tick loop keeps running through
        the device fetch + file write); with ``snapshot_keyframe_every``
        the delta chain rides the replication worker instead. Multihost
        groups snapshot SYNCHRONOUSLY at the tick the leader's verdict
        reaches every rank through the mutation exchange: the snapshot's
        device fetch is a collective every rank must reach at the same
        tick; all ranks pack the identical global snapshot, the leader
        writes."""
        if self.checkpoint_interval <= 0 or self.run_state != "running":
            return
        from goworld_tpu_torch import freeze as _freeze

        w = self.world
        if w._multihost:
            if not self._mh_ckpt_due:
                return
            self._mh_ckpt_due = False
            self._last_ckpt_mono = time.monotonic()
            data = _freeze.freeze_world(w, run_hooks=False)
            if not self._mh_follower():
                _freeze.write_freeze_file(
                    os.path.join(self.freeze_dir,
                                 _freeze.checkpoint_filename(w.game_id)),
                    data)
            return
        now = time.monotonic()
        if now - self._last_ckpt_mono < self.checkpoint_interval \
                or getattr(w, "_ckpt_inflight", False):
            return
        self._last_ckpt_mono = now
        try:
            if getattr(w, "snapshot_keyframe_every", 0) > 0:
                # delta-compressed chain, routed through the bounded
                # replication worker: the tick thread stages one cheap
                # capture in _replication_pump; device fetch,
                # quantize/diff and the disk write run off-thread
                self._repl_disk_due = True
            else:
                _freeze.checkpoint_async(w, self.freeze_dir)
        except Exception:
            logger.exception("game%d: periodic checkpoint failed",
                             self.game_id)

    # ==================================================================
    # hot-standby replication (goworld_tpu_torch/replication/)
    # ==================================================================
    # standby re-subscribe cadence (serve-loop iterations) while
    # unattached or healing from a torn stream
    REPL_RESUB_TICKS = 64
    # longest a staged promotion waits for the dispatchers to report the
    # dead primary gone before it claims all the same
    PROMOTE_LEG_WAIT_S = 10.0

    def _ensure_repl_worker(self):
        if self.repl_worker is None:
            from goworld_tpu_torch import freeze as _freeze
            from goworld_tpu_torch.replication.worker import \
                ReplicationWorker

            w = self.world
            kf = (self.replication_keyframe_every
                  or getattr(w, "snapshot_keyframe_every", 0) or 8)
            self.repl_worker = ReplicationWorker(
                _freeze.SnapshotChain(w, self.freeze_dir,
                                      keyframe_every=kf),
                game_id=self.game_id,
                queue_max=self.replication_queue,
                send_fn=self._send_repl_frame,
            )
        return self.repl_worker

    def _replication_pump(self) -> None:
        """Tick-thread side of the chain/stream plane: ONE cheap
        host-record capture per due tick (device planes cloned on the
        tick's stream behind a recorded event, no host sync), handed to
        the bounded worker (the device fetch, quantize/diff, disk
        write and stream send all run off-thread). Queue full = the
        capture is dropped with a loud counter and the stream degrades
        to keyframe cadence — never the tick."""
        stream = bool(self._repl_subscribers)
        disk = self._repl_disk_due
        if not stream and not disk:
            return
        self._repl_disk_due = False
        try:
            # its own span (spans never nest): the capture's share of
            # the tick on the timeline
            with metrics.timeline.span("repl_capture"):
                worker = self._ensure_repl_worker()
                worker.submit(worker.chain.capture(),
                              to_disk=disk, to_stream=stream)
        except Exception:
            logger.exception("game%d: replication capture failed",
                             self.game_id)

    def _send_repl_frame(self, blob: bytes, kind: str,
                         tick: int) -> None:
        """Stream send (runs on the WORKER thread): one packet per
        subscriber, each pinned to a deterministic dispatcher leg so
        per-standby frame order is preserved end to end."""
        for sgid in sorted(self._repl_subscribers):
            conn = self.cluster.conns[sgid % len(self.cluster.conns)]
            self._send(conn,
                       proto.pack_replication_frame(sgid, self.game_id,
                                                    blob))

    def _standby_tick(self) -> None:
        """The standby's serve-loop body: keep the subscription alive
        (attach + torn-stream resync both re-request a keyframe) and
        drive a staged promotion claim on the logic thread."""
        if not self._standby_warmed:
            # pre-warm the tick ON the still-empty world: its first
            # tick builds and loads the kernels and warms the allocator
            # (shapes are capacity-static, so it is the same step the
            # promoted tick runs). Without it the first post-promotion
            # tick pays that cost — what hot standby exists to avoid.
            # Must run before the first frame applies: a tick would
            # ADVANCE a populated mirror past its primary. A served
            # standby holds its nil space by then (api.run creates it
            # first), which has no device row: the JAX package's
            # "no spaces" test skips the warm-up there (ROADMAP.md
            # Queue C14).
            self._standby_warmed = True
            w = self.world
            if all(e is w.nil_space for e in w.entities.values()):
                try:
                    self.world.tick()
                    self.world.tick_count = 0
                except Exception:
                    logger.exception(
                        "game%d: standby warmup tick failed",
                        self.game_id)
        self._drop_mirror_client_events()
        self._repl_resub -= 1
        dec = self._standby_applier.decoder
        if self._repl_resub <= 0 and (
                not self._repl_attached or dec.needs_keyframe):
            if self.cluster.conns:
                self._send(
                    self.cluster.conns[
                        self.game_id % len(self.cluster.conns)],
                    proto.pack_replication_subscribe(self.standby_of,
                                                     self.game_id))
            self._repl_resub = self.REPL_RESUB_TICKS
        while self._lost_legs:
            # a lost dispatcher drops the dead primary with its routes;
            # its reconnect's ack says afresh what it holds
            self._primary_online_legs.discard(self._lost_legs.popleft())
        if self._promote_pending is not None \
                and self._promote_claim is None:
            # a dispatcher drops a dead primary's routes when it reads
            # that connection to its end, which a backlog of the
            # primary's frames can delay past a claim: a census taken
            # before the drop is rejected whole and the drop then leaves
            # every id without a route, so the claim waits until every
            # dispatcher reported the primary gone, for at most
            # PROMOTE_LEG_WAIT_S. The JAX standby claims at once
            # (ROADMAP.md Queue C16).
            now = time.monotonic()
            if self._promote_waiting_since is None:
                self._promote_waiting_since = now
            waited = now - self._promote_waiting_since
            if self._primary_online_legs \
                    and waited < self.PROMOTE_LEG_WAIT_S:
                return
            if self._primary_online_legs:
                logger.warning(
                    "game%d: dispatcher legs %s still list game%d after "
                    "%.1f s; claiming its promotion anyway", self.game_id,
                    sorted(self._primary_online_legs), self.standby_of,
                    waited)
            self._promote_waiting_since = None
            self._claim_promotion()

    def _drop_mirror_client_events(self) -> None:
        """The primary serves the clients until promotion: what the
        mirror staged for them (the destroy of a mirrored entity bound
        to a client, a client binding's create) is dropped, never
        flushed at the promoted game's first tick — a client would
        read a stale destroy of an entity it already let go. The JAX
        package's standby flushes them (ROADMAP.md Queue C10)."""
        self._events_out.clear()
        self._events_trace.clear()
        self._sync_out.clear()

    def _request_promotion(self, epoch: int | None = None) -> dict:
        """Promotion hook installed on the standby tracker — reached
        from the debug-http thread (``/standby?promote=1``, the
        supervisor's poke). Only STAGES the request; the kvreg claim
        runs on the logic thread (_standby_tick). epoch None = derive
        from the last observed promotion round."""
        if self._standby_applier is None:
            return {"error": "not a standby"}
        if self._promoted:
            return {"status": "already_promoted",
                    "epoch": self._promote_epoch}
        if self._promote_pending is None:
            self._promote_pending = -1 if epoch is None else int(epoch)
        return {"status": "claiming", "epoch": self._promote_pending,
                "applied_tick":
                    self._standby_applier.decoder.applied_tick}

    def _claim_promotion(self) -> None:
        from goworld_tpu_torch.replication import promote as _promote

        key = _promote.claim_key(self.standby_of)
        epoch = self._promote_pending
        if epoch is None:
            return
        if epoch < 0:
            cur = _promote.parse_claim(self.kvreg.get(key, ""))
            epoch = (cur["epoch"] + 1) if cur else 1
        self._promote_epoch = int(epoch)
        dec = self._standby_applier.decoder
        self._promote_claim = _promote.claim_value(
            self.game_id, self._promote_epoch, dec.applied_seq)
        self._promote_log = _promote.DecisionLog()
        self._promote_log.note(
            "claim", key=key, value=self._promote_claim,
            applied_tick=dec.applied_tick,
            applied_seq=dec.applied_seq)
        self.kvreg_register(key, self._promote_claim)

    def _on_promotion_kvreg(self, key: str, val: str) -> None:
        """kvreg watcher (logic thread): adjudicate the dispatcher's
        broadcast for our promotion claim — first-writer-wins plus the
        epoch guard covering BOTH stale-replay orders
        (replication/promote.py)."""
        from goworld_tpu_torch.replication import promote as _promote

        if self._promote_claim is None or self._promoted \
                or key != _promote.claim_key(self.standby_of):
            return
        verdict = _promote.adjudicate(val, self._promote_claim)
        self._promote_log.note("adjudicate", winner=val,
                               mine=self._promote_claim,
                               verdict=verdict)
        if verdict == "won":
            self._finish_promotion()
        elif verdict == "stale_winner":
            # a replayed stale claim landed first: force-overwrite is
            # legitimate exactly and only now
            self._promote_log.note("force_reregister",
                                   value=self._promote_claim)
            self.kvreg_register(key, self._promote_claim, force=True)
        else:
            self._promote_log.note("stand_down", winner=val)
            self._write_promotion_log()
            self._promote_pending = None
            self._promote_claim = None

    def _finish_promotion(self) -> None:
        w = self.world
        dec = self._standby_applier.decoder
        # frames applied in this pump before the claim's broadcast
        # staged their mirror events after the last standby tick
        self._drop_mirror_client_events()
        self._promoted = True
        tick = max(int(dec.applied_tick), 0)
        # resume ticking FROM the last applied frame: staged mirror
        # state flushes into the device lanes on the first real tick
        # (the restore_world contract)
        w.tick_count = max(int(w.tick_count), tick)
        self.standby_tracker.note_promoted(self._promote_epoch, tick)
        self._promote_log.note(
            "promoted", epoch=self._promote_epoch, tick=tick,
            seq=dec.applied_seq,
            entities=len([e for e in w.entities.values()
                          if not e.destroyed]))
        self._write_promotion_log()
        # re-point the dispatcher's EntityID routing at this process: a
        # fresh census handshake over every leg (the dead primary's
        # routes dropped with its connection before the claim, so the
        # census claims them; conflicts come back as rejects). Clients
        # re-handshake through the same census path.
        census = list(w.entities.keys())
        for conn in self.cluster.conns:
            self._send(conn, proto.pack_set_game_id(
                self.game_id, is_reconnect=True, is_restore=True,
                ban_boot=self.ban_boot, entity_ids=census))
        if self.flightrec is not None:
            # fires the standby_promoted trigger: the promotion context
            # freezes into an incident bundle on OUR side (the dead
            # primary's ring froze at its crash)
            self.flightrec.record({
                "tick": tick,
                "standby_promoted": (
                    f"game{self.game_id} epoch {self._promote_epoch} "
                    f"seq {dec.applied_seq} tick {tick}"),
            })
        logger.warning(
            "game%d: PROMOTED to primary for game%d at epoch %d "
            "(frame seq %d, tick %d) — resuming ticking",
            self.game_id, self.standby_of, self._promote_epoch,
            dec.applied_seq, tick,
        )

    def _write_promotion_log(self) -> None:
        """Persist the byte-replayable decision log next to the
        snapshots (ops read and replay it after the fact)."""
        if self._promote_log is None:
            return
        try:
            with open(os.path.join(
                    self.freeze_dir,
                    f"game{self.game_id}_promotion.log"), "wb") as f:
                f.write(self._promote_log.dump())
        except OSError:
            logger.exception("game%d: promotion log write failed",
                             self.game_id)

    # ==================================================================
    # the multihost mutation log
    # ==================================================================
    # cap on raw mutation bytes shipped per controller per tick; the
    # surplus stays queued IN ORDER for the next tick (backpressure —
    # an unbounded all-gather payload would stall every controller)
    MH_LOG_BYTES_PER_TICK = 1 << 20

    def _mh_drain_pending(self) -> bytearray:
        blob = bytearray()
        import struct as _st

        taken = 0
        for mt, payload in self._mh_pending:
            if taken and len(blob) + 6 + len(payload) > \
                    self.MH_LOG_BYTES_PER_TICK:
                logger.warning(
                    "game%d: multihost mutation log full; deferring %d "
                    "packets to the next tick", self.game_id,
                    len(self._mh_pending) - taken,
                )
                break
            blob += _st.pack("<HI", mt, len(payload))
            blob += payload
            taken += 1
        del self._mh_pending[:taken]
        # backlog observability: the ordered carry-over keeps
        # correctness under overflow, but a backlog that GROWS tick over
        # tick means the cluster plane produces mutations faster than
        # 1 MB/controller/tick forever — surfaced as gauges (debug_http
        # /vars) + a rate-limited alarm, never silently
        backlog_b = sum(6 + len(p) for _, p in self._mh_pending)
        opmon.expose("mh_mutation_backlog_packets", len(self._mh_pending))
        opmon.expose("mh_mutation_backlog_bytes", backlog_b)
        _m_mh_backlog_pkts.set(len(self._mh_pending))
        _m_mh_backlog_bytes.set(backlog_b)
        self.world.op_stats["mh_mutation_backlog_bytes"] = backlog_b
        if self._mh_pending:
            self._mh_backlog_ticks += 1
            if self._mh_backlog_ticks >= 8 \
                    and self._mh_backlog_ticks % 64 == 8:
                # the alarm reports what the overload plane is actually
                # DOING about it (state + per-class sheds since the
                # last alarm interval)
                shed_now = overload.shed_snapshot()
                delta = {
                    k: v - self._shed_at_alarm.get(k, 0.0)
                    for k, v in shed_now.items()
                    if v > self._shed_at_alarm.get(k, 0.0)
                }
                self._shed_at_alarm = shed_now
                logger.warning(
                    "game%d: multihost mutation backlog sustained for "
                    "%d ticks (%d packets / %d bytes queued): the "
                    "cluster plane outruns MH_LOG_BYTES_PER_TICK "
                    "(%d B/tick) — overload state %s; shed last "
                    "interval: %s",
                    self.game_id, self._mh_backlog_ticks,
                    len(self._mh_pending), backlog_b,
                    self.MH_LOG_BYTES_PER_TICK,
                    self.overload.state_name,
                    delta or "nothing (raise the cap or add controllers)",
                )
        else:
            self._mh_backlog_ticks = 0
        return blob

    def _mh_exchange_mutations(self) -> None:
        """Multi-controller mutation exchange: all-gather every
        controller's queued World-mutating packets and replay the union
        in process order, so all controllers apply IDENTICAL mutations
        this tick no matter whose dispatcher connection a packet arrived
        on. Runs every tick on every controller (the collectives must
        pair up); the blocking all-gather also keeps the controllers'
        tick loops in lockstep — the host-plane counterpart of the
        device step's own collectives."""
        import struct as _st

        blob = self._mh_drain_pending()
        # (blob length, deployment-ready flag, game id, freeze
        # requested, checkpoint due): the extra fields ride the same
        # collective so every controller derives the SAME "whole group
        # is ready" fact, the SAME leader game id and the leader's
        # wall-clock checkpoint verdict at the same tick — wall-clock
        # facts differ per controller and must never gate SPMD
        # decisions directly
        ckpt_due = int(
            not self._mh_follower()
            and self.checkpoint_interval > 0
            and self.run_state == "running"
            and time.monotonic() - self._last_ckpt_mono
            >= self.checkpoint_interval
        )
        group = self.world._mh_group
        meta = group.all_gather(torch.tensor(
            [len(blob), int(self.deployment_ready), self.game_id,
             int(self._mh_freeze_requested), ckpt_due],
            dtype=torch.int64)).numpy()
        self._mh_ckpt_due = bool(meta[:, 4].any())
        self.world.mh_group_ready = self._mh_all_ready = \
            bool(meta[:, 1].all())
        self._mh_leader_game_id = int(meta[0, 2])
        if meta[:, 3].any() and self.run_state == "running":
            # coordinated freeze: every controller learns the fact from
            # the SAME collective, so all of them run _do_freeze after
            # this very tick and the freeze_world snapshot's own
            # collectives pair up
            self.run_state = "freezing"
        lengths = meta[:, 0]
        width = int(lengths.max())
        if width == 0:
            return
        padded = np.zeros(width, np.uint8)
        if blob:
            padded[: len(blob)] = np.frombuffer(bytes(blob), np.uint8)
        all_blobs = group.all_gather(torch.from_numpy(padded)).numpy()
        self._mh_replaying = True
        try:
            for pid in range(all_blobs.shape[0]):
                data = all_blobs[pid].tobytes()[: int(lengths[pid])]
                off = 0
                while off + 6 <= len(data):
                    mt, ln = _st.unpack_from("<HI", data, off)
                    off += 6
                    try:
                        self._handle_packet(
                            -1, mt, Packet(data[off:off + ln])
                        )
                    except Exception:
                        logger.exception(
                            "game%d: multihost replay of msgtype %d "
                            "failed", self.game_id, mt,
                        )
                    off += ln
        finally:
            self._mh_replaying = False

    # ==================================================================
    # networking thread side
    # ==================================================================
    async def _handshake(self, conn: DispatcherConn) -> None:
        # multihost followers register NO entities: the leader alone
        # represents the shared World in the dispatcher's entity table
        # (eid-routed packets then reach exactly one controller and are
        # replicated from there via _mh_exchange_mutations)
        # an UNPROMOTED standby registers NO entities (its mirror copies
        # belong to the live primary — claiming them would fork routing)
        # and is never boot-eligible; promotion re-handshakes with the
        # real census (_finish_promotion)
        is_standby = (self._standby_applier is not None
                      and not self._promoted)
        p = proto.pack_set_game_id(
            self.game_id, is_reconnect=self.deployment_ready,
            is_restore=self._is_restore,
            ban_boot=self.ban_boot or is_standby,
            entity_ids=([] if self._mh_follower() or is_standby
                        else list(self.world.entities.keys())),
        )
        conn.conn.send(p)
        await conn.conn.drain()

    def _on_packet_netthread(self, didx: int, msgtype: int,
                             pkt: Packet) -> None:
        cls = overload.classify(msgtype)
        if self.overload_enabled and self.overload.should_shed(cls):
            # SHEDDING/REJECTING: the cheapest classes are dropped at
            # ingress, before any logic-thread work; every drop counted
            overload.shed_counter(cls, "game_ingress").inc()
            return
        if not self._packet_q.offer(cls, (didx, msgtype, pkt)):
            # class queue full (offer counted the shed); the old
            # aggregate drop counter keeps its series alive
            self._m_pkt_drop.inc()
            if int(self._m_pkt_drop.value) % 1024 == 1:
                logger.error(
                    "game%d: %s input queue full; dropping msgtype %d "
                    "(counted in shed_total)", self.game_id,
                    overload.CLASS_NAMES[cls], msgtype,
                )

    def _send(self, conn: DispatcherConn, p: Packet) -> None:
        """Thread-safe send from the logic thread."""
        if self._loop is None:
            conn.send(p)
            return
        try:
            self._loop.call_soon_threadsafe(conn.send, p)
        except RuntimeError:
            # loop closed mid-stop (SIGTERM lands between ticks): the
            # interrupted serve iteration must still unwind to the
            # hard-exit path, not die on a send
            pass

    # ==================================================================
    # world -> cluster edges (logic thread)
    # ==================================================================
    def _client_sink(self, gate_id: int, client_id: str, msg: dict) -> None:
        t = msg["type"]
        if t == "create_entity":
            p = proto.pack_create_entity_on_client(
                gate_id, client_id, msg["eid"], msg["etype"],
                msg["is_player"], msg["attrs"], msg["pos"], msg["yaw"],
            )
        elif t == "destroy_entity":
            p = proto.pack_destroy_entity_on_client(
                gate_id, client_id, msg["eid"], msg["is_player"]
            )
        elif t == "attrs":
            p = proto.pack_notify_attr_change_on_client(
                gate_id, client_id, msg["eid"], msg["deltas"]
            )
        elif t == "rpc":
            p = proto.pack_call_entity_method_on_client(
                gate_id, client_id, msg["eid"], msg["method"],
                tuple(msg["args"]),
            )
        elif t == "filter_prop":
            # gate-service message (mutates the gate's FilterIndex, no
            # client relay) — not part of the per-client event stream
            p = proto.pack_set_client_filter_prop(
                gate_id, client_id, msg["key"], msg["val"]
            )
            self._send(self.cluster.select_by_gate_id(gate_id), p)
            return
        elif t == "sync":
            self._sync_out.setdefault(gate_id, []).append(
                (client_id, msg["eid"],
                 (*msg["pos"], msg["yaw"]))
            )
            return
        else:
            logger.warning("game%d: unknown client msg type %r",
                           self.game_id, t)
            return
        # Stage into the per-gate per-tick bundle instead of sending a
        # dispatcher packet per message: a churn-heavy AOI tick emits
        # thousands of create/destroy/attr messages and per-message
        # framing through two hops dominated the gate leg. The record
        # body is the packed message minus its [u16 msgtype][u16
        # gate_id] prefix — byte-identical to what the gate's relay
        # forwards to the client. (buf layout: new_packet wrote the
        # u16 msgtype first, the pack_* helper the u16 gate_id next.)
        mt = int.from_bytes(bytes(p.buf[0:2]), "little")
        self._events_out.setdefault(gate_id, []).append(
            (mt, bytes(memoryview(p.buf)[4:]))
        )
        if tracing.active:
            # remember the emitting span so the flushed bundle carries
            # it (records are raw bytes; last traced emitter wins)
            ctx = tracing.current()
            if ctx is not None:
                self._events_trace[gate_id] = ctx
        # the packed message was copied into the record — return the
        # pooled packet (the per-message path's _send released it)
        p.release()

    def _sync_sink(self, gate_id: int, cids: list, eids: list,
                   vals: np.ndarray) -> None:
        self._sync_out.setdefault(gate_id, []).append((cids, eids, vals))

    _EVENT_BATCH_BYTES = 4 * 1024 * 1024  # chunk bound, well under the
                                          # 32M packet cap

    def _flush_events_out(self) -> None:
        """Put the staged per-gate client event bundles on the wire.
        Called from the per-tick flush, and EAGERLY by any send whose
        gate-side handling depends on the staged events having been
        applied (e.g. a filtered broadcast resolving cp.owner_eid set
        by a staged create_entity)."""
        for gate_id, recs in self._events_out.items():
            if not recs:
                continue
            # accumulated across eager mid-tick flushes; exposed (and
            # zeroed) once per tick by _flush_sync_out
            self._event_recs_flushed += len(recs)
            conn = self.cluster.select_by_gate_id(gate_id)
            trace_ctx = self._events_trace.pop(gate_id, None)
            chunk: list = []
            size = 0
            for rec in recs:
                chunk.append(rec)
                size += 6 + len(rec[1])
                if size >= self._EVENT_BATCH_BYTES:
                    p = proto.pack_client_events_batch(gate_id, chunk)
                    p.trace = trace_ctx
                    self._send(conn, p)
                    chunk, size = [], 0
            if chunk:
                p = proto.pack_client_events_batch(gate_id, chunk)
                p.trace = trace_ctx
                self._send(conn, p)
        self._events_out.clear()

    def _flush_sync_out(self, force: bool = False) -> None:
        self._fanout_tick += 1
        if (not force and self.overload_enabled
                and self.overload.state >= overload.DEGRADED
                and self.degraded_event_coalesce > 1
                and self._fanout_tick % self.degraded_event_coalesce):
            # DEGRADED batch coalescing: hold this tick's staged events
            # AND syncs (held together so a staged create still
            # precedes its entity's first sync) and flush them with the
            # next tick's — half the downstream packets at twice the
            # batch size. Eager mid-tick event flushes (filtered
            # broadcasts) still happen; freeze passes force=True.
            return
        # client event bundles FIRST: a create_entity staged this tick
        # must reach the client before the same entity's first position
        # sync record (flushed below)
        self._flush_events_out()
        # per-tick total (incl. eager mid-tick flushes), exposed
        # unconditionally so idle ticks read 0, like the mh_* gauges
        opmon.expose("client_event_batch_records",
                     self._event_recs_flushed)
        if self._event_recs_flushed:
            self._m_event_records.inc(self._event_recs_flushed)
        self._event_recs_flushed = 0
        # sync-age stamp base for this flush: the world's device-tick
        # anchor (epoch seq + tick-start + fetch instants) plus the
        # flush-start instant closing the drain_decode lane. One
        # time.time() per flush + 45 B per gate packet — the always-on
        # budget (utils/syncage.py; bench stamps the measured overhead)
        age_anchor = (
            getattr(self.world, "sync_age_anchor", None)
            if self.sync_age else None
        )
        t_stage_us = syncage.now_us() if age_anchor is not None else 0
        for gate_id, chunks in self._sync_out.items():
            # per-chunk ARRAYS concatenated once — never element-wise
            # Python appends (the world's mirror path hands us S16
            # batches; decomposing them would reintroduce the per-record
            # cost that path exists to remove)
            cids: list = []
            eids: list = []
            vals: list = []
            for c in chunks:
                if isinstance(c[0], (list, np.ndarray)):
                    if len(c[0]) == 0:
                        continue
                    cids.append(np.asarray(c[0], "S16"))
                    eids.append(np.asarray(c[1], "S16"))
                    vals.append(
                        np.asarray(c[2], np.float32).reshape(-1, 4)
                    )
                else:                        # single legacy record
                    cids.append(np.asarray([c[0]], "S16"))
                    eids.append(np.asarray([c[1]], "S16"))
                    vals.append(
                        np.asarray(c[2], np.float32).reshape(1, 4)
                    )
            if not cids:
                continue
            cid_b = np.concatenate(cids) if len(cids) > 1 else cids[0]
            eid_b = np.concatenate(eids) if len(eids) > 1 else eids[0]
            val_b = np.concatenate(vals) if len(vals) > 1 else vals[0]
            if self.sync_delta:
                # delta-compressed leg: int16 deltas against
                # per-(client, entity) baselines with in-band keyframes
                # — the gate's DeltaSyncDecoder reconstructs
                # bit-deterministically and relays the same records
                enc = self._sync_encoder(gate_id)
                p = new_packet(
                    proto.MT_SYNC_POSITION_YAW_DELTA_ON_CLIENTS)
                p.append_u16(gate_id)
                # sender id: every game runs its OWN handle space, and
                # a gate fans in from many games — the decoder keys its
                # state per sender so handles can never collide
                p.append_u16(self.game_id & 0xFFFF)
                p.append_bytes(enc.encode_batch(
                    cid_b, eid_b, val_b, self._fanout_tick))
            else:
                p = new_packet(proto.MT_SYNC_POSITION_YAW_ON_CLIENTS)
                p.append_u16(gate_id)
                body = codec.encode_client_sync_batch(cid_b, eid_b,
                                                      val_b)
                p.append_bytes(body)
                self._m_sync_bytes["full"].inc(len(body))
            if age_anchor is not None:
                p.age = syncage.SyncAgeStamp(
                    age_anchor[0], age_anchor[1], age_anchor[2],
                    t_stage_us, syncage.now_us())
            self._send(self.cluster.select_by_gate_id(gate_id), p)
        if self.sync_delta and self._sync_encoders:
            # byte-saving gauges (scraped next to the SLO line) —
            # summed across ALL per-gate encoders, exposed once, so a
            # multi-gate deployment never reports just the last gate
            opmon.expose("sync_delta_wire_bytes", sum(
                e.stats["wire_bytes"]
                for e in self._sync_encoders.values()))
            opmon.expose("sync_delta_full_bytes", sum(
                e.stats["full_bytes"]
                for e in self._sync_encoders.values()))
            # keyframe vs delta wire bytes split into their own series
            # (sync_bytes_out{kind}): the old single wire-bytes gauge
            # hid which mode the bytes travelled as — the age plane
            # correlates staleness against exactly this split
            for kind in ("keyframe", "delta"):
                total = sum(e.stats[f"{kind}_bytes"]
                            for e in self._sync_encoders.values())
                d = total - self._sync_bytes_mark[kind]
                if d > 0:
                    self._m_sync_bytes[kind].inc(d)
                self._sync_bytes_mark[kind] = total
        self._sync_out.clear()

    def _sync_encoder(self, gate_id: int) -> "codec.DeltaSyncEncoder":
        enc = self._sync_encoders.get(gate_id)
        if enc is None:
            # the step IS the world's precision lattice step (GridSpec.
            # quant_step is defined for every grid — precision=q16
            # worlds ship exact lattice deltas, f32 worlds get the same
            # power-of-two step as a sub-resolution wire quantization)
            grid = self.world.cfg.grid
            enc = self._sync_encoders[gate_id] = codec.DeltaSyncEncoder(
                grid.quant_step,
                keyframe_every=self.sync_keyframe_every,
            )
        return enc

    def _remote_call(self, eid: str, method: str, args: tuple,
                     from_client: str | None) -> None:
        if self._mh_follower():
            return  # SPMD-replicated call; the leader sends it once
        p = proto.pack_call_entity_method(eid, method, args, from_client)
        self._send(self.cluster.select_by_entity_id(eid), p)

    def _filtered_sink(self, key: str, op: str, val: str, method: str,
                       args: tuple) -> None:
        if self._mh_follower():
            return
        # a filtered RPC is addressed on the gate via cp.owner_eid,
        # which a create_entity staged THIS tick may set — flush the
        # event bundles first so the broadcast observes them in order
        # (the per-message path sent everything in emission order)
        self._flush_events_out()
        p = proto.pack_call_filtered_clients(key, op, val, "", method, args)
        self._send(self.cluster.conns[0], p)

    def _mh_follower(self) -> bool:
        """True on non-leader controllers of a multihost World. Cluster
        messages originated by SPMD-replicated host code (entity
        registration, anywhere-placement, filtered broadcasts) would be
        sent once per controller; only the leader (rank 0) puts them on
        the wire. Client-bound traffic is NOT gated here — it is deduped
        per-entity by World.client_emit_ok (the shard owner emits)."""
        return self.world._multihost and self.world.mh_rank != 0

    def _notify_entity_created(self, e: Entity) -> None:
        if self._mh_follower():
            return  # the leader alone owns the dispatcher entity table
        p = new_packet(proto.MT_NOTIFY_CREATE_ENTITY)
        p.append_entity_id(e.id)
        p.append_u16(self.game_id)
        self._send(self.cluster.select_by_entity_id(e.id), p)

    def _notify_entity_destroyed(self, e: Entity) -> None:
        if self._mh_follower():
            return
        p = new_packet(proto.MT_NOTIFY_DESTROY_ENTITY)
        p.append_entity_id(e.id)
        self._send(self.cluster.select_by_entity_id(e.id), p)

    # -- public cluster-wide API (the goworld.go facade calls these) ----
    def create_entity_anywhere(self, type_name: str,
                               attrs: dict | None = None,
                               gameid: int = 0) -> None:
        """Reference ``CreateEntityAnywhere`` (``goworld.go``): placement
        decided by the dispatcher's load heap; nonzero ``gameid`` pins
        the target (``CreateEntityOnGame`` / ``CreateSpaceOnGame``)."""
        from goworld_tpu_torch.utils import ids as _ids

        if self._mh_follower():
            return  # replicated caller; leader alone requests placement
        eid = _ids.gen_entity_id()
        p = proto.pack_create_entity_anywhere(type_name, attrs or {}, eid,
                                              gameid)
        self._send(self.cluster.select_by_entity_id(eid), p)

    def load_entity_anywhere(self, type_name: str, eid: str,
                             gameid: int = 0) -> None:
        if self._mh_follower():
            return
        p = proto.pack_load_entity_anywhere(type_name, eid, gameid)
        self._send(self.cluster.select_by_entity_id(eid), p)

    def kvreg_register(self, key: str, val: str, force: bool = False) -> None:
        if self._mh_follower():
            return  # the leader writes once on the whole group's behalf
        p = proto.pack_kvreg_register(key, val, force)
        self._send(self.cluster.select_by_srv_id(key), p)

    def kvreg_traverse(self, prefix: str, cb) -> None:
        """Walk the local kvreg mirror by key prefix (reference
        ``kvreg.TraverseByPrefix``, ``kvreg.go:23``)."""
        for k, v in sorted(self.kvreg.items()):
            if k.startswith(prefix):
                cb(k, v)

    def setup_services(self) -> "object":
        """Attach a kvreg-backed ServiceManager (reference ``service.Setup``,
        started on deployment-ready)."""
        from goworld_tpu_torch.entity.service import ServiceManager

        return ServiceManager(
            self.world, game_id=self.game_id,
            kv_write=lambda k, v: self.kvreg_register(k, v),
            kv_get=self.kvreg.get,
            # multihost: the whole controller group claims shards as ONE
            # entity under the LEADER's game id (all-gathered each tick —
            # unique per group, unlike World.game_id which defaults to 1)
            claim_token=(
                (lambda: f"mh:{self._mh_leader_game_id}")
                if self.world._multihost else None
            ),
        )

    def call_nil_spaces(self, method: str, *args) -> None:
        if self._mh_follower():
            return
        p = proto.pack_call_nil_spaces(method, args)
        self._send(self.cluster.conns[0], p)

    # ==================================================================
    # migration, outbound (reference Entity.go:1006-1101)
    # ==================================================================
    def _remote_enter_space(self, e: Entity, space_id: str,
                            pos: tuple) -> None:
        self._migrating_out[e.id] = (e, space_id, pos)
        if tracing.active and tracing.current() is None:
            # migration not already under a traced RPC: root its own
            # trace (sampled at the same rate) so the whole protocol —
            # QUERY_SPACE_GAMEID -> MIGRATE_REQUEST -> REAL_MIGRATE,
            # acks included — appears as ONE causally-linked trace; the
            # chain continues automatically because every ack comes
            # back traced and re-enters the handle/route hops
            root = tracing.maybe_sample()
            if root is not None:
                with tracing.root("migrate_out", f"game{self.game_id}",
                                  root, eid=e.id, space=space_id):
                    p = proto.pack_query_space_gameid(space_id, e.id)
                    self._send(
                        self.cluster.select_by_entity_id(space_id), p)
                return
        p = proto.pack_query_space_gameid(space_id, e.id)
        self._send(self.cluster.select_by_entity_id(space_id), p)

    # ==================================================================
    # cluster -> world packet handlers (logic thread)
    # ==================================================================
    def _handle_packet(self, didx: int, msgtype: int, pkt: Packet) -> None:
        ctx = pkt.trace
        if ctx is not None and ctx.sampled:
            # one handle span per traced inbound packet, parented to the
            # sender's span; installing it as current makes every
            # outbound packet the handler creates (entity RPC forwards,
            # migration acks, staged client events) carry OUR span
            with tracing.hop("handle", f"game{self.game_id}", ctx,
                             msgtype=msgtype) as my:
                pkt.trace = my
                return self._handle_packet_body(didx, msgtype, pkt)
        return self._handle_packet_body(didx, msgtype, pkt)

    def _handle_packet_body(self, didx: int, msgtype: int,
                            pkt: Packet) -> None:
        w = self.world
        if w._multihost and not self._mh_replaying \
                and msgtype in _MH_WORLD_MSGTYPES:
            if msgtype in _MH_BROADCAST_MSGTYPES \
                    and self._mh_follower():
                return  # broadcast copy; the leader's is the one logged
            # defer to the per-tick all-gather so every controller
            # applies this mutation, in the same order, in the same tick
            self._mh_pending.append(
                (msgtype, bytes(memoryview(pkt.buf)[pkt.rpos:]))
            )
            return
        if msgtype == proto.MT_SET_GAME_ID_ACK:
            disp_id = pkt.read_u16()
            self.handshake_acks.add(disp_id)
            kv = pkt.read_data()
            rejects = pkt.read_data()
            online = pkt.read_data()
            self.online_games.update(online)
            if self.standby_of and self.standby_of in online:
                self._primary_online_legs.add(didx)
            else:
                # a dispatcher that (re)connected without the primary
                self._primary_online_legs.discard(didx)
            self.kvreg.update(kv)
            for eid in rejects:
                e = w.entities.get(eid)
                if e is not None:
                    logger.warning(
                        "game%d: entity %s rejected by dispatcher; "
                        "destroying stale copy", self.game_id, eid,
                    )
                    # the live copy elsewhere keeps its client, storage
                    # and route (ROADMAP.md Queue C16)
                    w.destroy_entity(e, stale=True)
            return
        if msgtype == proto.MT_NOTIFY_DEPLOYMENT_READY:
            if not self.deployment_ready:
                self.deployment_ready = True
                # reference exposes this via gwvar/expvar (gwvar.go:1-29)
                opmon.expose("IsDeploymentReady", True)
                self.ready_event.set()
                for sp in list(w.spaces.values()):
                    sp.OnGameReady()
                if w.service_mgr is not None:
                    # reference service.OnDeploymentReady -> checkServices
                    w.service_mgr.start()
                if self.on_deployment_ready is not None:
                    self.on_deployment_ready()
            return
        if msgtype == proto.MT_CALL_ENTITY_METHOD:
            eid = pkt.read_entity_id()
            method = pkt.read_var_str()
            args = pkt.read_args()
            e = w.entities.get(eid)
            if e is not None:
                w._invoke(e, method, tuple(args), None)
            else:
                logger.warning("game%d: RPC to unknown entity %s.%s",
                               self.game_id, eid, method)
            return
        if msgtype == proto.MT_CALL_ENTITY_METHOD_FROM_CLIENT:
            eid = pkt.read_entity_id()
            client_id = pkt.read_entity_id()
            method = pkt.read_var_str()
            args = pkt.read_args()
            e = w.entities.get(eid)
            if e is not None:
                w._invoke(e, method, tuple(args), client_id)
            return
        if msgtype == proto.MT_NOTIFY_CLIENT_CONNECTED:
            boot_eid = pkt.read_entity_id()
            client_id = pkt.read_entity_id()
            gate_id = pkt.read_u16()
            w.create_entity(
                self.boot_entity, eid=boot_eid,
                client=GameClient(gate_id, client_id, w),
            )
            return
        if msgtype == proto.MT_NOTIFY_CLIENT_DISCONNECTED:
            client_id = pkt.read_entity_id()
            owner = pkt.read_var_str()
            if self.sync_delta:
                # forget the departed client's delta-sync baselines
                # (its pairs simply re-keyframe if it reconnects;
                # bounds encoder state without waiting for the
                # max_entries hard reset)
                for enc in self._sync_encoders.values():
                    enc.drop_client(client_id)
            targets = (
                [w.entities.get(owner)] if owner else list(w.entities.values())
            )
            for e in targets:
                if e is not None and e.client is not None \
                        and e.client.client_id == client_id:
                    e.client = None  # connection already gone: quiet unbind
                    w._mirror_client(e)
                    if e.slot is not None and e.shard is not None:
                        w._staged_client.append(
                            (e.shard, e.slot, False, -1)
                        )
                    e.OnClientDisconnected()
            return
        if msgtype == proto.MT_SYNC_POSITION_YAW_FROM_CLIENT:
            eids, vals = codec.decode_sync_batch(
                memoryview(pkt.buf)[pkt.rpos:]
            )
            # vectorized: one searchsorted resolves the whole batch to
            # (shard, slot) rows; no per-record Python (the host wall at
            # 10K+ clients — reference decodes per record in Go,
            # GameService.go:395-407)
            w.stage_pos_sync_batch(eids, vals)
            return
        if msgtype == proto.MT_CREATE_ENTITY_ANYWHERE:
            pkt.read_u16()  # routing gameid (consumed by the dispatcher)
            type_name = pkt.read_var_str()
            eid = pkt.read_var_str()
            attrs = pkt.read_data()
            desc = (w.registry.get(type_name)
                    if type_name in w.registry else None)
            if desc is not None and desc.is_space:
                # CreateSpaceAnywhere rides the same placement path
                # (reference goworld.go CreateSpaceAnywhere); attrs go
                # as a dict, never as kwargs (wire attr names may
                # collide with parameter names)
                w.create_space(type_name, attrs=attrs, eid=eid or None)
            else:
                w.create_entity(type_name, eid=eid or None, attrs=attrs)
            return
        if msgtype == proto.MT_LOAD_ENTITY_ANYWHERE:
            pkt.read_u16()  # routing gameid
            type_name = pkt.read_var_str()
            eid = pkt.read_entity_id()
            w.load_entity(type_name, eid)
            return
        if msgtype == proto.MT_KVREG_REGISTER:
            key = pkt.read_var_str()
            val = pkt.read_var_str()
            pkt.read_bool()
            self.kvreg[key] = val
            for cb in self.kvreg_watchers:
                cb(key, val)
            return
        if msgtype == proto.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK:
            self._h_query_space_ack(pkt)
            return
        if msgtype == proto.MT_MIGRATE_REQUEST_ACK:
            self._h_migrate_request_ack(pkt)
            return
        if msgtype == proto.MT_REAL_MIGRATE:
            self._h_real_migrate(pkt)
            return
        if msgtype == proto.MT_CALL_NIL_SPACES:
            method = pkt.read_var_str()
            args = pkt.read_args()
            if w.nil_space is not None:
                w._invoke(w.nil_space, method, tuple(args), None)
            return
        if msgtype == proto.MT_START_FREEZE_GAME_ACK:
            disp_id = pkt.read_u16()
            self._freeze_acks.add(disp_id)
            if len(self._freeze_acks) >= len(self.cluster.conns) \
                    and self.run_state == "running":
                # every dispatcher is now blocking us: safe to snapshot
                if w._multihost:
                    # spread the decision through the NEXT exchange so
                    # the whole controller group freezes at one tick
                    self._mh_freeze_requested = True
                else:
                    self.run_state = "freezing"
            return
        if msgtype == proto.MT_NOTIFY_GAME_CONNECTED:
            back = pkt.read_u16()
            self.online_games.add(back)
            if self.standby_of and back == self.standby_of:
                self._primary_online_legs.add(didx)
            return
        if msgtype == proto.MT_NOTIFY_GAME_DISCONNECTED:
            gone = pkt.read_u16()
            self.online_games.discard(gone)
            if self.standby_of and gone == self.standby_of:
                self._primary_online_legs.discard(didx)
            return
        if msgtype == proto.MT_REPLICATION_SUBSCRIBE:
            pkt.read_u16()  # routing target (this game)
            sgid = pkt.read_u16()
            self._repl_subscribers.add(sgid)
            try:
                # attach (and torn-stream resync) always restarts the
                # standby from a self-contained frame
                self._ensure_repl_worker().request_keyframe()
            except Exception:
                logger.exception(
                    "game%d: replication subscribe from game%d failed",
                    self.game_id, sgid)
            return
        if msgtype == proto.MT_REPLICATION_FRAME:
            pkt.read_u16()  # routing target (this game)
            pgid = pkt.read_u16()
            blob = pkt.read_bytes(pkt.read_u32())
            if (self._standby_applier is None or self._promoted
                    or pgid != self.standby_of):
                # a frame for a role we no longer (or never) hold — a
                # zombie primary streaming at a promoted standby lands
                # here, counted, never applied
                self._repl_late_frames += 1
                return
            self._repl_attached = True
            self._standby_applier.apply(blob)
            return
        if msgtype == proto.MT_NOTIFY_GATE_DISCONNECTED:
            gate_id = pkt.read_u16()
            for e in list(w.entities.values()):
                if e.client is not None and e.client.gate_id == gate_id:
                    e.client = None
                    w._mirror_client(e)
                    if e.slot is not None and e.shard is not None:
                        w._staged_client.append(
                            (e.shard, e.slot, False, -1)
                        )
                    e.OnClientDisconnected()
            return
        logger.warning("game%d: unhandled msgtype %d", self.game_id, msgtype)

    # -- migration handlers ---------------------------------------------
    def _h_query_space_ack(self, pkt: Packet) -> None:
        space_id = pkt.read_entity_id()
        eid = pkt.read_entity_id()
        game_id = pkt.read_u16()
        pending = self._migrating_out.get(eid)
        if pending is None:
            return
        e, want_space, _pos = pending
        if want_space != space_id:
            return
        if game_id == 0:
            logger.warning(
                "game%d: space %s not found for migration of %s",
                self.game_id, space_id, eid,
            )
            del self._migrating_out[eid]
            return
        if e.destroyed:
            del self._migrating_out[eid]
            return
        p = proto.pack_migrate_request(eid, space_id, game_id)
        self._send(self.cluster.select_by_entity_id(eid), p)

    def _h_migrate_request_ack(self, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        space_id = pkt.read_entity_id()
        game_id = pkt.read_u16()
        pending = self._migrating_out.pop(eid, None)
        if pending is None:
            return
        e, _space, pos = pending
        if e.destroyed:
            self._send(
                self.cluster.select_by_entity_id(eid),
                proto.pack_cancel_migrate(eid),
            )
            return
        data = self.world.get_migrate_data(e)
        data["space_id"] = space_id
        data["pos"] = list(pos)
        # target stamped into the ledger's in-flight record: the
        # conservation verdict and the /audit plane can then name
        # WHERE an unmatched out-record was headed
        self.world.remove_for_migration(e, target=game_id)
        p = proto.pack_real_migrate(eid, game_id, data)
        self._send(self.cluster.select_by_entity_id(eid), p)

    def _h_real_migrate(self, pkt: Packet) -> None:
        eid = pkt.read_entity_id()
        pkt.read_u16()  # target game (us)
        data = pkt.read_data()
        space = self.world.spaces.get(data.get("space_id", ""))
        if space is None:
            logger.warning(
                "game%d: migrate-in %s: space %s vanished; entering nil "
                "space", self.game_id, eid, data.get("space_id"),
            )
        self.world.restore_from_migration(data, space=space)
