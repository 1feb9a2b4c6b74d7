"""Cluster configuration — one INI file shared by every process.

Reference being rebuilt: ``engine/config`` (``read_config.go:40-118,238-330``
and ``goworld.ini.sample``): a single ``goworld.ini`` read by dispatcher,
game and gate processes alike, with ``[deployment]`` desired process counts
(the readiness barrier), numbered sections ``[dispatcherN]``/``[gameN]``/
``[gateN]``, and ``*_common`` sections providing inherited defaults.

TPU additions live in the game sections: per-space device capacity, AOI
radius, number of space shards, mesh axis size.
"""

from __future__ import annotations

import configparser
import dataclasses
import os

from goworld_tpu_torch.utils import consts
from goworld_tpu_torch.utils.consts import (
    MAX_RECONNECT_PEND_BYTES,
    MAX_RECONNECT_PEND_PACKETS,
)

# the port's own name first, then the JAX package's (the stock server
# directories' inis), then the reference's
DEFAULT_CONFIG_PATHS = ("goworld_tpu_torch.ini", "goworld_tpu.ini",
                        "goworld.ini")


@dataclasses.dataclass
class DispatcherConfig:
    host: str = "127.0.0.1"
    port: int = 14000
    http_port: int = 0


@dataclasses.dataclass
class GameConfig:
    boot_entity: str = "Account"
    save_interval: float = 300.0
    position_sync_interval_ms: int = 100
    ban_boot_entity: bool = False
    http_port: int = 0
    # distributed tracing: sampling rate for traces the GAME roots
    # itself (outbound migrations); inbound traced packets are always
    # recorded regardless (the gate made the sampling decision)
    trace_sample_rate: float = 0.0
    log_file: str = ""
    log_level: str = "info"
    # TPU execution knobs
    capacity: int = 16384
    n_spaces: int = 1
    aoi_radius: float = 50.0
    # AOI kernel tuning (ops/aoi.py GridSpec): sweep candidate fetch
    # ("table" | "ranges" | "cellrow" — table with premerged windows +
    # one row-gather per query, bit-identical to table | "shift" —
    # cell-major/gather-free but drops cap-overflowed entities as
    # watchers | "fused" — the ranges front half with the whole back
    # half (window gather -> key pack -> top-k) as one VMEM-resident
    # Pallas kernel, bit-identical to ranges; interpret-mode emulation
    # off-TPU, so never a CPU default) and top-k select
    # ("exact" | "sort" | "f32" — all three exact; sort/f32 lower to
    # faster TPU kernels — or "approx", which may miss a true neighbor
    # with ~2% probability on TPU). Unknown values are rejected at
    # GridSpec construction. Defaults come from
    # consts.DEFAULT_SWEEP_IMPL / DEFAULT_TOPK_IMPL — the one source
    # of truth shared with GridSpec and bench.py.
    aoi_sweep_impl: str = consts.DEFAULT_SWEEP_IMPL
    aoi_topk_impl: str = consts.DEFAULT_TOPK_IMPL
    # front-half cell-sort lowering ("argsort" | "counting" — two-pass
    # counting sort, bit-identical to argsort, deletes the bitonic
    # network | "pallas" — its kernel form). consts.DEFAULT_SORT_IMPL
    # is the shared default literal.
    aoi_sort_impl: str = consts.DEFAULT_SORT_IMPL
    # Verlet skin width (world units; 0 = off): build the AOI grid for
    # radius + skin and skip the whole front half on ticks where no
    # entity moved more than skin/2 since the last rebuild — exact by
    # the standard Verlet bound (ops/aoi.py GridSpec.skin). Size it
    # from movement speed: rebuild cadence ~ skin / (2*speed*dt).
    # Ignored for megaspace games (ghost query rows keep the stateless
    # sweep) and for n_spaces > 1 (the vmapped multi-space step runs
    # both cond branches). Memory: capacity x aoi_verlet_cap i32.
    aoi_skin: float = consts.DEFAULT_AOI_SKIN
    # cached candidate lanes per entity for the skin (0 = auto k+k//2);
    # exactness holds while rebuild-time candidate demand fits — the
    # aoi_over_k_rows gauge fires otherwise, like aoi_k
    aoi_verlet_cap: int = 0
    # force an AOI rebuild at least every N ticks regardless of
    # displacement (staleness backstop; 0 = displacement-driven only)
    aoi_rebuild_every_max: int = 0
    # AOI capacity bounds (ops/aoi.py GridSpec k / cell_cap): exactness
    # holds while true neighbor demand <= aoi_k and cell occupancy <=
    # aoi_cell_cap; overflow degrades to nearest-k and fires the
    # aoi_over_* opmon gauges. Re-provision from the gauges: aoi_k >
    # aoi_demand_max, aoi_cell_cap > aoi_cell_max. 0 = library default.
    aoi_k: int = 0
    aoi_cell_cap: int = 0
    # churn-adaptive extraction small-tier row budget (ops/extract.py
    # SMALL_TIER_ROWS; also env GOWORLD_SMALL_TIER_ROWS). 0 = library
    # default (16384, sized from the 1M bench's client-row churn;
    # TPU-profile re-derivation pending — docs/TODO_R5.md)
    small_tier_rows: int = 0
    # periodic crash-recovery checkpoint cadence in seconds (0 = off):
    # the game snapshots the running world on this interval so a
    # watchdog restart (`ctl watchdog`) can -restore from it. Async
    # off-thread on single-controller games; synchronous at a
    # tick-count cadence on multihost groups (leader writes the file).
    checkpoint_interval: float = 0.0
    # freeze boot-time objects out of the cyclic GC when the logic loop
    # starts (gen-2 collections otherwise walk the whole entity
    # population — ~100 ms at a 131K-entity shard vs the 16 ms frame);
    # post-boot churn stays tracked and collectable. CAVEAT: frozen
    # objects are reclaimed by refcounting only. The engine severs the
    # cycles it owns on destroy (attr trees, timer callbacks —
    # manager.destroy_entity / attrs.sever_tree), but USER-held cycles
    # among boot entities (e.g. two NPCs storing references to each
    # other) will leak after destroy — break such references in
    # OnDestroy, or set gc_freeze = false
    gc_freeze: bool = True
    # serve-loop tick rate (Hz): the deadline the overload governor
    # measures against. The 60 Hz default is the device-tick target;
    # hosts that cannot hold it should lower this rather than run
    # permanently DEGRADED (the ladder compares wall time per tick
    # against 1/tick_hz)
    tick_hz: float = float(consts.TICK_HZ)
    # overload-protection ladder (utils/overload.py; docs/ROBUSTNESS.md
    # "Overload & degradation"): NORMAL -> DEGRADED -> SHEDDING ->
    # REJECTING driven by tick latency / backlog / queue depths with
    # hysteresis. overload = false keeps the prioritized ingress queues
    # but never escalates past NORMAL.
    overload: bool = True
    overload_up_ticks: int = consts.OVERLOAD_UP_TICKS
    overload_down_ticks: int = consts.OVERLOAD_DOWN_TICKS
    overload_latency_ratio: float = consts.OVERLOAD_LATENCY_RATIO
    # DEGRADED fan-out degradation: position/attr sync serves each
    # entity cohort every Nth tick; client event/sync bundles flush
    # every Nth tick (bigger batches, fewer packets)
    degraded_sync_stride: int = consts.DEGRADED_SYNC_STRIDE
    degraded_event_coalesce: int = consts.DEGRADED_EVENT_COALESCE_TICKS
    # pipeline the host decode one tick behind the device step
    # (single-controller non-mesh games only; silently ignored
    # elsewhere): tick N's device execution overlaps tick N-1's host
    # event decode, so the frame pays max(device, host) instead of
    # their sum. Cost: client-visible events lag one tick (~one
    # position-sync interval).
    pipeline_decode: bool = False
    # resident-world runtime: donate the SpaceState carry
    # into the tick so XLA aliases it in place — zero steady-state
    # HBM allocation on the serve loop. Bit-identical to off (donation
    # is an aliasing hint, not a numerics change); snapshot/freeze
    # paths fall back LOUDLY to an explicit device copy of the planes
    # they read across ticks. Default on.
    resident: bool = True
    extent_x: float = 1000.0
    extent_z: float = 1000.0
    mesh_devices: int = 0  # 0 = single-device vmap path (GLOBAL count
                           # when mesh_processes > 1)
    mesh_processes: int = 1  # SPMD controller OS processes for this
                           # game: the CLI spawns one per rank with a
                           # shared jax.distributed coordinator; ONE
                           # logical game spans them (multihost)
    # reconnect pend queue budget (net/cluster.py): packets queued while
    # a dispatcher link is down; beyond either bound the OLDEST drop
    # (cluster_pend_dropped_total counts them)
    pend_max_packets: int = MAX_RECONNECT_PEND_PACKETS
    pend_max_bytes: int = MAX_RECONNECT_PEND_BYTES
    npc_speed: float = 5.0
    behavior: str = "random_walk"  # random_walk | mlp | btree (the fused
                                   # NPC kernels, BASELINE config 5)
    # adversarial workload scenario (goworld_tpu/scenarios registry:
    # hotspot | shrink | flock | teleport | mixed_radius | mixed —
    # docs/SCENARIOS.md). When set, NPC motion dispatches the spec's
    # heterogeneous behavior mix through one vmapped lax.switch and
    # `behavior` above is ignored for velocity. "" = off. Ignored for
    # megaspace games (the tile step keeps the homogeneous path).
    scenario: str = ""
    # ONE logical space spanning the whole mesh as spatial tiles
    # (parallel/megaspace.py; BASELINE config 4). extent_x/extent_z are
    # the WORLD extents; tiles are derived from mega_shape ("8" = 1D
    # x-strips, "4x2" = 2D XZ tiles; device count must match
    # mesh_devices). capacity is PER TILE.
    megaspace: bool = False
    mega_shape: str = ""           # "" = 1D strips over mesh_devices
    halo_cap: int = 1024
    migrate_cap: int = 256
    # halo ghost shipping impl (parallel/halo.py): "ppermute" (default,
    # barriered collective) | "async" (Pallas make_async_remote_copy
    # per edge, dirty-only packed payload — overlap-capable; off-TPU it
    # runs interpret mode with a one-time warning, never a CPU default)
    halo_impl: str = "ppermute"
    # live device-telemetry lanes (ops/telemetry.py): the
    # production tick accumulates tick signals (rebuild rate, skin
    # slack, over_k/over_cap, event volumes, per-tile occupancy) on
    # device with zero added host syncs and serves the reduced
    # workload signature at debug-http /workload. false = off (the
    # flight recorder then records frames without signature marks).
    telemetry_live: bool = True
    # incident flight recorder (utils/flightrec.py): per-tick frame
    # ring size (0 = off) and the per-trigger-kind dedup cooldown for
    # frozen snapshot bundles served at /incidents
    flightrec_ring: int = 512
    flightrec_cooldown_secs: float = 30.0
    # quantized state planes (ops/aoi.py GridSpec.precision):
    # "off" (default — bit-identical to pre-r12 behavior) | "q16" —
    # AOI-visible positions snap to a power-of-two int16 lattice and
    # the byte-heavy paths run on narrow planes (packed sorted view,
    # packed Verlet cache, bf16 velocity). Exact vs the oracle over the
    # snapped world BY CONSTRUCTION (docs/ROOFLINE.md "Quantized state
    # planes"). Rejected loudly at GridSpec build when the lattice
    # would be coarser than radius/4 or the origin is nonzero. Ignored
    # (warned) for megaspace games this round — the tile grids keep
    # f32 while the halo packing is staged (the audit stamps its
    # projected ICI win as ici_halo_mb_by_impl *_q16 rows).
    precision: str = consts.DEFAULT_PRECISION
    # delta-compressed client sync fan-out (net/codec.py
    # DeltaSyncEncoder): steady-state sync bytes scale with
    # dirty_frac * 13 B/record instead of 48 B/record. Decode at the
    # gate is bit-deterministic (baselines/keyframes ride in-band).
    sync_delta: bool = False
    # full-precision keyframe cadence per (client, entity) pair for
    # the delta sync stream (ticks)
    sync_keyframe_every: int = 16
    # end-to-end sync-age stamping (utils/syncage.py; docs/
    # OBSERVABILITY.md "End-to-end sync age"): every sync fan-out
    # batch carries the device-tick epoch that produced it as a 45 B
    # flagged trailer; the gate ages records at delivery into
    # sync_age_ms histograms and the deployment aggregator prints one
    # SLO verdict against the paper's 16 ms target. false = the legacy
    # byte-identical wire.
    sync_age: bool = True
    # delta-compressed snapshot chain (freeze.py SnapshotChain): every
    # Nth periodic checkpoint is a full quantized keyframe, the writes
    # between ship sparse int16 plane deltas with per-plane CRCs.
    # 0 = the monolithic checkpoint format, unchanged.
    snapshot_keyframe_every: int = 0
    # serve-loop residency plane (utils/residency.py; docs/
    # OBSERVABILITY.md "Serve-loop residency"): host-bubble/phase
    # timing from perf_counter marks on the tick's existing structure
    # (zero added device syncs), the sampled alloc-churn probes and
    # the donation-readiness buffer census, served at /residency and
    # merged into the deployment verdict. false = off.
    residency: bool = True
    # cadence (ticks) of the sampled probes — the buffer census and
    # device.memory_stats() deltas; the timing lanes are always-on.
    # Must be >= 1 (validated loudly at World build).
    residency_sample_every: int = 16
    # correctness audit plane (utils/audit.py; docs/OBSERVABILITY.md
    # "Correctness audit"): an independent entity-ownership ledger
    # (census digests + migrate ownership seqs -> deployment
    # conservation verdicts), a sampled live AOI oracle judging one
    # cohort's interest sets brute-force off the hot path, and mirror
    # consistency probes — served at /audit, violations feed
    # audit_violations_total{kind} + the audit_violation flight-
    # recorder trigger. false = off.
    audit: bool = True
    # oracle/probe sample cadence (ticks) and cohort size (entities
    # judged per sample). Must be >= 1 (validated loudly at World
    # build).
    audit_sample_every: int = 64
    audit_cohort: int = 64
    # SnapshotChain CRC-scrub cadence (ticks; 0 = off): the audit
    # worker re-reads this game's chain files on this cadence so
    # latent on-disk corruption is a named violation, not a surprise
    # at the next -restore boot
    audit_scrub_every: int = 0
    # online kernel governor (goworld_tpu/autotune; docs/AUTOTUNE.md):
    # the live workload signature hot-swaps the resolved tick config
    # (aoi_skin on/off, sort/sweep impl) between ticks with AOT-warmed
    # executables (zero mid-serving compile stalls), a deterministic
    # decision log (/governor endpoint) and a post-swap regret guard.
    # Single-shard non-mesh games only; requires telemetry_live.
    governor: bool = False
    # signature-window length in ticks (one governor decision per
    # window; also sets the live signature rotation cadence)
    governor_window_ticks: int = 64
    # hysteresis: consecutive windows a target config must win before
    # a swap is decided (down = returning to the table default), plus
    # the per-swap cooldown in windows
    governor_up_windows: int = 2
    governor_down_windows: int = 2
    governor_cooldown_windows: int = 4
    # regret guard: revert + pin when the post-swap tick-ms p90
    # worsens past this fraction vs the pre-swap window
    governor_regret_pct: float = 0.25
    # mapping-table override, "class:label;class:label" over the
    # candidate pool (classes: flock_like/teleport_like/density/
    # default; labels: the SCENARIO_KERNEL_CANDIDATES keys). Default:
    # seeded from the checked-in per-scenario best_kernel stamps.
    governor_table: str = ""
    # hot-standby replication (goworld_tpu/replication/; docs/
    # ROBUSTNESS.md "Hot-standby worlds"): nonzero makes THIS game a
    # warm standby of game N — it boots empty (no boot entities, never
    # chosen for clients), subscribes to game N's frame stream through
    # the dispatcher, mirrors its world live, and is promoted by the
    # supervisor when game N dies (kvreg-arbitrated, split-brain-safe).
    # 0 = a normal primary.
    standby_of: int = 0
    # primary-side stream cadence: every Nth streamed frame is a full
    # keyframe (deltas between). Also the disk-chain cadence when a
    # standby is attached; defaults to snapshot_keyframe_every when 0.
    replication_keyframe_every: int = 0
    # bounded replication-worker queue (captures). Full queue = the
    # capture is DROPPED (loud counter) and the next accepted one is
    # forced to a keyframe — backlog degrades cadence, never the tick.
    replication_queue: int = 4
    # standby staleness budget: /standby's verdict fails when the time
    # since the last applied frame exceeds this many primary ticks
    replication_lag_budget_ticks: int = 16


@dataclasses.dataclass
class GateConfig:
    host: str = "127.0.0.1"
    port: int = 15000
    ws_port: int = 0          # 0 = no websocket listener
    kcp_port: int = 0         # 0 = no KCP (reliable-UDP) listener
                              # (reference GateService.go:129-161)
    kcp_idle_timeout: float = 60.0  # reap KCP sessions with no inbound
                              # datagram for this long (UDP has no
                              # connection_lost; 0 disables)
    # client-edge transport (reference goworld.ini.sample compress/encrypt
    # flags; ClientProxy.go:38-53). encrypt=TLS on the TCP listener; the
    # cert/key are generated self-signed on first use when paths are empty.
    compress: bool = False
    # stream codec for compressed client connections: "snappy" (the
    # reference's codec — from-scratch framing-format implementation,
    # net/snappy.py) or "zlib" (one zlib-1 stream per direction; its
    # shared dictionary wins on tiny packets at more CPU per byte).
    # Both ends must agree, like the compress flag itself.
    compress_codec: str = "snappy"
    encrypt: bool = False
    tls_cert: str = ""
    tls_key: str = ""
    # default ON (a vanished TCP peer — cable pull, NAT expiry — is
    # reaped without opt-in; the reference ships 60 in its sample ini);
    # 0 stays the explicit off switch
    heartbeat_timeout: float = 30.0
    # admission control (utils/overload.py): connection cap (0 =
    # unlimited; new handshakes past the cap — or while the gate's
    # overload ladder is REJECTING — are refused), per-client
    # token-bucket rate limits on inbound packets/s and bytes/s (0 =
    # off), and the per-client downstream buffer budget with the
    # stalled-consumer kick window
    max_clients: int = 0
    rate_limit_pps: float = 0.0
    rate_limit_bps: float = 0.0
    downstream_max_bytes: int = consts.GATE_DOWNSTREAM_MAX_BYTES
    downstream_kick_secs: float = consts.GATE_DOWNSTREAM_KICK_SECS
    position_sync_interval_ms: int = 100
    # delivery target for the end-to-end sync-age verdict (ms): the
    # paper's 16 ms AOI-sync SLO by default. Ages are measured at this
    # gate's per-client flush (utils/syncage.py); a flush window whose
    # e2e p99 blows the target freezes a sync_age_breach incident.
    sync_age_target_ms: float = 16.0
    # reconnect pend queue budget (net/cluster.py; drop-oldest beyond)
    pend_max_packets: int = MAX_RECONNECT_PEND_PACKETS
    pend_max_bytes: int = MAX_RECONNECT_PEND_BYTES
    http_port: int = 0        # debug/metrics endpoint (0 = off); every
                              # process kind serves the same /metrics +
                              # /trace map (docs/OBSERVABILITY.md)
    # distributed tracing: probability that a client packet entering
    # this gate roots a sampled trace (0 = off; also settable live via
    # debug-http /tracing?rate= and `goworld_tpu trace`)
    trace_sample_rate: float = 0.0
    log_file: str = ""
    log_level: str = "info"


@dataclasses.dataclass
class StorageConfig:
    kind: str = "filesystem"   # filesystem | memory | redis | mongodb
    directory: str = "entity_storage"  # path, or host:port[/db] for
                                       # the networked kinds


@dataclasses.dataclass
class KVDBConfig:
    kind: str = "filesystem"   # filesystem | memory | redis |
                               # redis_cluster | mongodb
    path: str = "kvdb_data"    # path, addr[,addr...] or host:port[/db]


@dataclasses.dataclass
class ClusterConfig:
    entry: str = "server.py"   # game script ([deployment] entry = ...)
    # deterministic fault injection ([deployment] faults / faults_seed;
    # grammar in docs/ROBUSTNESS.md; env GOWORLD_FAULTS[_SEED] override)
    faults: str = ""
    faults_seed: int = 0
    # self-healing rebalance plane ([deployment] rebalance*;
    # goworld_tpu/rebalance/, docs/ROBUSTNESS.md "Elastic
    # rebalancing"): a game holding DEGRADED-or-worse for
    # rebalance_hold_windows observation windows while a peer has
    # headroom hands a bounded cohort (rebalance_batch entities per
    # window) to the underloaded game; committed (donor, target)
    # pairs then cool down for rebalance_cooldown_secs before the
    # pair can move again (ping-pong suppression)
    rebalance: bool = False
    rebalance_hold_windows: int = 3
    rebalance_batch: int = 64
    rebalance_cooldown_secs: float = 30.0
    dispatchers: dict[int, DispatcherConfig] = dataclasses.field(
        default_factory=dict)
    games: dict[int, GameConfig] = dataclasses.field(default_factory=dict)
    gates: dict[int, GateConfig] = dataclasses.field(default_factory=dict)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    kvdb: KVDBConfig = dataclasses.field(default_factory=KVDBConfig)

    @property
    def desired_games(self) -> int:
        return len(self.games)

    @property
    def desired_gates(self) -> int:
        return len(self.gates)

    def dispatcher_addrs(self) -> list[tuple[str, int]]:
        return [
            (d.host, d.port)
            for _, d in sorted(self.dispatchers.items())
        ]


def _fill(dc, section) -> None:
    """Assign section keys onto a dataclass, coercing by field type."""
    types = {f.name: f.type for f in dataclasses.fields(dc)}
    for key, raw in section.items():
        if key not in types:
            continue
        t = types[key]
        cur = getattr(dc, key)
        if isinstance(cur, bool) or t == "bool":
            val: object = raw.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        setattr(dc, key, val)


def load(path: str | None = None) -> ClusterConfig:
    """Load the cluster config (reference ``config.Get()``); falls back to
    a 1-dispatcher/1-game/1-gate localhost layout when no file exists."""
    cp = configparser.ConfigParser()
    found = None
    if path is not None:
        found = path
    else:
        for cand in DEFAULT_CONFIG_PATHS:
            if os.path.exists(cand):
                found = cand
                break
    if found is not None:
        with open(found) as f:
            cp.read_file(f)

    cfg = ClusterConfig()

    def common_of(prefix: str):
        name = f"{prefix}_common"
        return cp[name] if cp.has_section(name) else {}

    def build(prefix: str, cls, store: dict) -> None:
        common = common_of(prefix)
        for name in cp.sections():
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                idx = int(name[len(prefix):])
                dc = cls()
                _fill(dc, common)
                _fill(dc, cp[name])
                store[idx] = dc

    build("dispatcher", DispatcherConfig, cfg.dispatchers)
    build("game", GameConfig, cfg.games)
    build("gate", GateConfig, cfg.gates)
    if cp.has_section("deployment"):
        dep = cp["deployment"]
        if "entry" in dep:
            cfg.entry = dep["entry"]
        cfg.faults = dep.get("faults", cfg.faults)
        if "faults_seed" in dep:
            cfg.faults_seed = int(dep["faults_seed"])
        if "rebalance" in dep:
            cfg.rebalance = dep["rebalance"].strip().lower() in (
                "1", "true", "yes", "on")
        if "rebalance_hold_windows" in dep:
            cfg.rebalance_hold_windows = int(
                dep["rebalance_hold_windows"])
        if "rebalance_batch" in dep:
            cfg.rebalance_batch = int(dep["rebalance_batch"])
        if "rebalance_cooldown_secs" in dep:
            cfg.rebalance_cooldown_secs = float(
                dep["rebalance_cooldown_secs"])
        # reference semantics: [deployment] declares DESIRED COUNTS
        # (read_config.go:40-118): counts beyond the explicit numbered
        # sections auto-create defaults from the *_common section, and
        # sections beyond the count are dropped (the count IS the
        # deployment). Auto-created listeners get a per-index port
        # offset — inheriting one host:port N times would EADDRINUSE at
        # start. (These keys share names with ClusterConfig's dicts —
        # never _fill them, or `games = 3` would clobber the dict.)
        for key, cls, store, prefix in (
            ("dispatchers", DispatcherConfig, cfg.dispatchers,
             "dispatcher"),
            ("games", GameConfig, cfg.games, "game"),
            ("gates", GateConfig, cfg.gates, "gate"),
        ):
            if key not in dep:
                continue
            want = int(dep[key])
            common = common_of(prefix)
            for idx in range(1, want + 1):
                if idx not in store:
                    dc = cls()
                    _fill(dc, common)
                    for pf in ("port", "ws_port", "kcp_port",
                               "http_port"):
                        base = getattr(dc, pf, 0)
                        if base:
                            setattr(dc, pf, base + idx - 1)
                    lf = getattr(dc, "log_file", "")
                    if lf:  # shared log files interleave unattributably
                        stem, dot, ext = lf.rpartition(".")
                        setattr(dc, "log_file",
                                f"{stem}{idx}{dot}{ext}" if dot
                                else f"{lf}{idx}")
                    store[idx] = dc
            for idx in [i for i in store if i > want]:
                del store[idx]
        # explicit sections inheriting a *_common port can still collide
        # with an auto-created sibling's offset scheme: detect instead of
        # guessing intent
        for role, store in (("dispatcher", cfg.dispatchers),
                            ("gate", cfg.gates)):
            seen: dict[tuple, int] = {}
            for idx, dc in sorted(store.items()):
                for pf in ("port", "ws_port", "kcp_port", "http_port"):
                    p = getattr(dc, pf, 0)
                    if not p or p < 0:
                        continue
                    key = (getattr(dc, "host", ""), p)
                    if key in seen:
                        raise ValueError(
                            f"{role}{idx} {pf} {p} collides with "
                            f"{role}{seen[key]} — give each listener a "
                            "distinct port"
                        )
                    seen[key] = idx
    # debug-http collisions including GAME rank spans: a multihost game
    # binds http_port .. http_port + mesh_processes - 1 (one endpoint
    # per controller, api.run), which the dispatcher/gate-only check
    # above cannot see — and a wrong-port scrape silently attributes
    # one process's health to another
    seen_http: dict[tuple, str] = {}
    for role, store in (("dispatcher", cfg.dispatchers),
                        ("gate", cfg.gates)):
        for idx, dc in sorted(store.items()):
            p = getattr(dc, "http_port", 0)
            if p > 0:
                seen_http[(dc.host, p)] = f"{role}{idx}"
    for idx, gdc in sorted(cfg.games.items()):
        if gdc.http_port <= 0:
            continue
        span = max(1, getattr(gdc, "mesh_processes", 1))
        for rank in range(span):
            key = ("127.0.0.1", gdc.http_port + rank)  # games bind lo
            if key in seen_http:
                raise ValueError(
                    f"game{idx} http_port {key[1]}"
                    + (f" (rank {rank})" if span > 1 else "")
                    + f" collides with {seen_http[key]} — give each "
                    "debug endpoint a distinct port"
                )
            seen_http[key] = f"game{idx}" + (f"c{rank}" if span > 1
                                             else "")

    if cp.has_section("storage"):
        _fill(cfg.storage, cp["storage"])
    if cp.has_section("kvdb"):
        _fill(cfg.kvdb, cp["kvdb"])

    if not cfg.dispatchers:
        cfg.dispatchers[1] = DispatcherConfig()
    if not cfg.games:
        cfg.games[1] = GameConfig()
    if not cfg.gates:
        cfg.gates[1] = GateConfig()
    return cfg


def dumps_sample() -> str:
    """A commented sample config (reference ``goworld.ini.sample``)."""
    return """\
# goworld_tpu cluster configuration (reference: goworld.ini.sample)
# Every process reads this same file; numbered sections declare the
# deployment (their count is the readiness barrier).

# [deployment]
# faults = drop:gate->dispatcher:0.05,kill:game1@t+10s
#                    # seeded fault-injection schedule (chaos testing;
# faults_seed = 42   # grammar in docs/ROBUSTNESS.md; env
#                    # GOWORLD_FAULTS / GOWORLD_FAULTS_SEED override)
# rebalance = true   # self-healing entity rebalancing: a game holding
#                    # DEGRADED-or-worse hands a bounded cohort to an
#                    # underloaded peer (docs/ROBUSTNESS.md "Elastic
#                    # rebalancing"; served live at /rebalance)
# rebalance_hold_windows = 3    # sustained windows before a move plans
# rebalance_batch = 64          # entities per handoff send window
# rebalance_cooldown_secs = 30  # per-(donor,target) pair cooldown

[dispatcher1]
host = 127.0.0.1
port = 14000
# http_port = 14100  # debug/metrics endpoint: /metrics (Prometheus),
#                    # /trace (Chrome JSON), /vars, /ops, /healthz

[game_common]
boot_entity = Account
position_sync_interval_ms = 100
save_interval = 300
# TPU execution
capacity = 16384
n_spaces = 1
aoi_radius = 50.0
extent_x = 1000.0
extent_z = 1000.0
# behavior = btree   # fused NPC kernel: random_walk | mlp | btree
# scenario = hotspot # adversarial workload mix (goworld_tpu/scenarios
#                    # registry; docs/SCENARIOS.md): hotspot | shrink |
#                    # flock | teleport | mixed_radius | mixed
#                    # (megaspace games honor it too — border churn)
# halo_impl = ppermute # megaspace ghost shipping: ppermute (barriered
#                    # collective) | async (Pallas per-edge remote DMA,
#                    # dirty-only packed payload; interpret + warning
#                    # off-TPU — never a CPU default)
# pipeline_decode = true   # overlap host event decode with the device
#                          # step (single-controller non-mesh games;
#                          # client events lag one tick)
# resident = true          # carry donation: XLA aliases the SpaceState
#                          # in place, zero steady-state HBM allocation
#                          # (default ON; bit-identical either way —
#                          # snapshot capture falls back loudly to a
#                          # device copy of the planes it pins)
# http_port = 16000        # debug/metrics endpoint (multihost ranks
#                          # bind http_port + rank)
# gc_freeze = false        # keep boot objects in the cyclic GC (the
#                          # default freezes them out: gen-2 passes
#                          # cost ~100 ms at a 131K-entity shard)
# overload = true          # overload ladder NORMAL->DEGRADED->SHEDDING
#                          # ->REJECTING (docs/ROBUSTNESS.md); knobs:
# overload_up_ticks = 8    # pressured ticks to climb one rung
# overload_down_ticks = 120  # calm ticks to descend one rung
# overload_latency_ratio = 1.5  # tick wall / interval that = pressure
# degraded_sync_stride = 4 # DEGRADED: sync each entity cohort every Nth
# degraded_event_coalesce = 2  # DEGRADED: flush bundles every Nth tick
# precision = q16          # quantized state planes: snap
#                          # AOI-visible positions to an int16 lattice,
#                          # bf16 velocity, packed sweep/Verlet planes —
#                          # halves modeled bytes/tick; off = bit-
#                          # identical to pre-r12 (docs/ROOFLINE.md)
# sync_delta = true        # delta-compressed sync fan-out: int16 deltas
#                          # vs per-(client,entity) baselines, 13 B vs
#                          # 48 B/record steady state
# sync_keyframe_every = 16 # full-precision keyframe cadence (ticks)
# sync_age = false         # drop the 45 B per-batch sync-age stamp
#                          # (default ON: gates age every record at
#                          # delivery vs the paper's 16 ms target —
#                          # docs/OBSERVABILITY.md "End-to-end sync
#                          # age"; off = legacy byte-identical wire)
# snapshot_keyframe_every = 8  # delta-compressed checkpoint chain:
#                          # every Nth checkpoint is a full quantized
#                          # keyframe (0 = monolithic checkpoints)
# residency = false        # drop the serve-loop residency plane
#                          # (default ON: host-bubble/alloc-churn/
#                          # serve-gap verdicts at /residency —
#                          # docs/OBSERVABILITY.md "Serve-loop
#                          # residency"; timing only, no device syncs)
# residency_sample_every = 16  # cadence (ticks) of the buffer census
#                          # + memory_stats probes; must be >= 1
# audit = false            # drop the correctness audit plane
#                          # (default ON: entity-ownership ledger +
#                          # sampled AOI oracle + mirror probes at
#                          # /audit — docs/OBSERVABILITY.md
#                          # "Correctness audit"; zero device syncs)
# audit_sample_every = 64  # oracle/probe sample cadence (ticks)
# audit_cohort = 64        # entities judged per sample
# audit_scrub_every = 1024 # SnapshotChain CRC-scrub cadence (ticks;
#                          # 0 = off)
# governor = true          # online kernel governor (docs/AUTOTUNE.md):
#                          # the live workload signature hot-swaps the
#                          # tick config (skin on/off, counting sort)
#                          # between ticks — warm-gated, regret-guarded
# governor_window_ticks = 64   # one decision per signature window
# governor_up_windows = 2  # windows a target must win before a swap
# governor_down_windows = 2    # same, returning to the default config
# governor_cooldown_windows = 4  # refractory windows after a swap
# governor_regret_pct = 0.25   # post-swap p90 worsening that reverts
# governor_table = teleport_like:skin=0;density:sort=counting,skin=0
#                          # mapping override (class:label;...)
# standby_of = 1           # make THIS game a hot standby of game 1:
#                          # boots empty, mirrors game 1's frame stream
#                          # live, promoted by the supervisor on game 1
#                          # death (docs/ROBUSTNESS.md "Hot-standby
#                          # worlds"); 0 = a normal primary
# replication_keyframe_every = 8  # stream keyframe cadence (frames);
#                          # 0 = inherit snapshot_keyframe_every
# replication_queue = 4    # bounded replication-worker queue; full =
#                          # drop capture + force next keyframe
# replication_lag_budget_ticks = 16  # /standby verdict fails past this
#                          # staleness (primary ticks)

[game1]

[gate_common]
host = 127.0.0.1
compress = false
# heartbeat reaping defaults to 30 when omitted; 0 = explicit off
heartbeat_timeout = 60

[gate1]
port = 15000
# ws_port = 15100    # websocket listener
# kcp_port = 15200   # KCP (reliable-UDP) listener
# compress = true    # stream compression (both ends must agree)
# compress_codec = snappy   # snappy (default, the reference codec) | zlib
# encrypt = true     # TLS on the TCP listener (self-signed on first use)
# max_clients = 10000       # connection cap (0 = unlimited); REJECTING
#                           # state refuses new handshakes regardless
# rate_limit_pps = 200      # per-client inbound packets/s (0 = off)
# rate_limit_bps = 262144   # per-client inbound bytes/s (0 = off)
# downstream_max_bytes = 4194304  # per-client downstream buffer budget
# downstream_kick_secs = 10 # disconnect a client whose buffer stays full

[storage]
kind = filesystem
directory = entity_storage
# kind = mongodb           # the reference's primary backend (BSON +
# directory = 127.0.0.1:27017/goworld   # OP_MSG wire; mongod or the
#                          # in-process minimongo)
# kind = redis
# directory = 127.0.0.1:6379

[kvdb]
kind = filesystem
path = kvdb_data
"""
