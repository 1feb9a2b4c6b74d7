"""The constants this package shares with the JAX package's
``goworld_tpu/utils/consts.py``, copied so that the port imports nothing
of it. One config must mean the same thing on both sides, so every
value here equals its counterpart there.

Reference parity: ``engine/consts/consts.go:7-113`` centralises every
compile-time tunable (tick intervals, buffer sizes, queue caps, timeouts,
debug switches).
"""

# --- tick / timing ------------------------------------------------------
TICK_HZ = 60                      # device tick rate target (reference games
                                  # tick timers every 5ms, position sync every
                                  # 100ms; our device tick subsumes both)
HOST_TICK_INTERVAL = 0.005        # host service loop resolution (consts.go:32)
POSITION_SYNC_INTERVAL_MS = 100   # client<->server sync cadence default
                                  # (goworld.ini.sample:50,75)

# --- kernel capacity defaults ------------------------------------------
DEFAULT_CAPACITY = 16384          # entity slots per space shard
DEFAULT_MAX_NEIGHBORS = 64        # K: AOI interest cap per entity
DEFAULT_CELL_CAP = 32             # max candidates considered per grid cell
DEFAULT_EVENT_CAP = 4096          # enter/leave events surfaced per tick
DEFAULT_SYNC_CAP = 16384          # sync records surfaced per tick
DEFAULT_INPUT_CAP = 4096          # client position-sync inputs per tick
DEFAULT_ROW_BLOCK = 32768         # AOI row-block size (memory ceiling knob)
# The ONE source of truth for the AOI sweep/top-k implementation
# defaults. GridSpec (kernel level), GameConfig.aoi_* (ini level) and
# bench.py all draw from here so a direct GridSpec user gets the same
# measured-winner config the production stack runs (r4 A/B: "ranges"
# beat "table" by ~18% on CPU and is fidelity-identical-or-better —
# its pooled 3*cell_cap triple cap only ever ADMITS candidates the
# per-cell cap dropped; "sort" ranking is exact under every workload
# and was ~2.5x the generic int32 lax.top_k on both platforms).
DEFAULT_SWEEP_IMPL = "ranges"
DEFAULT_TOPK_IMPL = "sort"
# Front-half cell-sort lowering (GridSpec.sort_impl): "argsort" is the
# XLA sort; "counting" is the two-pass counting sort (ops/sort.py) that
# deletes the bitonic network — the roofline's dominant HBM term at 1M
# (docs/ROOFLINE.md); "pallas" is its kernel form (interpret-validated,
# TPU lowering staged). Default stays "argsort" pending a CPU/TPU
# measurement; bench autotune A/Bs "counting" every run.
DEFAULT_SORT_IMPL = "argsort"
# Verlet skin width (GridSpec.skin): 0 disables front-half reuse. The
# library default is OFF — the skin trades cache memory (N x verlet_cap
# i32) and a knob for skipping the whole front half + window fetch on
# ticks where nothing moved more than skin/2; workloads opt in via
# [gameN] aoi_skin or BENCH_SKIN with a value matched to their movement
# speed (rebuild cadence ~ skin / (2 * speed * dt)).
DEFAULT_AOI_SKIN = 0.0
# Quantized state planes (GridSpec.precision, ROADMAP 3):
# "off" keeps today's all-f32 streams bit-identically; "q16" snaps the
# AOI-visible positions to a POWER-OF-TWO lattice sized so one axis
# fits int16 (<= 2^PRECISION_POS_BITS lattice points) and threads
# int16/bf16 planes through the byte-heavy paths (packed sorted view,
# packed Verlet candidate cache, bf16 velocity, delta sync, delta
# snapshots). Exactness is by construction, not by tolerance: the
# lattice step is a power of two and the cell size a power-of-two
# multiple of it, so every quantized coordinate, difference and cell
# index is EXACT in both the int16 and f32 domains — the quantized
# sweep is bit-identical to the f32 sweep over the snapped positions,
# and the oracle over snapped positions gates exactness like every
# other parity suite (docs/ROOFLINE.md "Quantized state planes").
DEFAULT_PRECISION = "off"
PRECISION_POS_BITS = 15

# Packed-key id width (ops/aoi.py _ID_BITS draws from here): slot ids
# share an int32 with the quantized distance, so the packed fast paths
# (single-array front sort, shift sweep, Verlet reuse) require
# n < 2^AOI_ID_BITS. One source of truth for every n-bound guard —
# core/step.py's verlet dispatch and bench.py's (jax-free parent)
# phase probes mirror the same bound.
AOI_ID_BITS = 21

# --- queues / backpressure (reference consts.go:26-28) -----------------
MAX_PENDING_PACKETS_PER_GAME = 1_000_000
MAX_PENDING_PACKETS_PER_ENTITY = 1_000
# reconnect pend queue budget (net/cluster.py DispatcherConn._pending):
# packets queued while a dispatcher link is down, drop-OLDEST beyond
# either bound (counted in cluster_pend_dropped_total). Overridable per
# game/gate via the ini pend_max_packets / pend_max_bytes keys.
MAX_RECONNECT_PEND_PACKETS = 65_536
MAX_RECONNECT_PEND_BYTES = 32 << 20

# --- overload protection (utils/overload.py; docs/ROBUSTNESS.md) -------
# governor hysteresis: consecutive pressured observations to climb one
# ladder rung / consecutive calm observations to descend one
OVERLOAD_UP_TICKS = 8
OVERLOAD_DOWN_TICKS = 120
# tick wall time / tick_interval that counts as pressure (1.0 = the
# loop exactly misses its cadence; 1.5 leaves headroom for one-off GC
# or compile stalls)
OVERLOAD_LATENCY_RATIO = 1.5
OVERLOAD_BACKLOG_ENTER = 2.0
# per-class ingress queue caps for the bounded (sheddable) classes;
# critical/rpc use MAX_PENDING_PACKETS_PER_GAME as an OOM backstop
OVERLOAD_QUEUE_CAP_SYNC = 65_536
OVERLOAD_QUEUE_CAP_EVENTS = 65_536
OVERLOAD_QUEUE_CAP_NOISE = 4_096
# DEGRADED fan-out degradation: sync every Nth tick per entity cohort,
# flush client event/sync bundles every Nth tick (bigger batches)
DEGRADED_SYNC_STRIDE = 4
DEGRADED_EVENT_COALESCE_TICKS = 2
# gate admission: per-client downstream buffer budget; a client whose
# socket stays full past the kick window is disconnected
GATE_DOWNSTREAM_MAX_BYTES = 4 << 20
GATE_DOWNSTREAM_KICK_SECS = 10.0
# dispatcher per-game pend queue byte budget (packet budget is
# MAX_PENDING_PACKETS_PER_GAME)
MAX_PENDING_BYTES_PER_GAME = 64 << 20
# circuit breakers around kvdb/storage backends
CIRCUIT_FAILURE_THRESHOLD = 5
CIRCUIT_RESET_TIMEOUT = 5.0

# --- timeouts (reference consts.go:58-64) ------------------------------
MIGRATE_TIMEOUT = 60.0
LOAD_TIMEOUT = 60.0
FREEZE_BLOCK_TIMEOUT = 10.0

# --- persistence ---------------------------------------------------------
DEFAULT_SAVE_INTERVAL = 300.0     # reference read_config.go:28 (5 min)

# --- debug switches (reference consts.go:76-89) ------------------------
DEBUG_PACKETS = False
DEBUG_SPACES = False
OPTIMIZE_LOCAL_ENTITY_CALL = True  # set False in tests to force the full
                                   # routed path (reference consts.go:7)

# --- networking ----------------------------------------------------------
SUPERVISOR_STARTED_TAG = "GOWORLD_TPU_PROCESS_STARTED"  # consts.go:108-112
FREEZE_EXIT_CODE = 23  # game exited via freeze; CLI restarts with -restore

# Dispatcher game-ids for multihost FOLLOWER controllers: the logical
# game keeps its gid (leader), followers get base + gid*64 + rank so
# their connections don't collide with real game ids (u16 wire field)
MH_FOLLOWER_GAME_ID_BASE = 30000
