"""Drive goworld_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and no phase's failure
is caught:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``goworld_tpu_torch/csrc`` with nvcc;
3. the counting-sort kernel against its plain version and a stable
   argsort at 2^20 keys (bench keys, then skewed keys), bit for bit;
   then at n = 1, 4095, 4097 and 311,296 and at key widths of 1, 21 and
   31 bits against a stable argsort (and the plain version wherever its
   n_rows + 1 tables fit);
4. the fused-sweep kernel against its plain version at 2^20 queries,
   then at k = 8 and 64, cell_cap 3, 4 and 28 (one and eight keys a
   lane), without flag bits, and on a clustered world where most rows
   have demand > 32, each time checking that the sorted slot ids it
   walks are a permutation of the rows; then ``grid_neighbors_flags``
   under fused+pallas against ranges+argsort on the card for the sort,
   exact and f32 rankings, and at a small size against the brute-force
   oracle;
5. the single-Space path: the 2^20-entity bench world through
   ``create_state`` and ``make_tick`` for TICKS ticks with the
   4096-record input stream, checking the launch counts, events,
   records, and one tick against the same tick run on the kernels'
   plain versions;
6. the sweep and sort kernels timed at that path's shapes by CUDA
   events over back-to-back calls, and their bounds;
7. the halo phase kernel against its plain version bit for bit at
   halo_cap 4096 in 84 cases (both 2D phases at 2x2 and 4x2, the 1D
   phase of 8 tiles and one tile shipping to itself; the layout's
   receivers, all and none; counts 0, H, > H and random; NaN, -0.0 and
   inf words; gids up to the meta bound), then ``exchange_halo_2d`` on
   the megaspace world and ``exchange_halo`` over 8 tiles under "async"
   against "ppermute", with 2 and 1 kernel launches a call;
8. the megaspace path: the 2^20-entity 2x2 megaspace through
   ``create_mega_state`` and ``make_mega_tick`` for MEGA_TICKS ticks,
   checking launch counts, events, records, ghosts, migrations and
   conservation, one tick against the same tick on the plain versions
   (ppermute ship, ranges sweep, counting sort), and one tick under the
   sync guard;
9. the fused sweep at the megaspace shape (queries Q < n rows: local
   rows over local + ghost rows, whose sorted slot ids are checked to be
   a permutation of them) against its plain version, and the phase
   kernel's times on the two phases of one exchange of the megaspace
   state by events, beside one ``exchange_halo_2d`` under each halo
   impl (their device times and kernels a call are read in [12]);
10. a small 2x2 megaspace against a brute-force interest oracle, across
    every kind of tile border (x, z, corner);
11. the serving World at its defaults (the live telemetry lanes, the
    residency plane sampled every 4 ticks, the audit plane every 8, the
    resident carry): ``workload.serve_world(..., boot=True)`` populates
    a quarter of a World of 2^20 slots (WORLD_POP) through
    ``Space.create_entity``, in batches
    entered through ticks whose events the caps hold (its time and the
    host's RSS before and after printed), then WORLD_TICKS
    ``World.tick``s of the game's traffic, each staging 4096 client
    syncs (each a step from where its player stands), 1024 hot-attr
    sets (some twice) and 64 destroys and creates, checking one sweep
    and one sort launch a tick, that the drained lanes account for every
    tick (rebuilt and occupancy each sum to the tick count, per_tile is
    the host's entity count), that a workload signature is served, that
    every audit sample judged its cohort with 0 mismatches (skips by
    reason, drops counted), that the census reads 0 re-allocated lanes;
    printing ``World.tick`` p50/p99 beside [5]'s and the World's
    without the planes (PERF.md runs AC and AE), the
    audit-sample ticks apart, the mean of its four spans, the fold's and
    the carry copy's device time by events, the records and events
    decoded against their true counts and the rows whose interest list
    changed against their cap; then STRESS_TICKS ticks whose syncs
    teleport to uniform points (the bench's input stream), printed
    apart with the mismatches the audit finds once their dropped events
    degrade the interest sets; one more tick whose step and fold run
    under the sync guard, the step on a clone held bit for bit against
    ``make_tick`` on the plain versions (ranges/argsort), its fetched
    outputs, positions, yaws and alive flags bit for bit against plain
    ``.cpu()`` copies; one judged audit sample of the full World timed
    on a scratch plane (a full world's samples are skipped: its sweep
    has cells past cell_cap); and twin Worlds of 2^16 slots at their
    defaults,
    one on the kernels and one on the plain versions, equal in sinks,
    hooks, state, telemetry lanes, signatures, audit stats and ledgers
    for TWIN_TICKS ticks of walking and teleporting syncs in turns;
12. every torch.profiler read, here after every timed path because a
    profiler session slows every later launch of the host-bound ticks:
    the sweep's and sort's own device time and kernel launches a call,
    the megaspace tile sweep's, the phase kernel's and one exchange's
    under each impl, the World's telemetry fold's and its resident carry
    copy's (at [11]'s last game tick); then a ``kernels`` JSON line: per
    kernel its launches on its paths (and by path), time, device time,
    kernel launches a call, plain time, library time and bound (the
    sweep's also by the all-lanes count of earlier runs:
    ``bound_ms_window_lanes``, and its numbers at the Verlet rebuild's
    shape: ``verlet_rebuild_shape``, and at the q16 path's:
    ``q16_rebuild_shape``);
13. (run before 12) the Verlet skin: the fused sweep at the rebuild's
    shape (k = verlet_cap_eff 48, no flag bits, reach padded by the
    skin) against its plain version, under a closed gate (its buffers
    unchanged byte for byte) and an open one, timed both ways; the
    input scatter with heavy slot repeats against the host's last write
    per slot; an uncut world of FLOAT_N entities run FLOAT_TICKS ticks
    on the card and on the CPU port, bit-equal in every lane; then the
    bench world uncut (``workload.uncut_config``: skin 4, verlet_cap
    48, syncs drawn with repeats) for VERLET_TICKS ticks, each beside a
    skin-0 tick in lockstep and bit-equal to it in every lane and
    output but the skin gauges and the cell gauges (cells of another
    size), one gated sweep and one sort launch a tick, the rebuild
    count and p50/p99 over all, reuse and rebuild ticks;
14. (run before 12) that world at precision="q16" (cell_cap 12, as
    13): the gated sweep at this path's rebuild shape (snapped
    positions, k 48, reach pad 4) against its plain version, gate open
    and closed; then Q16_TICKS ticks, each beside a twin on the plain
    path (ranges/counting) and bit-equal to it in every lane; each
    tick's lists equal ``grid_neighbors_flags`` (precision off, plain
    path) over the snapped positions on every row no truncation touches
    (no overflowed run at the last rebuild or in the reference, no full
    cache row); the velocity lane is bfloat16; p50/p99 as in 13;
15. (run before 12) several Spaces on one card, SPACES x SPACE_N
    (``workload.multi_config``/``multi_world``: 8 bench worlds of 2^17
    on a leading [S] axis): the batched sort and sweep against their
    plain versions (and every Space's sweep against its own launch) bit
    for bit, timed beside their plain versions, a per-Space
    ``torch.argsort`` and their bounds; two batched ticks under the sync
    guard; SPACE_TICKS batched ticks by CUDA events, one sweep and one
    sort launch a tick, the same a tick as a one-Space batched state;
    the same ticks again in lockstep with SPACES single-Space ticks,
    every lane of state and outputs equal on every tick; then
    ``serve_world(SPACE_WORLD_N, spaces=SPACES, boot=True)``: a World of
    SPACES Spaces at its defaults, booted through ticks whose events
    each Space's caps hold, WORLD_TICKS ``World.tick``s of the game's
    traffic plus SERVE_MIGRATIONS ``enter_space`` moves between random
    Spaces a tick (every staged migration applied), p50/p99 and the four
    spans, the planes checked as in 11, one more tick's step and fold
    under the sync guard; [12] reads the batched kernels' and the
    batched tick's device time beside the single-Space 2^20 tick's;
16. each phase's wall seconds, then the result line ``{"ok": true,
    "device": {...}}``;
17. (run before 12) NPC behaviors, BASELINE config 5: the policy kernel
    ``npc_mlp`` (``csrc/npc_mlp.cu``) against its plain version bit for
    bit at 2^20 rows of config 5's observations, at 1, 2, 3, 31 and 4097
    rows of extreme observations (+-3e38, 1e30, 0, -0.0, NaN) under
    ``init_policy(5)`` and random weights at hidden 128 and 16 (every
    lanes mode of layer_lanes there), and on ``mlp_underflow_case``
    (layer-2 products straddling 2^-126, which the flush zeroes: the
    kernel's rounded layer 2); bf16 tanh on the card against the CPU's
    on all 65536
    inputs, through float64 and through the kernel's table; its time,
    plain time, cuBLAS bf16 chain time (not bit-equal) and bounds at the
    bf16 tensor-core and the float32 CUDA-core rate; an uncut world of FLOAT_N
    entities FLOAT_TICKS ticks under btree, mlp and the mixed scenario
    on the card and on the CPU port, bit-equal in every lane; the bench
    world uncut under btree and then mlp for BEHAVIOR_TICKS ticks (one
    sweep, one sort and, for mlp, one npc_mlp launch a tick; one tick
    under the sync guard; one tick against its plain twin), p50/p99 and
    the behavior stage's time beside the random walk's; every registry
    scenario SCN_TICKS ticks at SCN_N against its plain twin and mixed at
    2^20 for MIXED_TICKS ticks; the 2x2 megaspace under mlp for
    MEGA_TICKS ticks beside its plain twin tick; twin served Worlds of
    2^16 slots under mlp (kernels, plain versions) equal in sinks and
    state. [12] reads npc_mlp's device time;
18. (run before 12) the World's remaining planes at 2^20 slots: inside
    11, right after its game ticks, its World with ``pipeline_decode``
    turned on for WORLD_TICKS ticks of the same traffic (one sweep and
    one sort launch a tick; the host syncs a tick counted: one wait for
    the copy of the previous tick's outputs, and the decode's reads of
    live positions; decoded events against their true counts), p50/p99
    and the four spans beside 11's eager ones, its planes (lanes a tick
    behind, the audit's ``pipeline_decode`` skips, the census), one
    tick's step and fold under the sync guard, then drained and eager
    again for WORLD_TICKS more ticks, timed (the runs in turns); after
    11, freeze on that World after its ticks:
    ``checkpoint_async`` (its capture on the tick thread, its worker,
    its bytes), a ``SnapshotChain`` keyframe and, 8 ticks on, a delta
    (each captured on the tick thread and built on the caller), the
    audit's ``scrub_snapshots`` over both files (0 corrupt); a restore
    of the delta's first RESTORE_N records into a fresh World of 2^20
    slots at the uncut config's skin, its poses equal to the source's lattice planes byte for byte,
    RESTORED_TICKS ticks (one sweep launch a tick, the first a Verlet
    rebuild); the governor on that World: every default candidate
    warmed off the tick thread, commits forced through GOVERNOR_SWAPS,
    each swap's first tick bit for bit against a fresh ``make_tick`` at
    the target config on a clone of the carried state, each config's
    launches; under ``table`` its sweep beside ``fused``'s (equal on
    every row no cell past cell_cap touches, both timed); the World's
    ``cost_report`` beside ``torch.cuda.max_memory_allocated``; twin
    Worlds of 2^16 slots, pipelined and eager, equal after the drain in
    sync records, entity messages, hooks, state, interest sets, ledgers,
    the pipelined lanes a tick behind the eager ones;
    then (run after 17) the subnormal gate: ``workload.underflow_world``'s
    4 ticks (``tests/test_torch_cap.py``'s underflow case, 512 rows)
    under mlp and under the random walk on the card against the CPU
    port, which gives XLA's flushed bits, the card restarted from the
    CPU port's state each tick: 0 differing words or the run fails; the
    flush helpers of ``ops/xla_order.py`` on float32's edge words and at
    the tininess edge, card == CPU; ``npc_mlp`` and its plain version on
    ``mlp_underflow_case`` == the CPU port's plain version under the
    flush scope;
19. (run before 12) the served game through the port's normal entry:
    the port's ``ClusterHarness`` (2 dispatchers and 1 gate over TCP on
    ephemeral ports) and an ini naming them (GAME_SLOTS slots, one
    Space, ``aoi_sweep_impl = fused``, ``aoi_sort_impl = pallas``,
    ``workload.serve_world``'s radius, extent, k and cell_cap (the fused
    kernel takes ``9 * cell_cap <= 256``; the ini default is 32),
    filesystem storage and kvdb, the rest at the defaults); the game registered through
    ``import goworld_tpu_torch as gw`` (``Account``, ``Avatar``,
    ``Monster``, ``Arena``) with an ``on_boot`` callback that enters
    GAME_MONSTERS random-walking Monsters through ticks whose events fit
    the caps; ``gw.run([...], block=False)`` and ``server.pump();
    server.tick()`` in a loop; GAME_BOTS strict ``BotClient``s through
    the gate, GAME_GROUP a spot where the Monsters are densest, each
    logging in, walking with position syncs for GAME_WALK_S seconds,
    saying one line and disconnecting. It fails unless every login
    reaches an Avatar, the strict mirrors report 0 errors, every bot's
    mirror equals its Avatar's interest set on the server at the end of
    the window (with a Monster in it), every ``OnSay`` reaches each
    client the server holds as the speaker's watcher (its group among
    them), and every game tick launches one sweep and one sort; it
    prints the boot time, the logins' wall time, the game tick's host
    wall time p50/p99 over the window with the World's four spans and
    ``fan_out``, and the tick count. Then ``server.request_freeze()``
    reaches ``frozen`` with a freeze file on disk, and a fresh World of
    the same ini restores through ``GameServer(restore=True)``: its
    entities, attrs, positions and yaws equal the frozen World's, and
    its first tick runs. On a mirror mismatch it prints, for each
    differing entity, its id and type, its Chebyshev and Euclidean
    distance to the Avatar, its rank by distance in the Space (the
    server lists the k nearest) and the tick of its last enter and
    leave on the server and of its last create and destroy at the bot
    (ROADMAP C9);
20. (run before 12) this slice: the batched tick of SPACES x SPACE_N
    under btree, mlp (``init_policy(5)``, hidden 128) and the mixed
    scenario, SLICE_TICKS ticks by events each beside [15]'s random
    walk, one sweep, one sort and (mlp) one ``npc_mlp`` launch a tick
    for all Spaces, two ticks under the sync guard, one tick against
    its plain twin, SLICE_LOCKSTEP ticks in lockstep with single-Space
    ticks (every lane equal); SLICE_FLOAT_SPACES Spaces of FLOAT_N under
    the three on the card and the CPU port for FLOAT_TICKS ticks,
    bit-equal in every lane; ``serve_world(SPACE_WORLD_N, spaces=SPACES,
    boot=True)`` with its Mobs under mlp for SLICE_WORLD_TICKS
    ``World.tick``s of [15]'s traffic (every staged migration applied),
    p50/p99 and spans, and kernel/plain twin Worlds of SLICE_TWIN_N
    slots a Space equal in sinks, hooks and state; the bench world
    uncut at q16 under mlp for SLICE_Q16_TICKS ticks (the velocity lane
    bfloat16, one tick against its plain twin); at 2^20, skin 0,
    ``cellrow`` == ``table``, ``approx`` == ``f32`` under ``ranges`` and
    ``fused``, ``shift`` == ``table`` on every row no cell past
    cell_cap touches, each sweep's ms by events beside ``fused``'s; and
    ``shift`` on a clustered world of FLOAT_N (cells past cell_cap) on
    the card == the CPU port's. [12] reads the torch kernels a tick of
    [5], of [17]'s config 5 under mlp and of [20]'s batched tick under
    mlp;
21. (run before 12) the World on a mesh and the megaspace World, every
    shard on the card (``parallel.mesh.make_mesh``): (a)
    ``make_multi_tick`` at SPACES x SPACE_N ([15]'s worlds): MESH_TICKS
    ticks without migration requests in lockstep with [15]'s batched
    tick (every lane equal, no arrival), then, from the same worlds
    with 1/8 of each shard's rows free (MESH_FULL_FREE in MESH_FULL),
    MESH_TICKS ticks of MESH_MIGRATIONS requests (8 a shard into
    MESH_FULL, so arrivals are dropped) against the plain twin
    (ranges/argsort) in every lane and output, one sweep and one sort
    launch a tick, two ticks under the sync guard, p50/p99 by events;
    (b) [15]'s World on a mesh of SPACES (``serve_world(...,
    mesh=True)``): WORLD_TICKS ``World.tick``s of the game's traffic and
    SERVE_MIGRATIONS ``enter_space`` moves a tick riding the step's
    exchange, every move arrived and each moved entity's (shard, slot)
    an alive row of its type it owns on the card, p50/p99 and spans;
    (c) the megaspace World through ``gw.run()``: an ini shaped like
    ``examples/megaspace_demo/goworld_tpu.ini`` (``mesh_devices``
    SPACES, ``megaspace = true``, ``mega_shape`` 4x2, btree) at
    ``workload.mega_config``'s radius, world extent and halo_cap,
    MEGA_GAME_SLOTS slots a tile, ``fused``/``pallas``, ``halo_impl =
    async``; MEGA_GAME_MONSTERS btree Monsters booted in ticks whose
    events fit the caps; MEGA_GAME_BOTS strict bots in groups of
    MEGA_GAME_GROUP at tile corners, each walking across the borders
    it faces for MEGA_GAME_WALK_S s; it fails unless every game tick
    launches SPACES sweeps, SPACES sorts and 2 phase kernels, no
    arrival is dropped and no halo overflows, every Avatar keeps its
    EntityID and crosses a border, the strict mirrors report 0 errors
    and equal the interest sets, the interest sets equal a brute-force
    oracle over the fetched positions (Avatars past k apart), and the
    freeze through the dispatchers and ``GameServer(restore=True)``
    into a fresh megaspace World restore every entity, whose first
    tick runs; (d) megaspace twins of SPACES x MEGA_TWIN_N (kernels,
    ``async``; plain versions, ``ppermute``) equal in sinks, hooks,
    state, telemetry lanes, signatures, audit stats and ledgers for
    MEGA_TWIN_TICKS ticks, and a megaspace World and a World on a mesh
    of SPACES x CARD_CPU_N on the card == the CPU port in every lane
    of state and outputs for CARD_CPU_TICKS ticks;
22. (run after 21, before 12) the deployment through the ops CLI: [19]'s
    ini (with the gate's ``ws_port`` and ``kcp_port``, ``compress_codec
    = snappy``, an ``http_port`` on every process, the overload plane
    off) and game (DEPLOY_GAME, importing this module) in a temp dir,
    run by ``python -m goworld_tpu_torch``: ``build`` (the native
    cores), ``start`` (timed to all started; the game's log names
    ``cuda:0`` and the card), ``status`` (exit 0, the game's metrics
    scraped), GAME_BOTS strict bots in [19]'s pattern over DEPLOY_EDGES
    (TCP and KCP with snappy, WebSocket), ``reload`` (SIGHUP to exit and
    exit to started timed; the census of the freeze file, read here,
    equals the restored game's ledger on ``/audit``, type by type), the
    bots again, ``/profile?seconds=2`` (its Chrome trace holds sweep and
    sort kernel events), ``stop`` (exit 0), ``status`` (exit 1) and no
    process left; a round fails unless every login reaches an Avatar,
    the mirrors report 0 errors and equal the interest sets of the World
    at rest, every ``OnSay`` arrives, and the round's game ticks
    launched one sweep and one sort each and nothing else; it prints the
    boot ticks, the login p50 an edge and the game tick p50/p99 of the
    ``tick_latency_ms`` histogram of each round;
23. (run after 22, before 12) ``examples/test_game`` through the ops CLI
    on networked stores: the port's ``MiniMongo`` and a three-node
    ``MiniRedis`` cluster (the slots split in three) on threads of this
    process, preloaded with TG_PRELOAD Avatar documents and as many
    ``avatarOf/<name>`` keys: those of the names the bots log in with
    through ``MongoDBStorage`` and ``RedisClusterKVDB``, the rest in bulk
    (batched ``insert`` commands, pipelined ``SET``s a node, each in
    ``MongoDBStorage``'s and ``RedisClusterKVDB``'s layout and slots);
    the stock ini and ``server_torch.py`` in a temp
    dir, the ini changed only in its ports (moved to free ones), its
    stores (``[storage] kind = mongodb``, ``[kvdb] kind =
    redis_cluster``), the kernels (``aoi_sweep_impl = fused``,
    ``aoi_sort_impl = pallas`` and ``aoi_cell_cap = 28``, the largest
    cell the fused kernel takes: the default 32 it refuses) and an
    ``http_port`` on each process; the entry (TG_ENTRY) runs the stock
    script for its registrations and publishes the game's tick count,
    launch counts, placed service shards, mails, live Avatars and the
    last Avatar save it issued for each id on ``/vars``.
    ``start``; once every service shard is placed, TG_BOTS strict bots
    over TCP log in (half with preloaded names, whose logins must find
    the preloaded Avatar id, half new), subscribe to ``news.*``, one
    publishes ``news.tpu`` and every subscriber's client receives
    ``OnPublish``, each sends a mail (the MailService holds them all),
    and they leave after TG_HOLD_S s; ``reload``; every bot's Avatar is
    read back from minimongo through a fresh ``MongoDBStorage``, equal
    to the last save the first game issued for it, and overwritten with
    level 0 (which the game never writes); the same bots log in again,
    each name to the same Avatar id, and leave after TG_HOLD_S s;
    ``stop``, ``status`` 1, no process left and no traceback in a log
    but the restored game's failed service RPCs (ROADMAP C8: an
    ``AttributeError`` on the attribute the service's ``OnInit`` makes,
    counted). Then every new name's key is read back from the cluster
    through a fresh ``RedisClusterKVDB`` and every bot's Avatar from
    minimongo, equal to the last save the restored game issued for it;
    every round's game ticks launched at least one sweep and one sort
    each. It prints the preload's seconds, the login p50 of each round,
    the game tick p50/p99 of the ``tick_latency_ms`` histogram and its
    wall;
24. (run after 23, before 12) hot-standby replication and the rebalance
    plane. (a) ``goworld_tpu_torch.tools.chaos_soak.run_failover`` (the
    JAX soak's failover scenario) on the card at FAILOVER_N entities of
    the ``mixed`` scenario at the bench world's density and grid
    (``failover_build_kw``: radius 50, k 32, cell_cap 12,
    fused/pallas; the soak's skin 4 runs the gated sweep at k 48): a
    primary under churn and a migration storm streams FAILOVER_TICKS
    ticks at keyframe cadence FAILOVER_KEYFRAME through the real
    ``ReplicationWorker`` (each capture on the tick thread under the
    sync guard; the fetch, diff, disk chain and frames on the worker)
    into a live standby World (warmed by one tick when empty), the
    primary dies at the last tick, the standby promotes through the
    kvreg-arbitrated claim (both stale-claim orders refused, the
    decision log replayed byte for byte), and the promoted census must
    equal the primary's at the last applied frame (0 lost, 0
    duplicated) with the conservation verdict green, no frame torn; a
    cold restore from the worker's chain is timed beside the warm
    promotion (reported, not gated); every soak tick launches one sweep
    and one sort, and so does each promoted tick, run until no pose
    stays staged (at least FAILOVER_PROMOTED); it prints the frames'
    bytes a tick beside the client syncs', apply ms a frame p50/p99,
    keyframes, deltas, dropped captures, the lag from capture to
    applied in 60 Hz ticks against LAG_BUDGET_TICKS, the promotion in
    ticks and seconds and the ticks the staged poses took to drain.
    Then the same sequence at FAILOVER_TWIN_N on the kernels and on
    the plain versions, and at FAILOVER_CPU_N on the card and on the
    CPU port (ids from one seeded sequence): every lane of state and
    outputs, the census and the ledger equal after the promotion and
    on 3 more ticks. (b) the deployment through the ops CLI: [22]'s ini
    (a TCP gate) with ``[deployment] rebalance = true``, game1 the
    primary (STANDBY_MONSTERS Monsters, ``checkpoint_interval = 1``
    with ``snapshot_keyframe_every = 8``), game2 its standby
    (``standby_of = 1``), game3 a peer with an empty Arena that takes
    no boot entity, an ``http_port`` on each (STANDBY_GAME): ``start``,
    the standby's ``/standby`` verdict, STANDBY_BOTS strict bots log in
    and walk, ``/rebalance?handoff=3&batch=64`` on game1 (the
    dispatcher's pause lane set during the move and clear after, the
    conservation verdict over game3's and game1's ``/audit`` green at
    every read, ``rebalance_moves_total`` 64), ``kill -9`` game1 while
    it serves (its standby behind by its lag), one ``watchdog --once``
    promotes game2 (no restart of game1; ``game2_promotion.log``
    replays byte for byte), game1's chain file that a ``-restore``
    would take (the freshest) resolves (an older delta is one a later
    keyframe superseded), the bots walk on and their mirrors equal the
    interest sets of the games at rest (entities the handoff moved stay
    in their old watchers' mirrors: ROADMAP C12; entities a bot held at
    the kill that the promoted game never sent a leave for: C13; both
    counted apart), ``stop``; it prints the game ticks' p50/p99 of
    game1 before and after the handoff and of the promoted game2,
    game1's serve-loop spans a tick with the capture's share, the lag
    at the kill and the seconds from the kill to the promoted game's
    first tick.
25. (run after 24, before 12) the game of two controller processes on
    the card (``goworld_tpu_torch.parallel.multihost``: a gloo group on
    the loopback, every collective staged through pinned memory). The
    phase kernel's legs from another process (the remote blocks) held
    against its plain version at the megaspace's halo_cap in one
    process; then (a) ``make_mega_tick`` at ``mega_config(MH_MEGA_N,
    MH_DEV)`` (BASELINE config 4: 4x2 tiles, ``async``, fused/pallas)
    and [21] (a)'s ``make_multi_tick`` (8 x SPACE_N, its free rows and
    migration requests) each run MH_TICKS ticks in this process over
    all 8 shards, then as two controllers of 4 shards spawned as
    ``chip_smoke.py --mh-step`` processes on the same card; every lane
    of state and outputs of every tile, every tick, must hash (sha256)
    equal; it prints each rank's tick p50/p99 by host wall and by
    events, the cross-process legs' ms, collectives and host syncs a
    tick, the launches a controller and the one-process wall; (b)
    ``examples/multihost_demo``'s deployment through the ops CLI: its
    ini (``mesh_devices = 8``, ``mesh_processes = 2``, ``megaspace``,
    ``mega_shape = 4x2``, a checkpoint interval) widened to [21] (c)'s
    grid (radius 50, halo_cap 4096, MH_GAME_SLOTS slots a tile,
    fused/pallas, ``async``), the game (MH_GAME, importing this module)
    booting MH_GAME_MONSTERS Monsters through ``on_boot``: ``start``
    (both ranks' logs name the card), MH_GAME_BOTS strict bots log in
    along the column 1-2 border (the process boundary), half on each
    side, and walk across it MH_WALK_S; both controllers rest at one
    tick while every mirror is read against its Avatar's interest set
    (published by the controller owning its tile), which must be equal,
    with an entity of the other controller's tiles in some mirror and
    no strict error (a client message twice); each rank's game ticks
    launch one sweep and one sort a local tile and two phase kernels;
    the staging tripwire ran and saw no divergence; ``reload`` (the
    leader's freeze, both ranks restore), the bots again, ``stop``,
    ``status`` 1, no process left, no traceback in the games' logs; it
    prints start, boot, freeze and restore seconds and per round each
    rank's tick p50/p99, cross-process legs and host syncs a tick and
    the mutation log's backlog gauges.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import os
import re
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import goworld_tpu_torch as gw
from goworld_tpu_torch import interop, kernels
from goworld_tpu_torch.core import step as step_mod
from goworld_tpu_torch.core.state import WorldConfig, map_lane
from goworld_tpu_torch.core.step import (
    TickInputs,
    compute_velocity,
    make_tick,
)
from goworld_tpu_torch.entity import manager
from goworld_tpu_torch.models import npc_policy
from goworld_tpu_torch.models.npc_policy import build_obs, init_policy
from goworld_tpu_torch.ops import aoi, prng
from goworld_tpu_torch.ops.mlp import (layer_lanes, npc_mlp, npc_mlp_plain,
                                      tanh_bf16, tanh_by_table)
from goworld_tpu_torch.scenarios.spec import scenario_names
from goworld_tpu_torch.ops import telemetry as telem
from goworld_tpu_torch.ops.aoi import GridSpec, grid_neighbors_flags
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
    radix_plan,
)
from goworld_tpu_torch.parallel import halo
from goworld_tpu_torch.parallel.megaspace import (
    MegaConfig,
    tile_shifts,
    make_mega_tick,
)
from goworld_tpu_torch.utils import audit as audit_mod
from goworld_tpu_torch.utils import metrics
from goworld_tpu_torch.ops.integrate import apply_pos_inputs
from goworld_tpu_torch.parallel.mesh import make_mesh, tile_view
from goworld_tpu_torch.parallel.step import (
    MultiTickInputs,
    make_multi_tick,
)
from goworld_tpu_torch.workload import (
    POLICY_SEED,
    behavior_config,
    behavior_world,
    bench_world,
    mega_config,
    mega_world,
    mlp_underflow_case,
    multi_config,
    multi_world,
    scenario_config,
    serve_world,
    slice_config,
    uncut_config,
    uncut_world,
    underflow_world,
)

N = 1 << 20
TICKS = 24
MEGA_DEV = 4          # 2x2 tiles, as bench.py's multichip world on 4 chips
MEGA_TICKS = 16
WORLD_TICKS = 16
# cut from 8, with TWIN_N and RESTORE_N, to keep the run with [21]
# inside its limit (PERF.md §4)
STRESS_TICKS = 4
# [11]'s World at its defaults, sampled so that samples land inside its
# timed ticks
PLANES = dict(residency_sample_every=4, audit_sample_every=8)
# [11]'s population in its World of N slots: a quarter of them (was N -
# 4096, whose boot took 213-283 s of the run, then half; cut each time
# so that the run stays inside its limit with the phases added since:
# PERF.md §4). Its 1% players take the 4096 client syncs a tick.
WORLD_POP = N // 4
# [12] reads a whole tick's device time over PROFILE_TICK_REPS calls, a
# kernel's over PROFILE_KERNEL_REPS
PROFILE_TICK_REPS = 5
PROFILE_KERNEL_REPS = 20
TWIN_N = 1 << 15
TWIN_TICKS = 8
VERLET_TICKS = 64     # ~24 ticks between displacement rebuilds at skin 4
Q16_TICKS = 32
FLOAT_N = 4096
FLOAT_TICKS = 8
# [15] several Spaces on one card: 8 x 2^17 = 2^20 entities, BASELINE's
# 1M target as 8 Spaces
SPACES = 8
SPACE_N = 1 << 17
# [15]'s served World of SPACES Spaces: 2^14 slots a Space (was 2^17,
# whose ~1M-entity boot took 159 s of the run, PERF.md §4); cut so
# that the run, with [18] at 2^20, stays inside its time limit
SPACE_WORLD_N = 1 << 14
SPACE_TICKS = 24
SEED = 0
# [17] behaviors and scenarios
BEHAVIOR_TICKS = 24
MIXED_TICKS = 16
SCN_N = 4096
SCN_TICKS = 4
BEHAVIOR_WORLD_N = 1 << 16
BEHAVIOR_WORLD_TICKS = 4
# [20] this slice: behaviors and scenarios on several Spaces, q16 under
# the policy, the shift/cellrow sweeps and approx
SLICE_TICKS = 16
SLICE_LOCKSTEP = 2
SLICE_FLOAT_SPACES = 3
SLICE_WORLD_TICKS = 8
SLICE_TWIN_N = 1 << 13   # SERVE_SPARE (4096) of each Space stay free
SLICE_TWIN_TICKS = 4
SLICE_Q16_TICKS = 16
# [18] the World's remaining planes
RESTORED_TICKS = 4
# [18] restores the first RESTORE_N records of the resolved delta (of
# WORLD_POP) into its World of 2^20 slots
RESTORE_N = 1 << 18
GOVERNOR_SWAPS = ["skin=0", "sweep=table,skin=0", "sort=counting,skin=0",
                  "default"]
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the
# float32 CUDA-core rate (used for the kernels' 32-bit integer work too)
# and the dense bf16 tensor-core rate (the policy's bf16 products)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def visits_every_row(fh) -> bool:
    """Whether the sorted view's first n slot ids (n rows, before the
    3*cell_cap sentinel lanes) are a permutation of [0, n), in each
    Space under a leading Space axis: the fused kernel walks its rows by
    them and writes only the rows they name."""
    n = fh.srow.shape[-1]
    ids = torch.sort(fh.s_w[..., :n] >> fh.code[0], dim=-1).values
    return bool((ids == torch.arange(n, dtype=ids.dtype,
                                     device=ids.device)).all())


def sweep_work(fh, dem, k: int, cc: int) -> tuple[int, float, int]:
    """(bytes, operations, in-range candidates) of one fused sweep call
    on these inputs: each input read once and each output written once;
    5 distance, 3 validity and 6 key-pack operations per in-range
    candidate (a run's lanes up to 3*cell_cap), and d*log2(d) compares
    to order a row's d valid keys."""
    n, q = fh.srow.numel(), fh.lo.numel() // 3
    nbytes = (12 * fh.s_w.numel() + 24 * q + 12 * n + 4 * n  # in
              + 4 * k * q + 4 * q)                           # out
    cand = int(torch.clamp(fh.hi - fh.lo, 0, 3 * cc).sum())
    d = dem.double()
    nops = 14 * cand + float((d * torch.log2(d.clamp_min(1))).sum())
    return nbytes, nops, cand


def bound(nbytes, nops, peak_ops=PEAK_OPS_S):
    """(least ms, what bounds it) against the card's peaks, the
    operations at ``peak_ops`` a second."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

def same_bits(a, b) -> bool:
    """Bit-for-bit equality (float lanes compared as their bits)."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def words(t: torch.Tensor) -> torch.Tensor:
    """A lane's 32-bit words (float lanes as their bits) as int64."""
    return (t.view(torch.int32) if t.is_floating_point() else t).long()


def lanes(obj) -> dict:
    """The tensor lanes of a state or outputs dataclass, nested ``base``
    flattened."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in lanes(v).items()})
        else:
            out[f.name] = v
    return out


def phase_cases(dev, h: int, m: int):
    """(label, src, strips, out, col0) of ship phases at halo_cap h over
    m own rows a tile: both 2D phases at 2x2 and 4x2, the 1D phase of 8
    tiles and one tile shipping to itself (shift 0, both segments), each
    with the layout's receivers, all and none, and counts of 0, H, > H
    and random. Lanes hold NaN payloads, -0.0 and infinities and gids up
    to ``meta_gid_bound()``; the block's columns [0, col0) hold an earlier
    phase's rows (the second segment) and flat rows past each count are
    garbage the kernel must not read."""
    one = (halo.Ring(1, (True,)), halo.Ring(-1, (True,)))
    layouts = {
        "2x2-x": (4, halo.rings_2d(2, 2)[0], 0, 4 * h),
        "2x2-z": (4, halo.rings_2d(2, 2)[1], 2 * h, 4 * h),
        "4x2-x": (8, halo.rings_2d(4, 2)[0], 0, 4 * h),
        "4x2-z": (8, halo.rings_2d(4, 2)[1], 2 * h, 4 * h),
        "1d8": (8, halo.rings_1d(8), 0, 2 * h),
        "one-tile": (1, one, 0, 2 * h),
        "one-tile-z": (1, one, 2 * h, 4 * h),
    }
    rng = np.random.default_rng(SEED + 21)
    bound = halo.meta_gid_bound()
    special = np.array([0x7FC01234, 0xFFA00001, 0x80000000, 0x7F800000,
                        0xFF800000, 0x00000001], np.uint32)

    def f32(shape):
        x = rng.normal(0, 1e4, shape).astype(np.float32)
        bits = x.reshape(-1).view(np.uint32)
        bits[rng.choice(bits.size, 64, replace=False)] = np.resize(special,
                                                                   64)
        return x

    def lanes(n_dev, rows, with_valid):
        gid = rng.integers(0, bound + 1, (n_dev, rows)).astype(np.int32)
        gid.reshape(-1)[:2] = [bound, 0]
        out = [f32((n_dev, rows, 3)), f32((n_dev, rows)),
               rng.random((n_dev, rows)) < 0.5]
        if with_valid:
            out.append(rng.random((n_dev, rows)) < 0.7)
        return [torch.tensor(x, device=dev) for x in (*out, gid)]

    for name, (n_dev, rings, col0, g) in layouts.items():
        src, out = lanes(n_dev, m, False), lanes(n_dev, g, True)
        for recv in ("layout", "all", "none"):
            rs = rings if recv == "layout" else tuple(
                halo.Ring(r.shift, (recv == "all",) * n_dev) for r in rings)
            for counts in ("random", "zero", "full", "over"):
                strips = []
                for ring in rs:
                    cnt = {"random": rng.integers(0, 3 * h // 2, n_dev),
                           "zero": np.zeros(n_dev, np.int64),
                           "full": np.full(n_dev, h),
                           "over": rng.integers(h + 1, m + col0 + 1, n_dev),
                           }[counts]
                    flat = rng.integers(-5, 10 ** 6, (n_dev, h + 1)) \
                        .astype(np.int32)
                    for t in range(n_dev):
                        take = min(int(cnt[t]), h)
                        flat[t, :take] = np.sort(rng.choice(
                            m + col0, take, replace=False))
                    strips.append((ring, torch.tensor(flat, device=dev)[:, :h],
                                   torch.tensor(cnt.astype(np.int32),
                                                device=dev)))
                yield f"{name}/{recv}/{counts}", src, strips, out, col0


def halo_parity(dev, mc: MegaConfig) -> None:
    """[7] the phase kernel against its plain version, then the 1D and
    2D exchanges under both impls."""
    h = mc.halo_cap
    n_cases = 0
    n_packs = 0
    for label, src, strips, out, col0 in phase_cases(dev, h, 4 * h):
        got = [o.clone() for o in out]
        want = [o.clone() for o in out]
        kernels.reset_launches()
        halo.ship_phase(src, strips, got, col0)
        halo.ship_phase_plain(src, strips, want, col0)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["halo_ship_phase"] != 1:
            fail(f"ship_phase launched {kernels.LAUNCHES} ({label})")
        for name, a, b in zip(("gpos", "gyaw", "gdirty", "gvalid", "ggid"),
                              got, want):
            if not same_bits(a, b):
                fail(f"phase kernel != plain in {name} ({label}, h={h})")
        n_cases += 1
        if "/layout/" in label:
            # the pack mode: every tile's strip of both directions as
            # the words a leg across processes ships
            n_dev = src[0].shape[0]
            slots = [[k * n_dev + t for t in range(n_dev)] for k in (0, 1)]
            ghosts = (out[0], out[1], out[2], out[4])
            kernels.reset_launches()
            words = halo.pack_legs(src, strips, slots, 2 * n_dev, ghosts,
                                   col0)
            plain = halo.pack_legs_plain(src, strips, slots, 2 * n_dev,
                                         ghosts, col0)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["halo_ship_phase"] != 1 \
                    or not same_bits(words, plain):
                fail(f"the phase kernel's pack mode != plain ({label}, "
                     f"h={h}, {kernels.LAUNCHES['halo_ship_phase']} "
                     "launches)")
            n_packs += 1
    names = ("gpos", "gyaw", "gdirty", "gvalid", "ggid", "strip_demand")
    # the 2D exchange at the megaspace shape
    st, _ = mega_world(mc, N, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    dirty = (torch.rand(st.alive.shape, generator=gen, device=dev) < 0.5) \
        & st.alive
    yaw = torch.rand(st.yaw.shape, generator=gen, device=dev) * 6.0 - 3.0
    visible = st.alive & (st.aoi_radius > 0.0)
    outs, launches = {}, {}
    for impl in halo.HALO_IMPLS:
        kernels.reset_launches()
        outs[impl] = halo.exchange_halo_2d(
            mc.shape, mc.cfg.capacity, st.pos, yaw, dirty, visible,
            mc.tile_w, mc.tile_d, mc.cfg.grid.radius, mc.halo_cap, impl=impl)
        launches[impl] = kernels.LAUNCHES["halo_ship_phase"]
    for name, a, b in zip(names, outs["async"], outs["ppermute"]):
        if not same_bits(a, b):
            fail(f"exchange_halo_2d {name}: async != ppermute")
    per_tile = outs["async"][3].sum(1).tolist()
    if min(per_tile) == 0:
        fail(f"a tile received no ghosts: {per_tile}")
    # the 1D exchange over 8 x-strip tiles of 32,768 entities
    n1, w1, r1 = 1 << 15, 1000.0, 50.0
    pos1 = torch.rand((8, n1, 3), generator=gen, device=dev) * w1
    pos1[..., 0] += torch.arange(8, device=dev)[:, None] * w1
    dirty1 = torch.rand((8, n1), generator=gen, device=dev) < 0.5
    alive1 = torch.rand((8, n1), generator=gen, device=dev) < 0.9
    yaw1 = torch.rand((8, n1), generator=gen, device=dev) * 6.0 - 3.0
    outs1 = {}
    for impl in halo.HALO_IMPLS:
        kernels.reset_launches()
        outs1[impl] = halo.exchange_halo(8, pos1, yaw1, dirty1, alive1, w1,
                                         r1, h, impl=impl)
        launches[f"{impl} 1d"] = kernels.LAUNCHES["halo_ship_phase"]
    for name, a, b in zip(names, outs1["async"], outs1["ppermute"]):
        if not same_bits(a, b):
            fail(f"exchange_halo {name}: async != ppermute")
    if not outs1["async"][3].any(1)[1:-1].all():
        fail("an inner 1D tile received no ghosts")
    want = {"async": 2, "ppermute": 0, "async 1d": 1, "ppermute 1d": 0}
    if launches != want:
        fail(f"phase kernel launches a call {launches}, want {want}")
    print(f"[7] halo: phase kernel == plain bit for bit in {n_cases} cases "
          f"(its pack mode in {n_packs} of them, every tile's words) "
          f"(2x2 and 4x2 phases x/z, 8 tiles 1D, one tile to itself; "
          f"receivers of the layout/all/none; counts random/0/H/>H; NaN, "
          f"-0.0, inf words; gids to {halo.meta_gid_bound()}; h={h}); "
          f"exchange_halo_2d async == ppermute on every output at the "
          f"megaspace shape, ghosts per tile {per_tile}, strip_demand "
          f"{outs['async'][5].tolist()}; exchange_halo (8 tiles) async == "
          f"ppermute; launches a call {launches}", flush=True)


def mega_path(dev, mc: MegaConfig, tag: str) -> dict:
    """[8] the megaspace path, [9] the sweep at Q < n and the ship's
    times; returns the ship kernel's row of the kernels line."""
    n = mc.cfg.capacity
    g = mc.cfg.grid
    n_dev = mc.n_dev
    st0, inputs = mega_world(mc, N, SEED, dev)
    tick = make_mega_tick(mc, device=dev)
    # one untimed tick in which any op that makes the host wait on the
    # card raises
    torch.cuda.set_sync_debug_mode("error")
    tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(MEGA_TICKS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(MEGA_TICKS)]
    gauges, first, snapshot = [], None, None
    st = st0
    kernels.reset_launches()
    wall0 = time.perf_counter()
    for t in range(MEGA_TICKS):
        if t == MEGA_TICKS // 2:
            snapshot = st
        starts[t].record()
        st, out = tick(st, inputs)
        ends[t].record()
        if t == 0:
            first = out
        b = out.base
        gauges.append(torch.stack([
            b.enter_n.sum(), b.sync_n.min(), b.sync_n.sum(),
            out.arr_n.sum(), out.migrate_dropped.sum(),
            out.halo_demand.max(), out.global_alive.min(),
            out.global_alive.max(), out.migrate_demand.max(),
            b.leave_n.sum(), b.aoi_over_k_rows.sum(),
            b.aoi_over_cap_cells.sum()]).to(torch.int64))
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = dict(kernels.LAUNCHES)
    want = {"sweep_fused": n_dev * MEGA_TICKS,
            "counting_sort": n_dev * MEGA_TICKS,
            "halo_ship_phase": 2 * MEGA_TICKS, "npc_mlp": 0}
    if launches != want:
        fail(f"megaspace launches {launches} in {MEGA_TICKS} ticks, want "
             f"{want}")
    gv = torch.stack(gauges).cpu().numpy()
    (enter, sync_min, sync_sum, arr, dropped, hdem, ga_min, ga_max,
     mdem, leave, over_k, over_cap) = gv.T
    if enter[0] <= 0:
        fail("no enter events on tick 1")
    if (sync_min <= 0).any():
        fail("a tile produced no sync records in some tick")
    if (dropped != 0).any():
        fail(f"migrate_dropped {dropped.tolist()}")
    if (hdem > mc.halo_cap).any():
        fail(f"halo_demand {hdem.tolist()} over halo_cap {mc.halo_cap}")
    if (ga_min != N).any() or (ga_max != N).any():
        fail(f"global_alive left {N}: {ga_min.tolist()} {ga_max.tolist()}")
    ej, en = first.base.enter_j, first.base.enter_n
    live = torch.arange(ej.shape[1], device=dev)[None, :] < en[:, None]
    d_idx = torch.arange(n_dev, device=dev)[:, None]
    cross = int((live & (ej >= 0) & (ej // n != d_idx)).sum())
    if cross <= 0:
        fail("no ghost entered any tile's AOI on tick 1")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    arrived = int(arr.sum())
    migr = (f"arrivals {arrived} over the run" if arrived > 0 else
            f"no arrival over the run (migrate_demand max "
            f"{int(mdem.max())}, halo_demand max {int(hdem.max())})")
    ms = np.array([a.elapsed_time(b) for a, b in zip(starts, ends)])
    steady = ms[1:]
    p50 = float(np.percentile(steady, 50))
    p99 = float(np.percentile(steady, 99))

    # one tick again on the plain versions, same input state
    st_k, out_k = tick(snapshot, inputs)
    plain = dataclasses.replace(mc, halo_impl="ppermute", cfg=dataclasses
                                .replace(mc.cfg, grid=dataclasses.replace(
                                    g, sweep_impl="ranges",
                                    sort_impl="counting")))
    st_p, out_p = make_mega_tick(plain, device=dev)(snapshot, inputs)
    for what, a, b in (("state", st_k, st_p), ("output", out_k, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"megaspace {what} lane {name}: kernels != plain "
                     f"versions")
    print(f"[8] megaspace path: {MEGA_TICKS} ticks of {N} entities on "
          f"{mc.shape[0]}x{mc.shape[1]} tiles (capacity {n} a tile, "
          f"halo_cap {mc.halo_cap}), launches {launches} "
          f"({ {k: v / MEGA_TICKS for k, v in launches.items()} } a tick); "
          f"tick 1 enter_n={int(enter[0])} (cross-tile {cross}) "
          f"sync_n={int(sync_sum[0])}; last tick sync_n={int(sync_sum[-1])}"
          f" leave_n={int(leave[-1])}; {migr}; halo_demand max "
          f"{int(hdem.max())}; migrate_dropped 0; global_alive {N} every "
          f"tick; AOI over_k_rows max {int(over_k.max())} over_cap_cells "
          f"max {int(over_cap.max())}; tick {MEGA_TICKS // 2 + 1} "
          f"bit-identical on ppermute+ranges+counting; one tick under the "
          f"sync guard; ms/tick p50={p50:.3f} p99={p99:.3f} (ticks "
          f"2-{MEGA_TICKS}, CUDA events) wall "
          f"{wall * 1e3 / MEGA_TICKS:.3f} ms/tick; "
          f"{N / (p50 / 1e3):.4g} entity-ticks/s {tag}", flush=True)

    # [9] the fused sweep at the megaspace shape: tile 0's local rows
    # query local + ghost rows
    gen = torch.Generator(device=dev).manual_seed(9)
    dirty = (torch.rand(st.alive.shape, generator=gen, device=dev) < 0.5) \
        & st.alive
    visible = st.alive & (st.aoi_radius > 0.0)
    gpos, gyaw, gdirty, gvalid, ggid, _ = halo.exchange_halo_2d(
        mc.shape, n, st.pos, st.yaw, dirty, visible, mc.tile_w, mc.tile_d,
        g.radius, mc.halo_cap, impl="async")
    shifts = tile_shifts(mc, dev)
    pos_ext = torch.cat([st.pos[0], gpos[0]]) - shifts[0]
    ghosts = gpos.shape[1]
    flags = torch.cat([dirty[0], gdirty[0]]).to(torch.int32) | (torch.cat([
        st.has_client[0], torch.zeros(ghosts, dtype=torch.bool, device=dev)
    ]).to(torch.int32) << 1)
    wr = torch.cat([st.aoi_radius[0], torch.full(
        (ghosts,), float("inf"), device=dev)])
    fh = aoi.front_half(g, pos_ext, torch.cat([st.alive[0], gvalid[0]]), n,
                        wr, flags, with_stats=True)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, pos_ext, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    torch.cuda.synchronize()
    if not (fh.lo.shape[0] == n < pos_ext.shape[0]):
        fail("the megaspace sweep check did not run Q < n")
    if not visits_every_row(fh):
        fail("the megaspace tile's sorted slot ids are not a permutation "
             "of its local + ghost rows")
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(1).sum())
        fail(f"fused sweep at Q={n} < n={pos_ext.shape[0]} differs from "
             f"its plain version in {bad} rows")
    tile_sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)

    # the phase kernel's times at the megaspace shape: the two phases of
    # one exchange of this state, captured at the wrapper
    phases = []

    def capture(*a):
        phases.append(a[:4])    # one controller: the default placement
        ship(*a)

    ship = halo.ship_phase
    halo.ship_phase = capture
    try:
        exchange = (mc.shape, n, st.pos, st.yaw, dirty, visible, mc.tile_w,
                    mc.tile_d, g.radius, mc.halo_cap)
        halo.exchange_halo_2d(*exchange, impl="async")
    finally:
        halo.ship_phase = ship
    if [p[3] for p in phases] != [0, 2 * mc.halo_cap]:
        fail(f"exchange_halo_2d shipped phases at columns "
             f"{[p[3] for p in phases]}")
    plain_out = [o.clone() for o in phases[0][2]]
    for src, strips, out, col0 in phases:
        ship(src, strips, out, col0)
        halo.ship_phase_plain(src, strips, plain_out, col0)
    torch.cuda.synchronize()
    err = max(int((words(a) - words(b)).abs().max())
              for a, b in zip(phases[0][2], plain_out))
    if err != 0:
        fail("phase kernel differs from its plain version at timing inputs")

    def both(fn):
        return lambda: [fn(*p) for p in phases]

    def exchange_with(impl):
        return lambda: halo.exchange_halo_2d(*exchange, impl=impl)

    # events first: ms a phase (a call), the plain version, one exchange
    # under each impl; torch.roll of one packed phase-1 strip buffer, only
    # as context
    ship_ms = time_ms(both(ship), 100) / 2
    ship_plain = time_ms(both(halo.ship_phase_plain), 20) / 2
    ex = {impl: {"ms": time_ms(exchange_with(impl), 50)}
          for impl in halo.HALO_IMPLS}
    h = mc.halo_cap
    gp, gy, gd, gv, gg = phases[0][2]
    bufs = halo._pack_strip(gp[:, :h], gy[:, :h], gd[:, :h], gv[:, :h],
                            gg[:, :h])
    roll_ms = time_ms(lambda: torch.roll(bufs, mc.shape[1], 0), 200)
    # bytes a phase needs: every live row's flat word, pos, dirty and gid
    # (and yaw where dirty) read once, the counts, and every row of the
    # phase's 2H columns of the five lanes written (22 B)
    nbytes = 0
    for _, strips, out, col0 in phases:
        cols = slice(col0, col0 + 2 * h)
        live = int(out[3][:, cols].sum())
        nbytes += live * (4 + 12 + 1 + 4) + int(out[2][:, cols].sum()) * 4 \
            + 2 * n_dev * 4 + n_dev * 2 * h * 22
    bms, by = bound(nbytes / 2, n_dev * 2 * h)
    print(f"[9] fused sweep == plain at the megaspace shape (Q={n} local "
          f"queries over n={pos_ext.shape[0]} local + ghost rows, tile 0), "
          f"{tile_sweep_ms:.5f} ms a call; phase kernel {ship_ms:.5f} ms a "
          f"call, plain {ship_plain:.5f} ms, bound "
          f"{bms:.6f} ms ({by}; {nbytes / 2:.0f} B a phase); one "
          f"exchange_halo_2d a call: " + ", ".join(
              f"{impl} {r['ms']:.5f} ms" for impl, r in ex.items())
          + f"; torch.roll of a "
          f"packed strip i32{list(bufs.shape)} {roll_ms:.5f} ms (context); "
          f"device times in [12] {tag}", flush=True)
    row = {
        "name": "ship_phase", "route": "cuda",
        "source": "goworld_tpu_torch/csrc/halo_ship.cu",
        "replaces": "goworld_tpu/parallel/halo.py:91",
        "launches": launches["halo_ship_phase"],
        "launches_per_tick": launches["halo_ship_phase"] / MEGA_TICKS,
        "max_abs_err": err,
        "ms": ship_ms, "device_ms": None, "launches_per_call": None,
        "plain_ms": ship_plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None,
        "library_note": "no one PyTorch call ships a phase (gather, ring "
                        "shift, fill and in-place write); the yardstick is "
                        "one async exchange_halo_2d",
        "exchange": ex,
        "roll_ms_context": roll_ms,
    }

    def read_device() -> str:
        """The ship's, the exchanges' and the tile sweep's device times
        (torch.profiler), read in [12] after every timed path."""
        row["device_ms"], row["launches_per_call"] = (
            x / 2 for x in kernels.device_ms(both(ship), 50))
        for impl, r in ex.items():
            r["device_ms"], r["kernels_per_call"] = kernels.device_ms(
                exchange_with(impl), 20)
        sweep_dev, sweep_lpc = kernels.device_ms(
            lambda: aoi.sweep_fused_cuda(*args), 20)
        return (f"megaspace tile sweep {sweep_dev:.5f} ms ({sweep_lpc:g} "
                f"kernels); phase kernel "
                f"{row['device_ms'] * 1e3:.2f} us a call in "
                f"{row['launches_per_call']:g} kernel; one exchange_halo_2d "
                + ", ".join(f"{impl} {r['device_ms']:.5f} ms in "
                            f"{r['kernels_per_call']:g} kernels"
                            for impl, r in ex.items()))

    return row, read_device


def device_times(profiled: dict, rows: list, plan) -> tuple[dict, str]:
    """Fill the rows' ``device_ms`` and ``launches_per_call`` from
    torch.profiler and check the launches a call. A profiler session
    leaves the card's profiling interface attached, which slows every
    later launch of the host-bound ticks, so every profiled read runs
    here, after every timed path. Each read keeps a session only where
    its marker kernels show that it lost no event of the calls, and
    takes it again with a longer lead where it did (``kernels.device_ms``)."""
    got = {name: kernels.device_ms(
        fn, PROFILE_TICK_REPS if "tick" in name else PROFILE_KERNEL_REPS)
        for name, fn in profiled.items()}
    for row in rows:
        row["device_ms"], row["launches_per_call"] = got[row["name"]]
    sweep_lpc = got["sweep_fused_cuda"][1]
    sort_lpc = got["counting_sort_cells_cuda"][1]
    if sweep_lpc != 1 or sort_lpc > plan[0] + 1:
        fail(f"kernel launches a call: sweep {sweep_lpc}, sort {sort_lpc} "
             f"(plan {plan} allows {plan[0] + 1})")
    return got, ", ".join(f"{name} {ms:.5f} ms ({lpc:g} kernels)"
                          for name, (ms, lpc) in got.items())


def small_oracle(dev) -> None:
    """[10] 2x2 tiles of 4096 entities, below every cap: after each of 3
    ticks every tile's interest lists equal a brute-force search over
    all tiles, in the watcher tile's shifted float32 frame as the sweep
    computes it. A few entities sit around the corner point so that
    pairs cross every kind of border."""
    r, tw, per = 50.0, 1200.0, 4096
    cap = per + 512
    grid = GridSpec(radius=r, extent_x=tw + 2 * r, extent_z=tw + 2 * r,
                    k=64, cell_cap=28, row_block=cap, sweep_impl="fused",
                    sort_impl="pallas", topk_impl="sort", skin=0.0)
    cfg = WorldConfig(capacity=cap, grid=grid, npc_speed=5.0,
                      enter_cap=65536, leave_cap=65536, sync_cap=65536,
                      attr_sync_cap=4096, input_cap=4096,
                      delta_rows_cap=65536)
    mc = MegaConfig(cfg=cfg, n_dev=4, tile_w=tw, halo_cap=512,
                    migrate_cap=256, mesh_shape=(2, 2), tile_d=tw,
                    halo_impl="async")
    st, inputs = mega_world(mc, 4 * per, SEED + 3, dev)
    rng = np.random.default_rng(SEED + 4)
    pos = st.pos.cpu().numpy()
    for d in range(4):
        sx, sz = (1 if d // 2 else -1), (1 if d % 2 else -1)
        pos[d, 300:308, 0] = tw + sx * rng.uniform(1, 20, 8)
        pos[d, 300:308, 2] = tw + sz * rng.uniform(1, 20, 8)
    st = st.replace(pos=torch.tensor(pos, device=dev))
    tick = make_mega_tick(mc, device=dev)
    shifts = tile_shifts(mc, dev).cpu().numpy()
    kinds = {"x": 0, "z": 0, "corner": 0}
    rows = 0
    for _ in range(3):
        st, out = tick(st, inputs)
        b = out.base
        if int(b.aoi_over_k_rows.sum()) or int(b.aoi_over_cap_cells.sum()) \
                or int(out.halo_demand.max()) > mc.halo_cap \
                or int(out.migrate_dropped.sum()) \
                or int(out.migrate_demand.max()) > mc.migrate_cap:
            fail("small oracle megaspace hit a cap")
        pos = st.pos.cpu().numpy()
        alive = st.alive.cpu().numpy()
        nbr = st.nbr.cpu().numpy()
        cnt = st.nbr_cnt.cpu().numpy()
        gid = np.arange(4)[:, None] * cap + np.arange(cap)[None, :]
        all_pos, all_gid = pos[alive], gid[alive]
        for d in range(4):
            other = all_pos - shifts[d]
            mine = pos[d] - shifts[d]
            for i in range(cap):
                got = nbr[d, i, :cnt[d, i]]
                if not alive[d, i]:
                    if cnt[d, i] or (nbr[d, i] != mc.gid_sentinel).any():
                        fail(f"dead slot {d}:{i} has neighbors")
                    continue
                near = np.maximum(np.abs(other[:, 0] - mine[i, 0]),
                                  np.abs(other[:, 2] - mine[i, 2])) \
                    <= np.float32(r)
                want = np.sort(all_gid[near & (all_gid != d * cap + i)])
                if not np.array_equal(got, want):
                    fail(f"tile {d} slot {i}: {len(got)} neighbors, oracle "
                         f"{len(want)}")
                rows += 1
                e = want // cap
                ex, ez = e // 2 != d // 2, e % 2 != d % 2
                kinds["x"] += int((ex & ~ez).sum())
                kinds["z"] += int((~ex & ez).sum())
                kinds["corner"] += int((ex & ez).sum())
    if min(kinds.values()) == 0:
        fail(f"the oracle world lacks a kind of border pair: {kinds}")
    print(f"[10] small megaspace oracle: 2x2 tiles of {per}, 3 ticks, "
          f"{rows} interest lists equal the brute force; cross-tile pairs "
          f"{kinds}", flush=True)

def peak_rss_mb() -> float:
    """This process's peak resident memory, MB (Linux reports KB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mb() -> float:
    """This process's resident memory now, MB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * resource.getpagesize() / 2**20


def release_worlds() -> None:
    """Collect the Worlds just dropped: ``serve_world`` froze them out
    of the collector, as a game server does at boot, so they are handed
    back and collected here, outside every timed or profiled run."""
    gc.unfreeze()
    gc.collect()


def first_space(obj):
    """The one Space's lanes of a World's stacked state or outputs."""
    return type(obj)(**{f.name: map_lane(getattr(obj, f.name),
                                         lambda t: t[0])
                        for f in dataclasses.fields(obj)})


def world_ticks(served, n_ticks: int, teleport: bool,
                mlp: bool = False, want: dict | None = None,
                after=None) -> tuple[list, dict]:
    """``n_ticks`` of staged traffic (walking syncs, or with ``teleport``
    the stress stream) and ``World.tick``; (per tick: wall s, span s,
    decoded and true counts, whether it took an audit sample; launch
    counts of the run). Every tick must launch the sweep and the sort
    once each (and ``npc_mlp`` once under ``mlp``; or ``want``) and
    deliver what the World decoded; ``after()`` runs after each tick.
    A World on a mesh reads its step's ``base`` outputs, and its alive
    rows are its entities with slots less the source rows of this
    tick's migrations (owned until their leave events decode)."""
    w = served.world
    rows = []
    kernels.reset_launches()
    for t in range(n_ticks):
        staged = served.stage(teleport=teleport)
        before = dict(kernels.LAUNCHES)
        sample = w.audit is not None and w.audit.want_sample(w.tick_count)
        t0 = time.perf_counter()
        w.tick()
        wall = time.perf_counter() - t0
        got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if got != (want or {"sweep_fused": 1, "counting_sort": 1,
                            "halo_ship_phase": 0, "npc_mlp": int(mlp)}):
            fail(f"World.tick {t + 1} launched {got}")
        out, ops, sink = w.last_outputs, w.op_stats, served.sink.take()
        mesh_out = out
        out = getattr(out, "base", out)
        if sink["sync_records"] != ops["sync_records_sent"] or \
                sink["sync_records"] <= 0:
            fail(f"World.tick {t + 1}: sync sink got "
                 f"{sink['sync_records']}, decode sent "
                 f"{ops['sync_records_sent']}")
        owned = [len(o) for o in w._slot_owner]
        # a pipelined World has decoded the previous tick's outputs,
        # while its slots hold this tick's creates (checked after its
        # drain by the caller)
        if w.mesh is not None:
            if int(mesh_out.global_alive[0]) != sum(owned) \
                    - len(w._release_now):
                fail(f"World.tick {t + 1}: {int(mesh_out.global_alive[0])}"
                     f" alive rows for {sum(owned)} entities with slots "
                     f"less {len(w._release_now)} departed")
        elif not w.pipeline_decode and out.alive_count.tolist() != owned:
            fail(f"World.tick {t + 1}: {out.alive_count.tolist()} alive "
                 f"rows for {owned} entities with slots")
        cfg = w.cfg

        def to_cap(lane, cap):
            # decodable (each Space's count up to its cap) and true
            v = getattr(out, lane)
            return int(np.minimum(v, cap).sum()), int(v.sum())

        migrated = None
        if "migrations" in staged:
            migrated = served.migrated()
            if migrated != staged["migrations"] or w._staged_migrate:
                fail(f"World.tick {t + 1}: {migrated} of "
                     f"{staged['migrations']} staged migrations applied")
        if after is not None:
            after()
        rows.append(dict(
            wall=wall, staged=staged, sample=sample, migrated=migrated,
            spans={name: d for name, _, d, _ in
                   metrics.timeline.records()[-1][2]},
            sync=(ops["sync_records_sent"], *to_cap("sync_n", cfg.sync_cap)),
            enter=(ops["aoi_enter_decoded"],
                   *to_cap("enter_n", cfg.enter_cap)),
            leave=(ops["aoi_leave_decoded"],
                   *to_cap("leave_n", cfg.leave_cap)),
            delta_rows=int(out.delta_rows_n.max()),
            messages=sink["messages"]))
    if min(r["enter"][0] for r in rows) <= 0 or any(
            r[k][0] > r[k][1] for r in rows for k in ("sync", "enter",
                                                     "leave")):
        fail("the World decoded no enters, or more than the outputs hold")
    return rows, dict(kernels.LAUNCHES)


def world_summary(rows: list, cfg) -> str:
    """``World.tick`` p50/p99 over ticks 2.., the ticks that took an
    audit sample and the ticks after them apart, the mean of its spans,
    and the records, events and changed interest rows a tick."""
    steady = rows[1:]
    wall = np.array([r["wall"] for r in steady]) * 1e3
    sampled = np.array([r["sample"] for r in steady])
    after = np.array([r["sample"] for r in rows[:-1]])
    spans = {k: float(np.mean([r["spans"][k] for r in steady])) * 1e3
             for k in steady[0]["spans"]}
    fetch = np.array([r["spans"]["fetch_outputs"] for r in steady]) * 1e3
    mean = {k: " / ".join(map(str, np.mean([r[k] for r in steady], axis=0)
                               .round(1).tolist()))
            for k in ("sync", "enter", "leave")}
    dr = [r["delta_rows"] for r in steady]
    return (f"World.tick wall p50={np.percentile(wall, 50):.3f} "
            f"p99={np.percentile(wall, 99):.3f} ms (ticks 2-{len(rows)}); "
            f"audit-sample ticks {np.round(wall[sampled], 3).tolist()} ms,"
            f" the ticks after them "
            f"{np.round(wall[after & ~sampled], 3).tolist()} ms, the rest "
            f"{pct(wall, ~sampled & ~after)} ms; fetch_outputs on the "
            f"sample ticks (their audit planes ride it) "
            f"{np.round(fetch[sampled], 3).tolist()} ms, on the rest "
            f"mean {fetch[~sampled].mean():.3f} ms; "
            f"mean span ms " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in spans.items())
            + f"; a tick (mean of 2-{len(rows)}), decoded / to cap / true: "
            f"sync records {mean['sync']}, enters {mean['enter']}, leaves "
            f"{mean['leave']}; rows whose interest list changed (the most "
            f"of a Space) mean {np.mean(dr):.1f} max {max(dr)} of "
            f"delta_rows_cap {cfg.delta_rows_cap}; client messages of the "
            f"last tick {rows[-1]['messages']}")


def event_timed(fn, events: list, keep: dict | None = None):
    """``fn`` with CUDA events recorded around each call into ``events``
    (and its last arguments into ``keep``)."""
    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        events.append((a, b))
        if keep is not None:
            keep["args"] = args
        return out

    return timed


def event_ms(events: list) -> str:
    ms = np.array([a.elapsed_time(b) for a, b in events])
    return (f"mean {ms.mean():.5f} p50 {np.percentile(ms, 50):.5f} max "
            f"{ms.max():.5f} ms over {ms.size} calls")


def unkeyed(sig: dict | None) -> dict | None:
    """A signature less its kernel-config key (twins differ in it)."""
    return None if sig is None else {k: v for k, v in sig.items()
                                     if k != "config"}


def audit_state(w) -> dict:
    """The audit plane's counts once its worker is idle."""
    w.audit.drain()
    snap = w.audit.snapshot(tick=w.tick_count)
    return dict(oracle=snap["oracle"], probes=snap["probes"],
                violations=snap["violations_total"],
                dropped=snap["samples_dropped"])


def planes_check(w, label: str) -> str:
    """[11]'s and [15]'s checks of the planes of a World at its
    defaults: the lanes account for every tick (rebuilt sums to the tick
    count, occupancy to it times the Spaces, per_tile is the host's
    count of entities with slots in each Space), a
    signature is served, every audit sample judged its cohort with 0
    mismatches and 0 violations, and the census reads 0 re-allocated
    lanes."""
    lanes = w._telem_lanes
    ticks = w.tick_count
    # occupancy takes one sample a Space a tick
    for lane, per in (("rebuilt", 1), ("occupancy", w.n_spaces)):
        if sum(lanes[lane]["counts"]) != ticks * per:
            fail(f"{label}: lane {lane} holds {sum(lanes[lane]['counts'])}"
                 f" samples for {ticks} ticks of {per} samples")
    owned = [len(o) for o in w._slot_owner]
    if lanes["occupancy"]["per_tile"] != owned:
        fail(f"{label}: per_tile {lanes['occupancy']['per_tile']} != "
             f"{owned} entities with slots")
    sig = w.workload_signature()
    if sig is None or "error" in sig:
        fail(f"{label}: no workload signature ({sig})")
    aud = audit_state(w)
    o = aud["oracle"]
    if o["samples"] <= 0 or o["mismatches"] or aud["probes"]["mismatches"] \
            or aud["violations"]:
        fail(f"{label}: audit {aud}")
    census = w.residency.census_snapshot()
    if census["samples"] <= 0 or census["realloc"] or \
            census["skipped_deleted"]:
        fail(f"{label}: census {census}")
    return (f"lanes hold all {ticks} ticks (per_tile "
            f"{lanes['occupancy']['per_tile']}), signature {sig['sig']}; "
            f"audit {o['samples']} samples, {o['entities_checked']} "
            f"entities judged, 0 mismatches, skipped {o['skipped']}, "
            f"dropped on a busy worker {aud['dropped']}, probes "
            f"{aud['probes']}; census {census['samples']} samples, "
            f"{len(census['aliased'])} lanes, 0 re-allocated")


def world_phase(dev, bare: tuple[float, float], tag: str,
                profiled: dict, eager: dict) -> tuple[dict, object]:
    """[11] the serving World at 2^20 slots at its defaults (the planes
    on, the carry resident) under its game traffic (its p50, p99 and
    spans into ``eager``; then [18]'s pipelined ticks), then the stress
    stream, its step and fold under the sync guard against the plain
    versions on a clone, and twin Worlds at 2^16 (with [18]'s third,
    pipelined); returns each run's launches and the served World (for
    [18]), and adds the fold and the carry copy to ``profiled``."""
    phase0 = time.perf_counter()
    rss0 = rss_mb()
    served = serve_world(N, SEED, dev, boot=True, world_kw=PLANES,
                         spare=N - WORLD_POP)
    w = served.world
    rss_pop = rss_mb()
    n_pop = len(w.entities) - 2  # less the nil space and the arena
    boot_aud = audit_state(w)
    if boot_aud["oracle"]["mismatches"] or boot_aud["violations"]:
        fail(f"audit during the boot: {boot_aud}")
    fold_ev, carry_ev, fold_args, carry_args = [], [], {}, {}
    real_fold, real_carry = w._telem_fn, manager._carry_into
    w._telem_fn = event_timed(real_fold, fold_ev, fold_args)
    manager._carry_into = event_timed(real_carry, carry_ev, carry_args)
    rows, launches = world_ticks(served, WORLD_TICKS, teleport=False)
    w._telem_fn, manager._carry_into = real_fold, real_carry
    wall = np.array([r["wall"] for r in rows[1:]]) * 1e3
    eager.update(p50=float(np.percentile(wall, 50)),
                 p99=float(np.percentile(wall, 99)),
                 spans={k: round(float(np.mean([r["spans"][k]
                                                for r in rows[1:]])) * 1e3, 3)
                        for k in rows[1]["spans"]})
    for name in ("pos", "vel"):
        if not torch.isfinite(getattr(w.state, name)).all():
            fail(f"non-finite {name} in the World's state")
    # the hot attr the last tick set twice landed on the device
    mobs = [w.entities[e] for e in served.mobs[:256]]
    slots = torch.tensor([e.slot for e in mobs], device=dev)
    dev_hp = w.state.hot_attrs[0, slots, 0].cpu().numpy()
    if not np.array_equal(dev_hp, np.array([e.attrs["hp"] for e in mobs],
                                           np.float32)):
        fail("the device's hot attrs differ from the entities' hp")
    game_planes = planes_check(w, "game traffic")
    print(f"[11] serving World at its defaults (telemetry, residency every "
          f"{PLANES['residency_sample_every']}, audit every "
          f"{PLANES['audit_sample_every']} ticks of "
          f"{w.audit.cohort}, resident carry): {n_pop} entities "
          f"({served.players.size} players with clients) created through "
          f"Space.create_entity and booted through {served.boot_ticks} "
          f"ticks ({served.boot_events} enter events, none past a cap; "
          f"audit during the boot {boot_aud['oracle']}) in "
          f"{served.populate_s:.2f} s; host RSS {rss0:.0f} MB before, "
          f"{rss_pop:.0f} MB after (+{rss_pop - rss0:.0f}); game traffic: "
          f"{WORLD_TICKS} World.ticks staging {rows[-1]['staged']} each "
          f"(each sync a step from where its player stands; hp set twice "
          f"on 64 mobs), launches {launches}, one sweep and one sort a "
          f"tick; {world_summary(rows, w.cfg)}; the fold by events "
          f"{event_ms(fold_ev)}, the resident carry copy by events "
          f"{event_ms(carry_ev)}; planes: {game_planes}; [5]'s bare tick "
          f"p50={bare[0]:.3f} p99={bare[1]:.3f} ms; the World.tick "
          f"without the planes (PERF.md runs AC, AE) p50 191.5, 368.0 p99 "
          f"249.2, 454.3 ms {tag}", flush=True)
    pipe_launches = pipelined_part(served, eager, tag)
    # the fold and the carry copy of the last game tick, for [12]
    acc0 = telem.telemetry_init(False, occupancy=True, device=dev)
    f_outs = fold_args["args"][1]
    profiled["World telemetry fold"] = \
        lambda acc=acc0, o=f_outs: telem.telemetry_update_live(acc, o)
    c_dst, c_src = carry_args["args"]
    dst = c_dst.apply(torch.clone)
    src = dst.replace(**{
        f.name: getattr(c_src, f.name).clone()
        for f in dataclasses.fields(c_src)
        if getattr(c_src, f.name) is not None
        and getattr(c_src, f.name).data_ptr()
        != getattr(c_dst, f.name).data_ptr()})
    profiled["World resident carry copy"] = \
        lambda d=dst, c=src: manager._carry_into(d, c)
    del fold_args, carry_args, c_dst, c_src, f_outs

    before = audit_state(w)["oracle"]
    stress, stress_launches = world_ticks(served, STRESS_TICKS,
                                          teleport=True)
    after = audit_state(w)["oracle"]
    print(f"[11] serving World, stress stream: {STRESS_TICKS} World.ticks "
          f"whose syncs teleport their players to uniform points (the "
          f"bench's input stream), launches {stress_launches}; "
          f"{world_summary(stress, w.cfg)}; changed rows past "
          f"delta_rows_cap (their events dropped, the interest sets "
          f"degraded) on "
          f"{sum(r['delta_rows'] > w.cfg.delta_rows_cap for r in stress)}"
          f" of {STRESS_TICKS} ticks, and the audit's samples over the "
          f"stream found {after['mismatches'] - before['mismatches']} "
          f"mismatches in "
          f"{after['entities_checked'] - before['entities_checked']} "
          f"entities judged; host peak RSS {peak_rss_mb():.0f} MB {tag}",
          flush=True)

    # one tick whose step and fold run under the sync guard, the step
    # on a clone too
    real, cap = w._step, {}

    def probe(state, inputs, policy=None):
        cap["state"] = state.apply(torch.clone)
        cap["inputs"] = type(inputs)(**{
            f.name: getattr(inputs, f.name).clone()
            for f in dataclasses.fields(inputs)})
        torch.cuda.set_sync_debug_mode("error")
        new = real(state, inputs, policy)
        # the resident step returns the carry it wrote in place: keep
        # what it wrote before the next tick writes it again
        cap["new"] = (new[0].apply(torch.clone), new[1])
        return new

    def fold_probe(acc, outs):
        try:
            return real_fold(acc, outs)
        except Exception as exc:  # the World would disable its lanes
            cap["fold_error"] = exc
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")

    w._step, w._telem_fn = probe, fold_probe
    served.stage()
    w.tick()
    w._step, w._telem_fn = real, real_fold
    if "fold_error" in cap or w._telem_fn is None:
        fail(f"the fold under the sync guard: {cap.get('fold_error')}")
    plain = make_tick(slice_config(N, sweep_impl="ranges",
                                   sort_impl="argsort"), device=dev)
    st_p, out_p = plain(first_space(cap["state"]),
                        first_space(cap["inputs"]))
    st_w, out_w = first_space(cap["new"][0]), first_space(cap["new"][1])
    for what, a, b in (("state", st_w, st_p), ("output", out_w, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"World step {what} lane {name}: kernels != plain "
                     f"versions (ranges/argsort)")
    # the World's one-copy fetch against a plain copy of each lane
    fetched = {f.name: getattr(w.last_outputs, f.name)
               for f in dataclasses.fields(w.last_outputs)}
    fetched["state.pos"], fetched["state.yaw"], fetched["state.alive"] = \
        w._dget([w.state.pos, w.state.yaw, w.state.alive])
    plain_copy = dict(lanes(cap["new"][1]), **{
        "state.pos": w.state.pos, "state.yaw": w.state.yaw,
        "state.alive": w.state.alive})
    for name, t in plain_copy.items():
        a, b = np.asarray(fetched[name]), t.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            fail(f"the World's fetch of {name} differs from .cpu()")
    # one judged audit sample at 2^20, timed: a sample of a full world
    # is skipped above (its sweep has cells past cell_cap every tick, and
    # the oracle is exact only without), so a scratch plane whose
    # ledger holds the World's census judges one with that
    # precondition lifted; its verdicts are timed, not checked
    real_ap, gauges = w.audit, {k: w.op_stats[k] for k in (
        "aoi_over_k_rows", "aoi_over_cap_cells")}
    scratch = audit_mod.AuditPlane("timing", cohort=real_ap.cohort)
    scratch.ledger.resync({k: e.type_name for k, e in w.entities.items()
                           if not e.destroyed}, w.tick_count)
    t0 = time.perf_counter()
    aud_planes = tuple(w._dget([w.state.pos[0], w.state.alive[0],
                                w.state.aoi_radius[0]]))
    t1 = time.perf_counter()
    w.audit = scratch
    w.op_stats.update(dict.fromkeys(gauges, 0))
    w._audit_sample(aud_planes)
    t2 = time.perf_counter()
    scratch.drain()
    t3 = time.perf_counter()
    w.audit = real_ap
    w.op_stats.update(gauges)
    judged = scratch.oracle_stats
    scratch.close()
    print(f"[11] one judged audit sample of the World ({N} slots, "
          f"cohort {real_ap.cohort}), by the host's clock: its planes' "
          f"fetch alone {(t1 - t0) * 1e3:.3f} ms "
          f"({sum(a.nbytes for a in aud_planes)} B), the capture on the "
          f"logic thread {(t2 - t1) * 1e3:.3f} ms, the oracle on the "
          f"worker {(t3 - t2) * 1e3:.3f} ms ({judged['entities_checked']}"
          f" entities judged, {judged['mismatches']} mismatches, which "
          f"the cells past cell_cap allow) {tag}", flush=True)
    del w, cap, st_p, out_p, st_w, out_w, aud_planes

    # twin Worlds of 2^16 slots at their defaults: kernels against plain
    # versions
    # versions, and ([18]) a third on the kernels with its decode
    # pipelined
    twins = {impl: serve_world(TWIN_N, SEED + 1, dev, record_hooks=True,
                               keep=True, boot=True, world_kw=dict(
                                   PLANES, pipeline_decode=impl[2]),
                               sweep_impl=impl[0], sort_impl=impl[1])
             for impl in (("fused", "pallas", False),
                          ("ranges", "argsort", False),
                          ("fused", "pallas", True))}
    (kern, plain_w, pipe) = twins.values()
    counts = {"hooks": 0, "sync records": 0, "messages": 0}
    twin_launches = {}
    kern_kept, pipe_kept, kern_hooks = [], [], []
    for t in range(TWIN_TICKS):
        lanes_before = kern.world._telem_lanes
        for name, sv in zip(("kernels", "plain", "pipelined"),
                            (kern, plain_w, pipe)):
            sv.stage(teleport=t % 2 == 1)
            kernels.reset_launches()
            sv.world.tick()
            twin_launches.setdefault(name, []).append(
                kernels.LAUNCHES["sweep_fused"]
                + kernels.LAUNCHES["counting_sort"])
        a, b = kern.sink.take()["kept"], plain_w.sink.take()["kept"]
        kern_kept += a
        pipe_kept += pipe.sink.take()["kept"]
        kern_hooks += kern.hooks
        if len(a) != len(b) or any(
                x[0] != y[0] or x[1] != y[1] or not (
                    all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
                        for u, v in zip(x[2:], y[2:])) if x[0] == "sync"
                    else x[2:] == y[2:]) for x, y in zip(a, b)):
            fail(f"twin Worlds' sinks differ at tick {t + 1}")
        if kern.hooks != plain_w.hooks:
            fail(f"twin Worlds' hook calls differ at tick {t + 1}")
        sa = interop.state_to_numpy(kern.world.state)
        sb = interop.state_to_numpy(plain_w.world.state)
        if any(sa[k].tobytes() != sb[k].tobytes() for k in sa):
            fail(f"twin Worlds' states differ at tick {t + 1}")
        ka, kb = kern.world, plain_w.world
        if ka._telem_lanes != kb._telem_lanes or any(
                unkeyed(getattr(ka, sig)()) != unkeyed(getattr(kb, sig)())
                for sig in ("workload_signature", "window_signature")):
            fail(f"twin Worlds' telemetry lanes or signatures differ at "
                 f"tick {t + 1}")
        if audit_state(ka) != audit_state(kb) or \
                ka.audit.ledger.snapshot(tick=t) != \
                kb.audit.ledger.snapshot(tick=t):
            fail(f"twin Worlds' audit stats or ledgers differ at tick "
                 f"{t + 1}")
        counts["hooks"] += len(kern.hooks)
        counts["sync records"] += sum(len(x[2]) for x in a
                                      if x[0] == "sync")
        counts["messages"] += sum(1 for x in a if x[0] == "msg")
        kern.hooks.clear()
        plain_w.hooks.clear()
    if twin_launches != {"kernels": [2] * TWIN_TICKS,
                         "plain": [0] * TWIN_TICKS,
                         "pipelined": [2] * TWIN_TICKS}:
        fail(f"twin launches a tick {twin_launches}")
    twin_aud = audit_state(kern.world)["oracle"]
    pipe.world.flush_pending_outputs()
    pipe_kept += pipe.sink.take()["kept"]
    check_pipelined_twin(kern, pipe, kern_kept, pipe_kept, kern_hooks,
                         lanes_before, tag)
    del twins, kern, plain_w, pipe, kern_kept, pipe_kept, kern_hooks
    release_worlds()
    secs = time.perf_counter() - phase0
    print(f"[11] World step on the kernels == make_tick on ranges/argsort "
          f"bit for bit (a clone of its state and flushed inputs, the step "
          f"and the telemetry fold under the sync guard); its one-copy "
          f"fetch of every output lane and of pos, yaw and alive == .cpu() "
          f"bit for bit; twin Worlds of {TWIN_N} slots at their defaults "
          f"(kernels, plain versions) equal in sinks, hooks, state, "
          f"telemetry lanes, workload and window signatures, audit stats "
          f"and ledgers for {TWIN_TICKS} ticks, walking and stress syncs in "
          f"turns ({counts}; audit {twin_aud}); phase {secs:.1f} s {tag}",
          flush=True)
    return {"world": launches, "world_stress": stress_launches,
            "world_pipelined": pipe_launches}, served


def pipelined_ticks(served, n_ticks: int) -> tuple[list, dict, dict]:
    """:func:`world_ticks` on a pipelined World, counting its host syncs
    (each tick's wait for the copy of the previous tick's outputs, and
    the decode's reads of the live positions and headings, which wait
    for the step in flight, as the reference's decode does: at most one
    of each a tick), then its drain: the slots' owners against the
    drained tick's alive rows."""
    w = served.world
    served.stage()
    w.tick()  # primes the pipeline: every timed tick decodes one
    syncs = {"copy waits": 0, "other reads": 0}  # pos/yaw caches
    real_finish, real_dget = w._finish_copy, w._dget

    def finish(pending):
        syncs["copy waits"] += 1
        return real_finish(pending)

    def dget(lanes_):
        syncs["other reads"] += 1
        return real_dget(lanes_)

    w._finish_copy, w._dget = finish, dget
    rows, launches = world_ticks(served, n_ticks, teleport=False)
    w._finish_copy, w._dget = real_finish, real_dget
    if syncs["copy waits"] != n_ticks or \
            syncs["other reads"] > 2 * n_ticks:
        fail(f"[18] pipelined World host syncs in {n_ticks} ticks: {syncs}")
    w.flush_pending_outputs()
    owned = [len(o) for o in w._slot_owner]
    if w.last_outputs.alive_count.tolist() != owned:
        fail(f"[18] drained: {w.last_outputs.alive_count.tolist()} alive "
             f"rows for {owned} entities with slots")
    return rows, launches, syncs


def window_over_cap(spec: GridSpec, pos, alive, watch_radius):
    """bool[N]: rows one of whose 9 window cells holds more than
    cell_cap entities (where the table, which keeps a cell's first
    cell_cap, and the runs of ``ranges``/``fused`` may part)."""
    cx, cz, srow, _, czp, n_rows = aoi._cell_rows(spec, pos, alive,
                                                  watch_radius)
    occ = torch.zeros(n_rows + 1, dtype=torch.int32, device=pos.device)
    occ.index_add_(0, srow.long(), torch.ones_like(srow))
    d = torch.arange(-1, 2, device=pos.device)
    rows = ((cx[:, None, None] + d[None, :, None] + 1) * czp
            + cz[:, None, None] + d[None, None, :] + 1)
    return (occ[rows.reshape(-1, 9).long()] > spec.cell_cap).any(1)


def pipelined_part(served, eager: dict, tag: str) -> dict:
    """[18] the first part, run inside [11] on its World right after its
    game ticks: the decode pipelined from here (the knob is read each
    tick; the eager decode has just drained), WORLD_TICKS ticks of the
    same traffic, the planes, one tick's step and fold under the sync
    guard; then drained and eager again for WORLD_TICKS more ticks (the
    runs in turns: eager, pipelined, eager) and [11]'s remaining paths.
    Returns the pipelined run's launches."""
    t0 = time.perf_counter()
    w = served.world
    before = audit_state(w)["oracle"]
    census0 = w.residency.census_snapshot()["samples"]
    w.pipeline_decode = True
    rows, launches, syncs = pipelined_ticks(served, WORLD_TICKS)
    # the planes: the lanes lag the decode by one tick's accumulator,
    # the audit records a skip for every sample tick
    lanes_ = w._telem_lanes
    held = w.tick_count - 1
    if sum(lanes_["rebuilt"]["counts"]) != held or \
            sum(lanes_["occupancy"]["counts"]) != held:
        fail(f"[18] pipelined lanes hold {sum(lanes_['rebuilt']['counts'])}"
             f" samples for {held} drained ticks")
    aud = audit_state(w)
    skipped = aud["oracle"]["skipped"].get("pipeline_decode", 0)
    census = w.residency.census_snapshot()
    if aud["oracle"]["samples"] != before["samples"] or skipped <= 0 \
            or aud["violations"]:
        fail(f"[18] pipelined audit {aud}")
    if census["samples"] <= census0 or census["realloc"]:
        fail(f"[18] pipelined census {census}")
    if w.workload_signature() is None:
        fail("[18] the pipelined World serves no signature")
    # one tick whose step and fold run under the sync guard
    real_step, real_fold, cap = w._step, w._telem_fn, {}

    def guarded(state, inputs, policy=None):
        torch.cuda.set_sync_debug_mode("error")
        return real_step(state, inputs, policy)

    def fold_guarded(acc, outs):
        try:
            return real_fold(acc, outs)
        except Exception as exc:  # the World would disable its lanes
            cap["fold_error"] = exc
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")

    w._step, w._telem_fn = guarded, fold_guarded
    served.stage()
    w.tick()
    w._step, w._telem_fn = real_step, real_fold
    if "fold_error" in cap or w._telem_fn is None:
        fail(f"[18] the fold under the sync guard: {cap.get('fold_error')}")
    w.flush_pending_outputs()
    served.sink.take()
    w.pipeline_decode = False
    # eager again for as many ticks, so that the order of the runs on
    # the World (eager, pipelined, eager) is seen in their times
    again, _ = world_ticks(served, WORLD_TICKS, teleport=False)
    wall = np.array([r["wall"] for r in rows[1:]]) * 1e3
    p50, p99 = float(np.percentile(wall, 50)), float(np.percentile(wall, 99))
    wall2 = np.array([r["wall"] for r in again[1:]]) * 1e3
    spans2 = {k: round(float(np.mean([r["spans"][k] for r in again[1:]]))
                       * 1e3, 3) for k in again[1]["spans"]}
    print(f"[18] pipelined decode on [11]'s World right after its game "
          f"ticks (pipeline_decode turned on between ticks): "
          f"{WORLD_TICKS} World.ticks of the same traffic, launches "
          f"{launches}, one sweep and one sort a tick; host syncs {syncs} "
          f"(a tick: one wait for the copy of the previous tick's outputs,"
          f" and the decode's reads of the live positions and headings "
          f"for clients' enter messages, which wait for the step in "
          f"flight as the reference's do; the step and the fold under the"
          f" sync guard raise none); {world_summary(rows, w.cfg)}; "
          f"against [11]'s eager World.tick p50={eager['p50']:.3f} "
          f"p99={eager['p99']:.3f} ms, spans {eager['spans']}: p50 "
          f"{p50 - eager['p50']:+.3f} ms, p99 {p99 - eager['p99']:+.3f} "
          f"ms; then eager again for {WORLD_TICKS} ticks: p50="
          f"{np.percentile(wall2, 50):.3f} p99={np.percentile(wall2, 99):.3f}"
          f" ms, spans {spans2}; planes: lanes hold the {held} drained "
          f"ticks, the audit "
          f"skipped {skipped} sample ticks as pipeline_decode, census "
          f"{census['samples']} samples, 0 re-allocated; "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def planes_phase(dev, served, tag: str) -> dict:
    """[18] the rest, on [11]'s World after its ticks: freeze and the
    snapshot chain, a restore into a fresh World at the uncut config's
    skin and the governor's swaps on that World; returns each path's
    launches."""
    import shutil
    import tempfile

    from goworld_tpu_torch import freeze
    from goworld_tpu_torch.workload import _game_types

    phase0 = time.perf_counter()
    w = served.world
    gc.freeze()  # as serve_world left it: [11]'s twins unfroze it
    # freeze and the snapshot chain on this World, after its ticks
    out_dir = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    t0 = time.perf_counter()
    handle = freeze.checkpoint_async(w, out_dir)
    t_ret = time.perf_counter() - t0
    for _ in range(2):  # the World ticks on while the worker writes
        served.stage()
        w.tick()
    handle.join(900)
    chain = freeze.SnapshotChain(w, out_dir, keyframe_every=8)
    recs, chain_ms = {}, {}
    for step in ("key", "delta"):
        if step == "delta":
            for _ in range(8):
                served.stage()
                w.tick()
        t0 = time.perf_counter()
        captured = chain.capture()
        t1 = time.perf_counter()
        data, _tick = chain.complete_capture(captured)
        kind, rec = chain.build(data)
        path = chain.write_record(kind, rec)
        t2 = time.perf_counter()
        if kind != step:
            fail(f"[18] the chain wrote a {kind} for a {step}")
        # a delta resolves against its keyframe's planes alone: the
        # keyframe's host section (a million records) goes at once
        recs[step] = rec if step == "delta" else {"kind": "key",
                                                  "planes": rec["planes"]}
        del rec
        chain_ms[step] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          os.path.getsize(path))
    src_ents = len(recs["delta"]["host"]["entities"])
    shipped = int((np.frombuffer(recs["delta"]["rows"], np.int32) < 0)
                  .sum())
    t0 = time.perf_counter()
    w.audit.scrub_snapshots(out_dir, w.game_id, w.tick_count)
    scrub_s = time.perf_counter() - t0
    scrub = dict(w.audit.scrub_stats)
    if scrub["files"] != 2 or scrub["corrupt"]:
        fail(f"[18] scrub of the chain: {scrub}")
    print(f"[18] freeze on [11]'s World after its ticks ({src_ents} "
          f"entities): checkpoint_async capture on the tick thread "
          f"{handle.capture_s * 1e3:.1f} ms (returned in "
          f"{t_ret * 1e3:.1f} ms), worker {handle.worker_s:.2f} s, "
          f"{handle.nbytes} B; SnapshotChain keyframe capture "
          f"{chain_ms['key'][0]:.1f} ms on the tick thread, fetch + build "
          f"+ write {chain_ms['key'][1]:.1f} ms, {chain_ms['key'][2]} B; "
          f"8 ticks on, delta capture {chain_ms['delta'][0]:.1f} ms, "
          f"{chain_ms['delta'][1]:.1f} ms, {chain_ms['delta'][2]} B "
          f"({shipped} of {src_ents} rows shipped); scrub_snapshots "
          f"{scrub} in {scrub_s:.1f} s {tag}", flush=True)
    del served, w, handle, chain, captured, data
    release_worlds()

    # restore the first RESTORE_N records into a fresh World of 2^20
    # slots at the uncut config's skin; the planes are the records' rows
    # in order, so theirs are each plane's first RESTORE_N rows
    widths = {"pos_xz": 4, "pos_y": 4, "yaw": 2, "moving": 1}
    want = {nm: p[:RESTORE_N * widths[nm]]
            for nm, p in chain_planes(recs).items()}
    data = freeze.resolve_record(recs["delta"], recs["key"])
    data["entities"] = data["entities"][:RESTORE_N]
    ucfg = uncut_config(N)
    rw = manager.World(ucfg, seed=SEED, device=dev, **PLANES)
    for name, cls in zip(("Mob", "Player", "Arena"), _game_types(None)):
        (rw.register_space if name == "Arena" else rw.register_entity)(
            name, cls)
    rw.create_nil_space()
    t0 = time.perf_counter()
    freeze.restore_world(rw, data)
    restore_s = time.perf_counter() - t0
    # the restored World's staged poses, quantized as the chain
    # quantizes them, are the source's lattice planes byte for byte (its
    # moving flags are staged with the spawns: checked on the device
    # after the first tick)
    ents = [rw.entities[e["id"]] for e in data["entities"]]
    got = staged_planes(ents, freeze.SnapshotChain(rw, out_dir))
    for nm in ("pos_xz", "pos_y", "yaw"):
        if got[nm] != want[nm]:
            fail(f"[18] the restored World's {nm} plane differs from the "
                 f"source's lattice plane")
    del ents, got
    shutil.rmtree(out_dir)
    restored, rebuilt = [], []
    for t in range(RESTORED_TICKS):
        kernels.reset_launches()
        rw.tick()
        restored.append(dict(kernels.LAUNCHES))
        rebuilt.append(int(rw.last_outputs.aoi_rebuilt[0]))
        if t == 0:
            ents = [rw.entities[e["id"]] for e in data["entities"]]
            got = rw.state.npc_moving[0].cpu().numpy()[
                [e.slot for e in ents]]
            if got.astype(np.uint8).tobytes() != want["moving"]:
                fail("[18] the restored World's moving flags differ from "
                     "the source's plane")
            del ents, got
    del want
    if any(r != {"sweep_fused": 1, "counting_sort": 1,
                 "halo_ship_phase": 0, "npc_mlp": 0} for r in restored):
        fail(f"[18] restored World launches a tick {restored}")
    if rebuilt[0] != 1:
        fail("[18] the restored World's first tick did not rebuild its "
             "Verlet cache")
    # the players never move on their own: their rows hold the restored
    # lattice positions and headings after the ticks
    rec_by_id = {e["id"]: e for e in data["entities"]}
    # (those whose staged pose has landed: the restore stages one a
    # slot, and input_cap of them land a tick)
    players = [e for e in rw.entities.values()
               if e.type_name == "Player" and e.slot is not None
               and e._pending_pos is None]
    slots = torch.tensor([e.slot for e in players], device=dev)
    got_pos = rw.state.pos[0, slots].cpu().numpy()
    got_yaw = rw.state.yaw[0, slots].cpu().numpy()
    ref_pos = np.array([rec_by_id[e.id]["pos"] for e in players],
                       np.float32)
    ref_yaw = np.array([rec_by_id[e.id]["yaw"] for e in players],
                       np.float32)
    if not (np.array_equal(got_pos, ref_pos)
            and np.array_equal(got_yaw, ref_yaw)):
        fail("[18] the restored players' rows differ from the source's "
             "lattice planes")
    print(f"[18] restore into a fresh World of {N} slots (the uncut "
          f"config, skin {ucfg.grid.skin}): the first "
          f"{len(data['entities'])} entities of the delta in "
          f"{restore_s:.2f} s; its staged poses == the "
          f"source's lattice planes byte for byte "
          f"(pos_xz, pos_y, yaw; its device moving flags after the first "
          f"tick, moving); "
          f"{RESTORED_TICKS} ticks, launches a tick "
          f"{restored[-1]}, Verlet rebuilds {rebuilt}; "
          f"{len(players)} players' rows == their restored lattice pos "
          f"and yaw ({len(rw._staged_pos)} poses still staged at "
          f"input_cap {ucfg.input_cap} a tick) {tag}", flush=True)
    del data, rec_by_id, recs
    launches_by = {"restored": {k: sum(r[k] for r in restored)
                                for k in restored[0]}}
    launches_by.update(governor_swaps(dev, rw, tag))
    del rw
    release_worlds()
    print(f"[18] phase {time.perf_counter() - phase0:.1f} s {tag}",
          flush=True)
    return launches_by


def staged_planes(ents, chain) -> dict:
    """The pos_xz, pos_y and yaw planes of ``ents``' staged poses (a
    restore stages each entity's pose), quantized as
    ``freeze._extract_planes`` quantizes a record's, in numpy."""
    from goworld_tpu_torch import freeze

    pos = np.array([e._pending_pos for e in ents], np.float64)
    yaw = np.array([e._pending_yaw for e in ents], np.float64)
    (ox, oz), step = chain.origin, chain.step
    qxz = np.clip(np.floor((pos[:, [0, 2]] - (ox, oz)) / step), 0, 32767)
    qyaw = (np.round(yaw / freeze.YAW_STEP).astype(np.int64) & 0xFFFF) \
        .astype(np.uint16).view(np.int16)
    return {"pos_xz": qxz.astype(np.int16).tobytes(),
            "pos_y": pos[:, 1].astype(np.float32).tobytes(),
            "yaw": qyaw.tobytes()}


def chain_planes(recs: dict) -> dict:
    """The quantized planes the chain's delta record resolves to (its
    rows taken from the keyframe or its own sparse section)."""
    rows = np.frombuffer(recs["delta"]["rows"], np.int32)
    ref = rows >= 0
    out = {}
    for nm, (dt, wd) in (("pos_xz", (np.int16, 2)),
                         ("pos_y", (np.float32, 1)),
                         ("yaw", (np.int16, 1)), ("moving", (np.uint8, 1))):
        kp = np.frombuffer(recs["key"]["planes"][nm], dt).reshape(-1, wd)
        sp = np.frombuffer(recs["delta"]["sparse"][nm], dt).reshape(-1, wd)
        o = np.zeros((rows.size, wd), dt)
        o[ref] = kp[rows[ref]]
        o[~ref] = sp
        out[nm] = o.tobytes()
    return out


def governor_swaps(dev, rw, tag: str) -> dict:
    """[18] the governor on ``rw`` (2^20 slots at the uncut config's
    skin): every default candidate warmed, then commits forced through
    ``default -> skin=0 -> sweep=table,skin=0 -> sort=counting,skin=0 ->
    default``; each swap's first tick held bit for bit against a fresh
    ``make_tick`` at the target config on a clone of the carried state,
    and the launches of each config's ticks counted; under ``table`` its
    sweep timed beside ``fused``'s on the same positions; the World's
    cost report at the end. Returns each config's launches."""
    from goworld_tpu_torch.autotune import KernelGovernor

    gov = KernelGovernor(rw, name="chip_smoke", up_windows=1,
                         cooldown_windows=0)
    t0 = time.perf_counter()
    gov.warmset.warm_all()
    warm_all_s = time.perf_counter() - t0
    warms = {}
    for lbl in gov.warmset.labels():
        e = gov.warmset.entry(lbl)
        if not e.warm:
            fail(f"[18] warming {lbl}: {e.error}")
        warms[lbl] = round(e.warm_s, 3)
    swaps, launches_by, table_line = [], {}, ""
    for label in GOVERNOR_SWAPS:
        t0 = time.perf_counter()
        # a forced commit, as the governor commits a decided, warm swap
        ev = gov._commit(label, "chip_smoke", pre_p90=None)
        swap_ms = (time.perf_counter() - t0) * 1e3
        if ev is None or rw.cfg.grid != gov.warmset.entry(label).cfg.grid:
            fail(f"[18] the swap to {label} did not commit ({ev})")
        real, cap = rw._step, {}

        def first(state, inputs, policy=None, real=real, cap=cap):
            cap["state"] = state.apply(torch.clone)
            cap["inputs"] = type(inputs)(**{
                f.name: getattr(inputs, f.name).clone()
                for f in dataclasses.fields(inputs)})
            new = real(state, inputs, policy)
            cap["new"] = (new[0].apply(torch.clone), new[1])
            return new

        rw._step = first
        kernels.reset_launches()
        rw.tick()
        rw._step = real
        ticks = [dict(kernels.LAUNCHES)]
        st_f, out_f = make_tick(rw.cfg, device=dev)(
            first_space(cap["state"]), first_space(cap["inputs"]))
        for what, a, b in (("state", first_space(cap["new"][0]), st_f),
                           ("output", first_space(cap["new"][1]), out_f)):
            la, lb = lanes(a), lanes(b)
            for name in la:
                if not same_bits(la[name], lb[name]):
                    fail(f"[18] the first tick after the swap to {label}: "
                         f"{what} lane {name} != a fresh make_tick")
        del cap, st_f, out_f
        kernels.reset_launches()
        rw.tick()
        ticks.append(dict(kernels.LAUNCHES))
        g = rw.cfg.grid
        want = {"sweep_fused": int(g.sweep_impl == "fused"),
                "counting_sort": int(g.sort_impl == "pallas"),
                "halo_ship_phase": 0, "npc_mlp": 0}
        if any(t != want for t in ticks):
            fail(f"[18] launches a tick under {label}: {ticks}")
        launches_by[f"governor {label}"] = {
            k: sum(t[k] for t in ticks) for k in want}
        swaps.append(f"{label} {swap_ms:.3f} ms")
        if g.sweep_impl == "table":
            table_line = table_beside_fused(rw, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rw.tick()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rep = rw.cost_report()
    if rep.error:
        fail(f"[18] cost report: {rep.error}")
    print(f"[18] governor on the restored World ({N} slots, default = "
          f"skin {gov.warmset.entry('default').cfg.grid.skin}): warmed "
          f"{gov.warmset.labels()} in {warm_all_s:.2f} s ({warms} s "
          f"each, off the tick thread's stream); forced commits "
          f"{' -> '.join(['default'] + GOVERNOR_SWAPS)}, tick-thread ms "
          f"a swap: {', '.join(swaps)}; each swap's first tick == a fresh "
          f"make_tick at its config on a clone of the carried state, bit "
          f"for bit; launches {launches_by}; swap log {gov.log_lines()}; "
          f"{table_line}; cost_report: bytes_accessed "
          f"{rep.bytes_accessed:.6g}, flops {rep.flops:.6g}, argument "
          f"{rep.argument_size} B, output {rep.output_size} B, aliased "
          f"{rep.alias_size} B, peak {rep.peak_hbm_bytes} B, against "
          f"torch.cuda.max_memory_allocated {peak} B over one tick {tag}",
          flush=True)
    return launches_by


def table_beside_fused(rw, g: GridSpec) -> str:
    """``sweep_impl="table"`` and ``fused`` on the World's positions at
    its config: equal in every output lane on each row no cell past
    cell_cap touches (the table keeps a cell's first cell_cap, the runs
    more), and their ms by CUDA events."""
    st = first_space(rw.state)
    flags = st.dirty.to(torch.int32) | (st.has_client.to(torch.int32) << 1)
    fused = dataclasses.replace(g, sweep_impl="fused")

    def run(spec):
        return grid_neighbors_flags(spec, st.pos, st.alive,
                                    watch_radius=st.aoi_radius,
                                    flag_bits=flags, with_stats=True)

    a, b = run(g), run(fused)
    ok = ~window_over_cap(g, st.pos, st.alive, st.aoi_radius)
    for x, y in zip(a[:3], b[:3]):
        if not torch.equal(x[ok], y[ok]):
            fail("[18] the table sweep differs from fused on a row below "
                 "the caps")
    if not all(int(x) == int(y) for x, y in zip(a[3][2:], b[3][2:])):
        fail("[18] the table sweep's cell gauges differ from fused's")
    table_ms = time_ms(lambda: run(g), 5, 1)
    fused_ms = time_ms(lambda: run(fused), 5, 1)
    return (f"under table, grid_neighbors_flags {table_ms:.3f} ms beside "
            f"fused's {fused_ms:.3f} ms by events, equal in every output "
            f"lane on the {int(ok.sum())} rows no cell past cell_cap "
            f"touches ({int((~ok).sum())} rows apart)")


def check_pipelined_twin(eager, pipe, eager_kept: list, pipe_kept: list,
                         eager_hooks: list, lanes_before, tag: str) -> None:
    """[18] [11]'s twin of 2^16 slots on the kernels against a third
    twin whose decode is pipelined, after the pipelined one's drain: the
    same sinks and hooks (as multisets: the pipelined decode runs a tick
    later), state, interest sets and ledgers; its drained lanes are the
    eager one's a tick earlier."""
    def key(x):
        if x[0] == "sync":
            return (x[0], x[1], *(np.asarray(u).tobytes() for u in x[2:]))
        # an enter message's pose and attrs are read at its decode, a
        # tick later when pipelined, as the reference's are
        return (x[0], x[1], x[2], x[3]["type"], x[3].get("eid"))

    # a decode sends no enter message of a subject destroyed since (a
    # tick later when pipelined), and attr deltas go to the watchers of
    # the decode that drains them: the messages of destroyed subjects
    # and the attr deltas are left out, every sync record is compared
    gone = {e for sv in (eager, pipe) for e, x in sv.world.entities.items()
            if x.destroyed} | {x[3].get("eid") for kept in (eager_kept,
                                                           pipe_kept)
                               for x in kept if x[0] == "msg"
                               and x[3].get("eid") not in
                               eager.world.entities}

    def kept(items):
        return sorted(key(x) for x in items if x[0] == "sync" or (
            x[3]["type"] != "attrs" and x[3].get("eid") not in gone))

    n_sink = len(kept(pipe_kept))
    if kept(eager_kept) != kept(pipe_kept):
        fail("[18] pipelined and eager twins' sinks differ")
    if sorted(map(repr, eager_hooks)) != sorted(map(repr, pipe.hooks)):
        fail("[18] pipelined and eager twins' hook calls differ")
    sa = interop.state_to_numpy(eager.world.state)
    sb = interop.state_to_numpy(pipe.world.state)
    if any(sa[k].tobytes() != sb[k].tobytes() for k in sa):
        fail("[18] pipelined and eager twins' states differ")
    ia = {e.id: frozenset(e.interested_in)
          for e in eager.world.entities.values()}
    ib = {e.id: frozenset(e.interested_in)
          for e in pipe.world.entities.values()}
    if ia != ib:
        fail("[18] pipelined and eager twins' interest sets differ")
    if eager.world.audit.ledger.snapshot(tick=0) != \
            pipe.world.audit.ledger.snapshot(tick=0):
        fail("[18] pipelined and eager twins' ledgers differ")
    if pipe.world._telem_lanes != lanes_before:
        fail("[18] the pipelined twin's lanes are not the eager one's a "
             "tick earlier")
    print(f"[18] [11]'s twin Worlds of {TWIN_N} slots on the kernels, one "
          f"with its decode pipelined, {TWIN_TICKS} ticks: after the drain "
          f"the same {n_sink} sink items (every sync record; the entity "
          f"messages of subjects not destroyed) and the same hooks (as "
          f"multisets), state, interest sets and ledgers; the pipelined "
          f"lanes are the eager ones a tick earlier {tag}", flush=True)


def diff_count(a, b):
    """Words of two lanes that differ, as a device tensor (floats by
    their bits; no host sync); lanes that are None count as equal to
    None."""
    if a is None or b is None:
        return torch.tensor(int((a is None) != (b is None)))
    if a.is_floating_point():
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return (a != b).sum()


def pct(ms, sel) -> str:
    """p50/p99 of the ticks ``sel`` picks, or "none"."""
    x = ms[sel]
    if x.size == 0:
        return "none"
    return (f"p50={float(np.percentile(x, 50)):.3f} "
            f"p99={float(np.percentile(x, 99)):.3f} (n={x.size})")


def gate_phase(dev, cfg, st, tag, label: str,
               profiled: dict | None = None) -> dict:
    """The fused sweep at the Verlet rebuild's shape of ``cfg`` (k =
    verlet_cap_eff, no flag bits, reach padded by the skin, over the
    positions snapped as the tick snaps them): the kernel against its
    plain version, a closed gate leaving its buffers byte for byte, an
    open one writing the plain version's result; times by events and
    the bound, counted as in [6]; with ``profiled``, a closed launch
    joins it, read in [12]."""
    g = cfg.grid
    gv = dataclasses.replace(g, k=g.verlet_cap_eff)
    pos = aoi.quantize_positions(g, st.pos)
    fh = aoi.front_half(gv, pos, st.alive, None, st.aoi_radius, None,
                        with_stats=True, reach_pad=g.skin)
    if not visits_every_row(fh):
        fail("the rebuild's sorted slot ids are not a permutation")
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, pos, fh.reach, gv.k,
            gv.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    err = int((top_k.long() - top_p.long()).abs().max()) + int(
        (dem_k - dem_p).abs().max())
    if err:
        fail(f"fused sweep at the rebuild shape differs from its plain "
             f"version ({err})")
    out = (torch.full_like(top_k, 7), torch.full_like(dem_k, 5))
    before = [t.clone() for t in out]
    shut = torch.zeros((), dtype=torch.int32, device=dev)
    opened = torch.ones((), dtype=torch.int32, device=dev)
    aoi.sweep_fused_cuda(*args, gate=shut, out=out)
    if not (same(out[0], before[0]) and same(out[1], before[1])):
        fail("a closed gate wrote the sweep's buffers")
    aoi.sweep_fused_cuda(*args, gate=opened, out=out)
    if not (same(out[0], top_p) and same(out[1], dem_p)):
        fail("an open gate's sweep differs from the plain version")
    ms_open = time_ms(
        lambda: aoi.sweep_fused_cuda(*args, gate=opened, out=out), 20)
    ms_shut = time_ms(
        lambda: aoi.sweep_fused_cuda(*args, gate=shut, out=out), 20)
    ms_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 3, 1)
    nb, no, cand = sweep_work(fh, dem_p, gv.k, gv.cell_cap)
    bms, by = bound(nb, no)
    if profiled is not None:
        profiled["sweep_fused_cuda, gate closed"] = \
            lambda: aoi.sweep_fused_cuda(*args, gate=shut, out=out)
    print(f"{label} gated sweep at the rebuild shape (precision "
          f"{g.precision}, k={gv.k}, cell_cap {gv.cell_cap}, no flag "
          f"bits, reach pad {g.skin}, {cand / N:.2f} in-range candidates "
          f"a row, demand max {int(dem_p.max())}): kernel == plain; gate 0 "
          f"leaves both buffers byte for byte, gate 1 writes the plain "
          f"result; {ms_open:.5f} ms a call open, {ms_shut:.5f} ms closed, "
          f"plain {ms_plain:.3f} ms, bound {bms:.5f} ms by {by} {tag}",
          flush=True)
    return {"precision": g.precision, "k": gv.k, "cell_cap": gv.cell_cap,
            "flag_bits": False, "reach_pad": g.skin, "ms": ms_open, "gate_closed_ms": ms_shut, "plain_ms": ms_plain,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}


def inputs_and_floats(dev, tag) -> None:
    """[13] the input scatter with heavy repeats against a host-side
    last write, and a small uncut world run on the card and on the CPU
    port with every lane (floats included) bit-equal."""
    rng = np.random.default_rng(SEED + 17)
    ic, slots = 65536, 4096
    pos = rng.uniform(0, 1000, (N, 3)).astype(np.float32)
    yaw = rng.uniform(0, 6, N).astype(np.float32)
    idx = rng.integers(0, slots, ic).astype(np.int32)
    idx[rng.random(ic) < 0.05] = -3          # out of range: dropped
    idx[rng.random(ic) < 0.05] = N + 5
    vals = rng.uniform(0, 1000, (ic, 4)).astype(np.float32)
    n_in = 60000
    got = apply_pos_inputs(*(torch.tensor(a, device=dev) for a in (
        pos, yaw, idx, vals, np.asarray(n_in, np.int32))))
    ok = (np.arange(ic) < n_in) & (idx >= 0) & (idx < N)
    rec = np.flatnonzero(ok)
    uniq, first_rev = np.unique(idx[rec][::-1], return_index=True)
    last = rec[::-1][first_rev]
    want_pos, want_yaw = pos.copy(), yaw.copy()
    want_pos[uniq] = vals[last, :3]
    want_yaw[uniq] = vals[last, 3]
    touched = np.zeros(N, bool)
    touched[uniq] = True
    for a, b, name in ((got[0], want_pos, "pos"), (got[1], want_yaw, "yaw"),
                       (got[2], touched, "touched")):
        if a.cpu().numpy().tobytes() != b.tobytes():
            fail(f"apply_pos_inputs with repeated slots: {name} differs "
                 f"from the host's last write")
    cfg = uncut_config(FLOAT_N)
    worlds = {d: uncut_world(cfg, SEED + 3, d)
              for d in (dev, torch.device("cpu"))}
    ticks = {d: make_tick(cfg, device=d) for d in worlds}
    bad, rebuilds = [], 0
    for t in range(FLOAT_TICKS):
        new = {d: ticks[d](*worlds[d]) for d in worlds}
        for d in worlds:
            worlds[d] = (new[d][0], worlds[d][1])
        (sa, oa), (sb, ob) = new[dev], new[torch.device("cpu")]
        rebuilds += int(ob.aoi_rebuilt)
        for what, a, b in (("state", sa, sb), ("outputs", oa, ob)):
            la, lb = lanes(a), lanes(b)
            bad += [f"{what}.{k} @{t + 1}" for k in la
                    if not same_bits(None if la[k] is None
                                     else la[k].cpu(), lb[k])]
    if bad:
        fail(f"card and CPU port differ: {bad[:8]}")
    print(f"[13] inputs and floats: apply_pos_inputs with {n_in} records "
          f"onto {slots} slots ({uniq.size} hit, repeats and out-of-range "
          f"slots among them) == the host's last write per slot; an uncut "
          f"world of {FLOAT_N} (skin {cfg.grid.skin}, syncs with repeats) "
          f"{FLOAT_TICKS} ticks on the card == on the CPU port in every "
          f"lane bit for bit, floats and the Verlet cache included "
          f"({rebuilds} rebuilds) {tag}", flush=True)


def verlet_phase(dev, tag, profiled: dict) -> tuple[dict, dict]:
    """[13] the bench world uncut: 2^20 entities, skin 4, verlet_cap 48,
    syncs with repeats, VERLET_TICKS ticks, each beside a skin-0 tick in
    lockstep from the same start (the random walk reads no lists, so
    the two trajectories coincide); returns the gated sweep's numbers
    and the path's launches."""
    cfg = uncut_config(N)
    flat = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, skin=0.0))
    st, inputs = uncut_world(cfg, SEED, dev)
    gate = gate_phase(dev, cfg, st, tag, "[13]", profiled)
    inputs_and_floats(dev, tag)
    tick, tick0 = make_tick(cfg, device=dev), make_tick(flat, device=dev)
    st0 = st.replace(aoi_cache=None)
    torch.cuda.set_sync_debug_mode("error")
    tick(st, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    skip = {"aoi_cache", "aoi_rebuilt", "aoi_skin_slack",
            # cells of radius + skin against cells of radius
            "aoi_cell_max", "aoi_over_cap_cells"}
    diffs: dict = {}
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(VERLET_TICKS)]
    gauges, per_tick = [], []
    kernels.reset_launches()
    for t in range(VERLET_TICKS):
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs)
        ev[t][1].record()
        c1 = dict(kernels.LAUNCHES)
        per_tick.append((c1["sweep_fused"] - c0["sweep_fused"],
                         c1["counting_sort"] - c0["counting_sort"]))
        ev[t][2].record()
        st0, out0 = tick0(st0, inputs)
        ev[t][3].record()
        for a, b in ((st, st0), (out, out0)):
            la, lb = lanes(a), lanes(b)
            for k in la:
                if k.split(".")[0] not in skip:
                    diffs[k] = diffs.get(k, 0) + diff_count(la[k], lb[k])
        gauges.append(torch.stack([
            out.aoi_rebuilt.float(), out.aoi_skin_slack,
            out.enter_n.float(), out.sync_n.float(),
            out.aoi_over_k_rows.float(), out.aoi_over_cap_cells.float(),
            out0.aoi_over_cap_cells.float(), out.aoi_demand_max.float(),
            st.aoi_cache.over_v_rows.float()]))
    torch.cuda.synchronize()
    launches = {"sweep_fused": sum(p[0] for p in per_tick),
                "counting_sort": sum(p[1] for p in per_tick)}
    if per_tick != [(1, 1)] * VERLET_TICKS:
        fail(f"Verlet path launches a tick {per_tick}, want one gated "
             f"sweep and one sort")
    bad = {k: int(v) for k, v in diffs.items() if int(v)}
    if bad:
        fail(f"Verlet tick != skin-0 tick in lanes {bad}")
    gv = torch.stack(gauges).cpu().numpy()
    reb, slack = gv[:, 0] > 0, gv[:, 1]
    if not reb[0] or reb.sum() < 2:
        fail(f"rebuilds {np.flatnonzero(reb).tolist()}: want the first "
             f"tick and a displacement rebuild")
    if gv[0, 2] <= 0 or (gv[:, 3] <= 0).any():
        fail("no enter events on tick 1 or a tick without sync records")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([e[0].elapsed_time(e[1]) for e in ev])
    ms0 = np.array([e[2].elapsed_time(e[3]) for e in ev])
    later = np.arange(VERLET_TICKS) >= 1
    print(f"[13] bench world uncut: {VERLET_TICKS} ticks of {N} entities, "
          f"skin {cfg.grid.skin}, verlet_cap {cfg.grid.verlet_cap_eff}, "
          f"syncs with repeats; launches {launches} (one gated sweep and "
          f"one sort a tick); rebuilds {int(reb.sum())} at ticks "
          f"{(np.flatnonzero(reb) + 1).tolist()}; every lane and output "
          f"(but the skin gauges and the cell gauges of the other cell "
          f"size) bit-equal to the skin-0 tick in lockstep every tick; "
          f"min aoi_skin_slack {float(slack.min()):.5f}; gauges max: "
          f"over_k_rows {int(gv[:, 4].max())}, over_cap_cells "
          f"{int(gv[:, 5].max())} (skin 0: {int(gv[:, 6].max())}), "
          f"demand_max {int(gv[:, 7].max())}, over_v_rows "
          f"{int(gv[:, 8].max())}; ms/tick (CUDA events, ticks 2-"
          f"{VERLET_TICKS}) all {pct(ms, later)}, reuse "
          f"{pct(ms, later & ~reb)}, rebuild {pct(ms, later & reb)}, tick "
          f"1 {ms[0]:.3f}; the skin-0 tick {pct(ms0, later)} {tag}",
          flush=True)
    return gate, launches


def overflowed_rows(spec: GridSpec, pos, alive, watch_radius):
    """bool[N]: rows whose sweep under ``spec`` truncates a run (more
    than 3*cell_cap slots in one of its three z-triples)."""
    fh = aoi.front_half(spec, pos, alive, None, watch_radius, None)
    return ((fh.hi - fh.lo) > 3 * spec.cell_cap).any(1)


def q16_phase(dev, tag) -> tuple[dict, dict]:
    """[14] the uncut world at precision="q16" (cell_cap 12, as [13]):
    the gated sweep at this path's rebuild shape against its plain
    version; then Q16_TICKS ticks, each beside a twin of the same config
    on the plain path (``ranges`` sweep, plain counting sort) in
    lockstep, bit-equal in every lane of state, cache and outputs; and
    every tick, on the rows that no truncation touches, the lists equal
    ``grid_neighbors_flags`` (precision off, no skin, plain path) over
    the snapped positions the tick's sweep saw (the AOI view: the
    integrate with its product rounded, as XLA recomputes it in the
    fusions that snap it; the stored positions keep the contracted
    rows; :func:`q16_card_vs_cpu` holds that view against the CPU
    port). A row is left out of that last check when its cache row is
    full or a run of its sweep overflowed, at the last
    rebuild (cells of radius + skin, on the lattice) or in the
    reference's sweep: there Verlet and the skinless sweep truncate
    different candidates, as the reference package does. The velocity
    lane is bfloat16. Returns the gated sweep's numbers and the path's
    launches."""
    cfg = uncut_config(N, precision="q16")
    g = cfg.grid
    plain = dict(sweep_impl="ranges", sort_impl="counting")
    twin_cfg = dataclasses.replace(cfg, grid=dataclasses.replace(g, **plain))
    ref_spec = dataclasses.replace(g, precision="off", skin=0.0, **plain)
    reb_spec = dataclasses.replace(g, k=g.verlet_cap_eff, **plain)
    st, inputs = uncut_world(cfg, SEED, dev)
    if st.vel.dtype != torch.bfloat16:
        fail(f"q16 velocity lane is {st.vel.dtype}")
    gate = gate_phase(dev, cfg, st, tag, "[14]")
    tick, twin = make_tick(cfg, device=dev), make_tick(twin_cfg, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    tick(st, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    st_t = st
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(Q16_TICKS)]
    per_tick, gauges = [], []
    diffs: dict = {}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    mism, held, left = zero.clone(), zero.clone(), zero.clone()
    v = g.verlet_cap_eff
    # the positions the tick hands its sweep
    seen, real_sweep = {}, step_mod.grid_neighbors_verlet

    def recording(spec, pos, *a, **kw):
        seen["pos"] = pos
        return real_sweep(spec, pos, *a, **kw)

    step_mod.grid_neighbors_verlet = recording
    kernels.reset_launches()
    for t in range(Q16_TICKS):
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs)
        ev[t][1].record()
        aoi_view = seen["pos"]
        c1 = dict(kernels.LAUNCHES)
        per_tick.append((c1["sweep_fused"] - c0["sweep_fused"],
                         c1["counting_sort"] - c0["counting_sort"]))
        st_t, out_t = twin(st_t, inputs)
        for a, b in ((st, st_t), (out, out_t)):
            la, lb = lanes(a), lanes(b)
            for k in la:
                diffs[k] = diffs.get(k, 0) + diff_count(la[k], lb[k])
        snapped = aoi.quantize_positions(g, aoi_view)
        nbr, cnt, _fl = grid_neighbors_flags(
            ref_spec, snapped, st.alive, watch_radius=st.aoi_radius,
            flag_bits=st.has_client.to(torch.int32) << 1)
        c = st.aoi_cache
        at_rebuild = torch.stack(
            [c.ref_x, torch.zeros_like(c.ref_x), c.ref_z], 1)
        skip = (overflowed_rows(ref_spec, snapped, st.alive, st.aoi_radius)
                | overflowed_rows(reb_spec, at_rebuild, c.ref_alive,
                                  c.ref_radius)
                | (aoi.unpack_ids21(c.cand)[:, v - 1] != N))
        row_diff = (nbr != st.nbr).any(1) | (cnt != st.nbr_cnt)
        mism += (row_diff & ~skip).sum()
        held += (~skip).sum()
        left += skip.sum()
        gauges.append(torch.stack([
            out.aoi_rebuilt.float(), out.aoi_skin_slack,
            out.sync_n.float(), out.aoi_over_k_rows.float(),
            c.over_v_rows.float(), c.over_cap_cells.float()]))
    torch.cuda.synchronize()
    step_mod.grid_neighbors_verlet = real_sweep
    launches = {"sweep_fused": sum(p[0] for p in per_tick),
                "counting_sort": sum(p[1] for p in per_tick)}
    if per_tick != [(1, 1)] * Q16_TICKS:
        fail(f"q16 path launches a tick {per_tick}")
    bad = {k: int(n) for k, n in diffs.items() if int(n)}
    if bad:
        fail(f"q16 tick on the kernels != its plain-path twin in lanes "
             f"{bad}")
    if int(mism):
        fail(f"q16 lists differ from the f32 sweep over the snapped "
             f"positions in {int(mism)} rows no truncation touches")
    if st.vel.dtype != torch.bfloat16 or not torch.isfinite(st.pos).all():
        fail("q16 state lost its bfloat16 velocity or finite positions")
    gv = torch.stack(gauges).cpu().numpy()
    reb = gv[:, 0] > 0
    if not reb[0] or reb.sum() < 2:
        fail(f"q16 rebuilds {np.flatnonzero(reb).tolist()}: want the "
             f"first tick and a displacement rebuild")
    ms = np.array([e[0].elapsed_time(e[1]) for e in ev])
    later = np.arange(Q16_TICKS) >= 1
    print(f"[14] q16: {Q16_TICKS} ticks of the uncut world at "
          f"precision=q16 (lattice step {g.quant_step}, cells "
          f"{g.cell_size}, cell_cap {g.cell_cap}), launches {launches}; "
          f"every lane of state, cache and outputs == the plain-path "
          f"twin (ranges/counting) every tick; lists == "
          f"grid_neighbors_flags (precision off, plain path) over the "
          f"snapped AOI view on {int(held)} row-ticks, {int(left)} "
          f"row-ticks left out (a run overflowed or a full cache row); "
          f"vel {st.vel.dtype}; rebuilds {int(reb.sum())} at ticks "
          f"{(np.flatnonzero(reb) + 1).tolist()}; min aoi_skin_slack "
          f"{float(gv[:, 1].min()):.5f}; sync_n last {int(gv[-1, 2])}; "
          f"over_k_rows max {int(gv[:, 3].max())}, over_v_rows max "
          f"{int(gv[:, 4].max())}, rebuild over_cap_cells max "
          f"{int(gv[:, 5].max())}; ms/tick (CUDA events, ticks 2-"
          f"{Q16_TICKS}) all {pct(ms, later)}, reuse "
          f"{pct(ms, later & ~reb)}, rebuild {pct(ms, later & reb)}, tick "
          f"1 {ms[0]:.3f} {tag}", flush=True)
    q16_card_vs_cpu(dev, tag)
    return gate, launches


def q16_card_vs_cpu(dev, tag) -> None:
    """[14] the q16 tick on the card against the CPU port, which the
    tests hold to the JAX package bit for bit: uncut worlds of FLOAT_N
    at precision="q16" under the random walk, btree, mlp and the mixed
    scenario, FLOAT_TICKS ticks each, every lane of state and outputs
    equal on every tick. This holds the AOI view (the rounded
    integrate, snapped) on the card, and every tick's sweep over it."""
    cfgs = {"random_walk": uncut_config(FLOAT_N, precision="q16"),
            "btree": behavior_config(FLOAT_N, "btree", precision="q16"),
            "mlp": behavior_config(FLOAT_N, "mlp", precision="q16"),
            "mixed": scenario_config(FLOAT_N, "mixed", precision="q16")}
    cpu = torch.device("cpu")
    rebuilds = {}
    for name, cfg in cfgs.items():
        worlds = {d: behavior_world(cfg, SEED + 5, d) for d in (dev, cpu)}
        ticks = {d: make_tick(cfg, device=d) for d in worlds}
        bad, rebuilds[name] = [], 0
        for t in range(FLOAT_TICKS):
            new = {}
            for d, (s_, i_, p_) in worlds.items():
                new[d] = ticks[d](s_, i_, p_)
                worlds[d] = (new[d][0], i_, p_)
            (sa, oa), (sb, ob) = new[dev], new[cpu]
            rebuilds[name] += int(ob.aoi_rebuilt)
            for what, a, b in (("state", sa, sb), ("outputs", oa, ob)):
                la, lb = lanes(a), lanes(b)
                bad += [f"{what}.{k} @{t + 1}" for k in la
                        if not same_bits(None if la[k] is None
                                         else la[k].cpu(), lb[k])]
        if bad:
            fail(f"[14] q16 {name}: the card differs from the CPU port "
                 f"in {bad[:8]}")
    print(f"[14] q16 card == CPU port: {FLOAT_N} entities uncut at "
          f"precision=q16, {FLOAT_TICKS} ticks under {sorted(cfgs)}, every "
          f"lane and output bit for bit on every tick (rebuilds "
          f"{rebuilds}) {tag}", flush=True)


def spaces_phase(dev, bare: tuple[float, float], tag: str,
                 profiled: dict) -> tuple[dict, dict, tuple]:
    """[15] several Spaces on one card: the batched sort and sweep
    against their plain versions at SPACES x SPACE_N, timed; SPACE_TICKS
    batched ticks by events (two more under the sync guard), their
    launches against those of a one-Space batched state; the same ticks
    again in lockstep with SPACES single-Space ticks, every lane equal
    on every tick; then the served game of SPACES Spaces at its
    defaults with its migrations between them. Returns (launches by
    path, the batched shape's kernel numbers, the batched tick's p50 and
    p99 ms) and adds the batched tick and kernels to ``profiled``."""
    phase0 = time.perf_counter()
    cfg = multi_config(SPACES, SPACE_N)
    g = cfg.grid
    st0, inputs = multi_world(cfg, SPACES, SEED, dev)
    flag_bits = st0.has_client.to(torch.int32) << 1
    fh = aoi.front_half(g, st0.pos, st0.alive, None, st0.aoi_radius,
                        flag_bits, with_stats=True)
    if not visits_every_row(fh):
        fail("[15] a Space's sorted slot ids are not a permutation of its "
             "rows")
    o_k, s_k = counting_sort_cells_cuda(fh.srow, fh.n_rows)
    o_p, s_p = counting_sort_cells(fh.srow, fh.n_rows)
    o_a = torch.argsort(fh.srow, dim=-1, stable=True).to(torch.int32)
    if not (same(o_k, o_p) and same(s_k, s_p) and same(o_k, o_a)):
        fail("[15] the batched sort differs from its plain version or a "
             "per-Space stable argsort")
    sort_err = int((o_k - o_p).abs().max()) + int((s_k - s_p).abs().max())
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st0.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(-1).sum())
        fail(f"[15] the batched sweep differs from its plain version in "
             f"{bad} rows")
    for d in range(SPACES):
        one = aoi.sweep_fused_cuda(*(a[d] for a in args[:6]), *args[6:])
        if not (same(one[0], top_k[d]) and same(one[1], dem_k[d])):
            fail(f"[15] the batched sweep's Space {d} differs from its "
                 f"own launch")
    sweep_err = int((top_k.long() - top_p.long()).abs().max()) + int(
        (dem_k - dem_p).abs().max())
    n_all = SPACES * SPACE_N
    sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)
    sweep_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 2, 1)
    sort_ms = time_ms(
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows), 20)
    sort_plain = time_ms(
        lambda: counting_sort_cells(fh.srow, fh.n_rows), 2, 1)
    sort_lib = time_ms(
        lambda: torch.argsort(fh.srow, dim=-1, stable=True), 20)
    plan = radix_plan((SPACES * (fh.n_rows + 1) - 1).bit_length())
    sw_bytes, sw_ops, cand = sweep_work(fh, dem_p, g.k, g.cell_cap)
    sw_bound, sw_by = bound(sw_bytes, sw_ops)
    so_bound, so_by = bound(12 * n_all, plan[0] * 12 * n_all)
    shape = {
        "sweep_fused_cuda": dict(
            spaces=SPACES, rows_a_space=SPACE_N, ms=sweep_ms,
            plain_ms=sweep_plain, library_ms=None, bound_ms=sw_bound,
            bound_by=sw_by, max_abs_err=sweep_err),
        "counting_sort_cells_cuda": dict(
            spaces=SPACES, rows_a_space=SPACE_N, ms=sort_ms,
            plain_ms=sort_plain, library_ms=sort_lib, bound_ms=so_bound,
            bound_by=so_by, max_abs_err=sort_err, plan=list(plan))}
    profiled[f"sweep_fused_cuda, {SPACES} Spaces"] = \
        lambda: aoi.sweep_fused_cuda(*args)
    profiled[f"counting_sort_cells_cuda, {SPACES} Spaces"] = \
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows)
    print(f"[15] batched kernels at {SPACES} x {SPACE_N}: sort == plain =="
          f" per-Space stable argsort (plan {plan}), sweep == plain, every "
          f"Space == its own launch, bit for bit; sweep {sweep_ms:.5f} ms a"
          f" call (bound {sw_bound:.5f} ms by {sw_by}, {cand / n_all:.2f} "
          f"in-range candidates a row, plain {sweep_plain:.3f}); sort "
          f"{sort_ms:.5f} ms (bound {so_bound:.5f} by {so_by}, plain "
          f"{sort_plain:.3f}) against torch.argsort(dim=-1, stable=True) "
          f"{sort_lib:.5f} ms {tag}", flush=True)
    del top_p, dem_p, o_p, s_p

    # the batched tick: two ticks under the sync guard, then the timed
    # run from a kept copy of the start
    tick = make_tick(cfg, device=dev)
    start = st0.apply(torch.clone)
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(2):
        tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(SPACE_TICKS)]
    kernels.reset_launches()
    st = start
    gauges = []
    for a, b in ev:
        a.record()
        st, out = tick(st, inputs)
        b.record()
        gauges.append(torch.stack([out.enter_n, out.sync_n,
                                   out.delta_rows_n]))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != {"sweep_fused": SPACE_TICKS,
                    "counting_sort": SPACE_TICKS, "halo_ship_phase": 0, "npc_mlp": 0}:
        fail(f"[15] the batched tick launched {launches} in {SPACE_TICKS} "
             f"ticks")
    gv = torch.stack(gauges).cpu().numpy()
    if (gv[0, 0] <= 0).any() or (gv[:, 1] <= 0).any():
        fail("[15] a Space had no enters on tick 1 or no sync records")
    ms = np.array([a.elapsed_time(b) for a, b in ev])[1:]
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    keep = (st, inputs)
    profiled[f"batched tick, {SPACES} Spaces"] = \
        lambda: tick(keep[0], keep[1])
    # launches a tick at S = 1 (the same batched path, one Space)
    st1, in1 = multi_world(cfg, 1, SEED, dev)
    kernels.reset_launches()
    for _ in range(4):
        st1, _ = tick(st1, in1)
    at_one = {k: v / 4 for k, v in kernels.LAUNCHES.items()}
    per = {k: v / SPACE_TICKS for k, v in launches.items()}
    if at_one != per:
        fail(f"[15] launches a tick depend on S: {at_one} at S=1, {per} "
             f"at S={SPACES}")
    del st1, in1

    # the same ticks in lockstep with SPACES single-Space ticks
    bad = lockstep_singles(tick, start, inputs, None, SPACE_TICKS)
    if bad:
        fail(f"[15] the batched tick differs from {SPACES} single-Space "
             f"ticks in {bad} words")
    del start
    print(f"[15] batched tick, {SPACES} Spaces x {SPACE_N} (syncs drawn as"
          f" bench_world draws them, {cfg.input_cap} a Space): "
          f"{SPACE_TICKS} ticks, launches {launches} (a tick: {per}, the "
          f"same at S=1); two ticks under the sync guard raised nothing; "
          f"every lane of state and outputs == {SPACES} single-Space "
          f"ticks on every one of {SPACE_TICKS} ticks; tick 1 enter_n "
          f"{gv[0, 0].tolist()}; last tick sync_n {gv[-1, 1].tolist()}, "
          f"delta_rows_n {gv[-1, 2].tolist()}; ms/tick p50={p50:.3f} "
          f"p99={p99:.3f} (ticks 2-{SPACE_TICKS}, CUDA events); "
          f"{n_all / (p50 / 1e3):.4g} entity-ticks/s; [5]'s one Space of "
          f"{N}: p50={bare[0]:.3f} p99={bare[1]:.3f} {tag}", flush=True)

    # the served game of SPACES Spaces at its defaults
    served = serve_world(SPACE_WORLD_N, SEED, dev, boot=True,
                         world_kw=PLANES, spaces=SPACES)
    w = served.world
    n_pop = len(w.entities) - SPACES - 1
    rows, w_launches = world_ticks(served, WORLD_TICKS, teleport=False)
    staged = sum(r["staged"]["migrations"] for r in rows)
    applied = sum(r["migrated"] for r in rows)
    # one more tick whose batched step and fold run under the sync guard
    real_step, real_fold, guard = w._step, w._telem_fn, {}

    def guarded(fn):
        def call(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            except Exception as exc:
                guard["error"] = exc
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    w._step, w._telem_fn = guarded(real_step), guarded(real_fold)
    served.stage()
    w.tick()
    w._step, w._telem_fn = real_step, real_fold
    if guard or w._telem_fn is None:
        fail(f"[15] the World's step or fold under the sync guard: "
             f"{guard.get('error')}")
    planes = planes_check(w, "[15] World")
    print(f"[15] served World of {SPACES} Spaces x {SPACE_WORLD_N} slots "
          f"at its "
          f"defaults: {n_pop} entities ({served.players.size} players) "
          f"booted through {served.boot_ticks} ticks "
          f"({served.boot_events} enter events, none past a Space's cap) "
          f"in {served.populate_s:.2f} s; {WORLD_TICKS} World.ticks "
          f"staging {rows[-1]['staged']} each, launches {w_launches}, one "
          f"sweep and one sort a tick; migrations between Spaces applied "
          f"{applied} of {staged} staged; "
          f"{world_summary(rows, w.cfg)}; one more tick's step and fold "
          f"under the sync guard raised nothing; planes: {planes} "
          f"{tag}", flush=True)
    del served, w
    release_worlds()
    print(f"[15] phase {time.perf_counter() - phase0:.1f} s", flush=True)
    return ({"spaces_batched": launches, "spaces_world": w_launches}, shape,
            (p50, p99))


def nan_same(a, b) -> bool:
    """Bit-for-bit equality with every NaN taken as equal (a NaN's
    payload is the rounding routine's, not the function's)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and same_bits(
        torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def kept_same(a, b) -> bool:
    """Two sinks' kept records equal (sync records by their bytes)."""
    return len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and (
            all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
                for u, v in zip(x[2:], y[2:])) if x[0] == "sync"
            else x[2:] == y[2:]) for x, y in zip(a, b))


def mlp_weights(pol):
    return (pol.w1, pol.b1, pol.w2, pol.b2, pol.w3, pol.b3)


def tick_run(tick, st, inputs, pol, n_ticks: int, want: dict):
    """``n_ticks`` ticks timed by CUDA events, each tick's launches
    checked against ``want``; returns (state, p50, p99, snapshot)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n_ticks)]
    per, snapshot = [], None
    for t in range(n_ticks):
        if t == n_ticks // 2:
            snapshot = st
        c0 = dict(kernels.LAUNCHES)
        ev[t][0].record()
        st, out = tick(st, inputs, pol)
        ev[t][1].record()
        per.append({k: kernels.LAUNCHES[k] - c0[k] for k in c0})
    torch.cuda.synchronize()
    if any(p != want for p in per):
        fail(f"launches a tick {per[:2]}..., want {want}")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([a.elapsed_time(b) for a, b in ev])[1:]
    return st, float(np.percentile(ms, 50)), float(np.percentile(ms, 99)), \
        snapshot


@contextlib.contextmanager
def mlp_held_to_plain():
    """Within the block, every policy forward pass the path makes (the
    wrapper as ``models.npc_policy.policy_accel`` calls it) also runs its
    plain version on the same observation and weights; yields a list of
    (rows, bit-equal) for each call. The plain run launches nothing."""
    seen, real = [], npc_policy.npc_mlp

    def held(obs, *ws, per_row=False):
        out = real(obs, *ws, per_row=per_row)
        seen.append((obs.shape[0],
                     nan_same(out, npc_mlp_plain(obs, *ws, per_row))))
        return out
    npc_policy.npc_mlp = held
    try:
        yield seen
    finally:
        npc_policy.npc_mlp = real


def plain_twin(cfg):
    """``cfg`` on the plain versions of the sweep and the sort."""
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, sweep_impl="ranges", sort_impl="counting"))


def check_twin(what: str, a, b) -> None:
    for x, y in ((a[0], b[0]), (a[1], b[1])):
        la, lb = lanes(x), lanes(y)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"{what}: lane {name} differs from the plain twin")


def behavior_phase(dev, tag, profiled: dict, walk: tuple) -> tuple:
    """[17] NPC behaviors (BASELINE config 5) and the scenario mixes:
    the npc_mlp kernel against its plain version, the card against the
    CPU port, config 5 at 2^20 under btree and mlp, the seven registry
    scenarios, the megaspace and a served World under mlp. Returns the
    kernel's row of the kernels line, the launches of each path and the
    megaspace's p50 under mlp."""
    phase0 = time.perf_counter()
    pol = init_policy(POLICY_SEED, device=dev)
    ws = mlp_weights(pol)
    h = pol.hidden
    # the kernel at config 5's observations: the uncut world after one
    # mlp tick, so the neighbor summary is live
    cfg = behavior_config(N, "mlp")
    g = cfg.grid
    st, inputs, _ = behavior_world(cfg, SEED, dev)
    tick = make_tick(cfg, device=dev)
    st1, _ = tick(st, inputs, pol)
    obs = build_obs(st1.pos, st1.vel, st1.yaw, st1.nbr, st1.nbr_cnt,
                    (g.extent_x, g.extent_z))
    if not nan_same(npc_mlp(obs, *ws), npc_mlp_plain(obs, *ws)):
        fail("[17] npc_mlp differs from its plain version at config 5")
    rng = np.random.default_rng(SEED + 17)
    odd, modes = {}, set()
    for hid in (h, 16):
        ph = ws if hid == h else mlp_weights(init_policy(POLICY_SEED, hid,
                                                         device=dev))
        for rows in (1, 2, 3, 31, 4097):
            x = rng.standard_normal((rows, 10)) * rng.choice(
                [1e-3, 1.0, 30.0, 1e30], (rows, 10))
            x[rng.random((rows, 10)) < 0.05] = 0.0
            x[rng.random((rows, 10)) < 0.05] = -0.0
            x[rng.random((rows, 10)) < 0.02] = 3e38
            x[rng.random((rows, 10)) < 0.02] = -3e38
            x[rng.random((rows, 10)) < 0.01] = np.nan
            xo = torch.tensor(x.astype(np.float32), device=dev)
            modes.add(layer_lanes(rows, hid))
            for wname, pw in (("init_policy(5)", ph), ("random", tuple(
                    torch.tensor(rng.standard_normal(tuple(w.shape)),
                                 dtype=torch.float32, device=dev)
                    .to(torch.bfloat16) for w in ph))):
                a, b = npc_mlp(xo, *pw), npc_mlp_plain(xo, *pw)
                odd[f"h{hid}/{rows}/{wname}"] = nan_same(a, b)
    # layer-2 products straddling 2^-126: the guard's rounded path
    uobs, uws = mlp_underflow_case(1 << 16, SEED, dev)
    odd["underflow"] = nan_same(npc_mlp(uobs, *uws),
                                npc_mlp_plain(uobs, *uws))
    if not all(odd.values()):
        fail(f"[17] npc_mlp differs from its plain version: {odd}")
    # tanh over every bf16 value: the card's float64 tanh and the
    # kernel's table on the card == the CPU's float64 tanh
    allb = torch.arange(65536, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    if not nan_same(tanh_bf16(allb.to(dev)).cpu(), tanh_bf16(allb)) or \
            not nan_same(tanh_by_table(allb.to(dev)).cpu(), tanh_bf16(allb)):
        fail("[17] bf16 tanh on the card differs from the CPU's")
    mlp_ms = time_ms(lambda: npc_mlp(obs, *ws), 20)
    mlp_plain = time_ms(lambda: npc_mlp_plain(obs, *ws), 2, 1)

    def cublas():
        x = obs.to(torch.bfloat16)
        x = torch.tanh(x @ ws[0] + ws[1])
        x = torch.tanh(x @ ws[2] + ws[3])
        return (x @ ws[4] + ws[5]).float()
    mlp_lib = time_ms(cublas, 20)
    mlp_ops = 2 * (10 * h + h * h + 3 * h) * N
    mlp_bytes = N * (10 + 3) * 4 + sum(w.numel() * 2 for w in ws)
    # the operands are bf16: the bound is the tensor cores' rate; the
    # float32 CUDA-core rate bounds only this design, which keeps XLA's
    # summation order (no mma)
    bms, by = bound(mlp_bytes, mlp_ops, PEAK_BF16_S)
    bms_fp32 = bound(mlp_bytes, mlp_ops)[0]
    # read first in [12]
    rest = list(profiled.items())
    profiled.clear()
    profiled["npc_mlp"] = lambda: npc_mlp(obs, *ws)
    profiled.update(rest)
    print(f"[17] npc_mlp: == its plain version bit for bit at {N} rows of "
          f"config 5's observations and at {sorted(odd)} (extremes "
          f"+-3e38, 1e30, 0, -0.0, NaN as NaN; lanes modes "
          f"{sorted(modes)}; the underflow case through layer 2's "
          f"rounded path); bf16 tanh card == CPU on all 65536 inputs, "
          f"by float64 and by the kernel's table; {mlp_ms:.4f} ms a call "
          f"(bound {bms:.4f} ms by "
          f"{by} at the bf16 tensor-core rate; {bms_fp32:.4f} ms at the "
          f"float32 CUDA-core rate, the bound of a design in XLA's "
          f"order), plain {mlp_plain:.2f} ms, cuBLAS bf16 chain (not "
          f"bit-equal) {mlp_lib:.4f} ms {tag}", flush=True)

    # the card against the CPU port, every lane
    launches = {}
    for name in ("btree", "mlp", "mixed"):
        c = scenario_config(FLOAT_N, name) if name == "mixed" \
            else behavior_config(FLOAT_N, name)
        sides = []
        for d in (dev, torch.device("cpu")):
            s, i, p = behavior_world(c, SEED, d)
            tk = make_tick(c, device=d)
            for _ in range(FLOAT_TICKS):
                s, o = tk(s, i, p)
            sides.append((s, o))
        la, lb = lanes(sides[0][0]), lanes(sides[1][0])
        la.update({f"out.{k}": v for k, v in lanes(sides[0][1]).items()})
        lb.update({f"out.{k}": v for k, v in lanes(sides[1][1]).items()})
        bad = [k for k in la if not same_bits(
            la[k], None if lb[k] is None else lb[k].to(dev))]
        if bad:
            fail(f"[17] {name}: the card differs from the CPU port in "
                 f"{bad}")
    print(f"[17] card == CPU port: {FLOAT_N} entities uncut, "
          f"{FLOAT_TICKS} ticks under btree, mlp and mixed, every lane "
          f"and output bit for bit {tag}", flush=True)

    # config 5 at full width
    stage = {}
    for name in ("btree", "mlp"):
        c = behavior_config(N, name)
        s0, i, p = behavior_world(c, SEED, dev)
        tk = make_tick(c, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        tk(s0, i, p)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = {"sweep_fused": 1, "counting_sort": 1,
                "halo_ship_phase": 0, "npc_mlp": int(name == "mlp")}
        kernels.reset_launches()
        s, p50, p99, snap = tick_run(tk, s0, i, p, BEHAVIOR_TICKS, want)
        launches[f"config5_{name}"] = dict(kernels.LAUNCHES)
        check_twin(f"[17] config 5 {name}", tk(snap, i, p),
                   make_tick(plain_twin(c), device=dev)(snap, i, p))
        if name == "mlp":
            # its torch kernels a tick, read in [12]
            profiled["config 5 tick, mlp"] = \
                lambda tk=tk, s=s, i=i, p=p: tk(s, i, p)
        key = prng.split(s.rng)[1]
        ext = (c.grid.extent_x, c.grid.extent_z)
        stage[name] = time_ms(lambda c=c, s=s, p=p: compute_velocity(
            c, key, s.pos, s.yaw, s, p, ext, s.nbr, s.nbr_cnt), 10)
        if name == "btree":
            walk_cfg = dataclasses.replace(c, behavior="random_walk")
            stage["random_walk"] = time_ms(lambda s=s: compute_velocity(
                walk_cfg, key, s.pos, s.yaw, s, None, ext, s.nbr,
                s.nbr_cnt), 10)
        print(f"[17] config 5 {name}: {BEHAVIOR_TICKS} ticks of {N} "
              f"entities uncut (skin {c.grid.skin}), launches a tick "
              f"{want}; one tick under the sync guard; tick "
              f"{BEHAVIOR_TICKS // 2 + 1} == its plain twin (ranges/"
              f"counting) bit for bit; ms/tick p50={p50:.3f} "
              f"p99={p99:.3f} (CUDA events, ticks 2-{BEHAVIOR_TICKS}; "
              f"[5]'s random walk at skin 0 p50={walk[0]:.3f}) {tag}",
              flush=True)
    print(f"[17] behavior stage ms a tick (compute_velocity, events, the "
          f"state after the run): "
          f"{ {k: round(v, 4) for k, v in stage.items()} } {tag}",
          flush=True)

    # every registry scenario, small, beside its plain twin; mixed at
    # full width
    for name in scenario_names():
        c = scenario_config(SCN_N, name)
        s, i, p = behavior_world(c, SEED, dev)
        tk, tp = make_tick(c, device=dev), \
            make_tick(plain_twin(c), device=dev)
        sp = s
        for _ in range(SCN_TICKS):
            a, b = tk(s, i, p), tp(sp, i, p)
            check_twin(f"[17] scenario {name}", a, b)
            s, sp = a[0], b[0]
    c = scenario_config(N, "mixed")
    s0, i, p = behavior_world(c, SEED, dev)
    tk = make_tick(c, device=dev)
    tk(s0, i, p)
    kernels.reset_launches()
    want = {"sweep_fused": 1, "counting_sort": 1, "halo_ship_phase": 0,
            "npc_mlp": 0}
    s, p50, p99, snap = tick_run(tk, s0, i, p, MIXED_TICKS, want)
    launches["mixed"] = dict(kernels.LAUNCHES)
    check_twin("[17] mixed at 2^20", tk(snap, i, p),
               make_tick(plain_twin(c), device=dev)(snap, i, p))
    print(f"[17] scenarios: all {len(scenario_names())} "
          f"({', '.join(scenario_names())}) {SCN_TICKS} ticks at {SCN_N} "
          f"== their plain twins; mixed at {N}: {MIXED_TICKS} ticks, "
          f"p50={p50:.3f} p99={p99:.3f} ms, tick {MIXED_TICKS // 2 + 1} "
          f"== its plain twin {tag}", flush=True)

    # the 2x2 megaspace under mlp
    mc = mega_config(N, MEGA_DEV)
    mc = dataclasses.replace(mc, cfg=dataclasses.replace(mc.cfg,
                                                         behavior="mlp"))
    s0, i = mega_world(mc, N, SEED, dev)
    tk = make_mega_tick(mc, device=dev)
    tk(s0, i, pol)
    kernels.reset_launches()
    want = {"sweep_fused": MEGA_DEV, "counting_sort": MEGA_DEV,
            "halo_ship_phase": 2, "npc_mlp": MEGA_DEV}
    s, p50, p99, snap = tick_run(tk, s0, i, pol, MEGA_TICKS, want)
    launches["megaspace_mlp"] = dict(kernels.LAUNCHES)
    plain = dataclasses.replace(mc, halo_impl="ppermute",
                                cfg=plain_twin(mc.cfg))
    with mlp_held_to_plain() as held:
        got = tk(snap, i, pol)
    if [r for r, _ in held] != [mc.cfg.capacity] * MEGA_DEV or \
            not all(ok for _, ok in held):
        fail(f"[17] megaspace mlp: npc_mlp against its plain version on "
             f"the tiles' observations (rows, equal): {held}")
    check_twin("[17] megaspace mlp", got,
               make_mega_tick(plain, device=dev)(snap, i, pol))
    # its device busy a tick, read in [12] against this p50
    profiled["megaspace tick, mlp"] = \
        lambda tk=tk, snap=snap, i=i: tk(snap, i, pol)
    mega_p50 = p50
    print(f"[17] megaspace 2x2 under mlp: {MEGA_TICKS} ticks of {N}, "
          f"launches a tick {want}; tick {MEGA_TICKS // 2 + 1}: npc_mlp "
          f"== its plain version on each tile's {mc.cfg.capacity} "
          f"observation rows, the tick == its plain twin (ppermute/"
          f"ranges/counting); p50={p50:.3f} "
          f"p99={p99:.3f} ms {tag}", flush=True)

    # a served World under mlp, kernels against the plain versions
    twins = [serve_world(BEHAVIOR_WORLD_N, SEED + 3, dev, keep=True,
                         boot=True, behavior="mlp",
                         sweep_impl=a, sort_impl=b)
             for a, b in (("fused", "pallas"), ("ranges", "argsort"))]
    kernels.reset_launches()
    for t in range(BEHAVIOR_WORLD_TICKS):
        for sv in twins:
            sv.stage()
            with mlp_held_to_plain() as held:
                sv.world.tick()
            if [r for r, _ in held] != [BEHAVIOR_WORLD_N] or not held[0][1]:
                fail(f"[17] served World mlp: npc_mlp against its plain "
                     f"version on the World's observations at tick "
                     f"{t + 1} (rows, equal): {held}")
        ka, kb = (sv.sink.take()["kept"] for sv in twins)
        sa, sb = (interop.state_to_numpy(sv.world.state) for sv in twins)
        if not kept_same(ka, kb) or any(
                sa[k].tobytes() != sb[k].tobytes() for k in sa):
            fail(f"[17] served mlp twin Worlds differ at tick {t + 1}")
    launches["world_mlp"] = dict(kernels.LAUNCHES)
    if launches["world_mlp"]["npc_mlp"] != 2 * BEHAVIOR_WORLD_TICKS:
        fail(f"[17] served World launches {launches['world_mlp']}")
    del twins
    release_worlds()
    print(f"[17] served World of {BEHAVIOR_WORLD_N} slots under mlp: "
          f"{BEHAVIOR_WORLD_TICKS} ticks, npc_mlp == its plain version on "
          f"every tick's {BEHAVIOR_WORLD_N} observation rows, kernel and "
          f"plain-version twins equal in sinks and state; phase "
          f"{time.perf_counter() - phase0:.1f} s {tag}", flush=True)
    row = {
        "name": "npc_mlp", "route": "cuda",
        "source": "goworld_tpu_torch/csrc/npc_mlp.cu",
        "replaces": "goworld_tpu/models/npc_policy.py:109 (policy_accel, "
                    "plain XLA dots; no TPU kernel)",
        "launches": sum(v["npc_mlp"] for v in launches.values()),
        "launches_by_path": {k: v["npc_mlp"] for k, v in launches.items()},
        "max_abs_err": 0, "ms": mlp_ms, "device_ms": None,
        "launches_per_call": None, "plain_ms": mlp_plain,
        "bound_ms": bms, "bound_by": by, "library_ms": mlp_lib,
        "bound_ms_fp32_cuda_cores": bms_fp32,
    }
    return row, launches, mega_p50




# ---------------------------------------------------------------- [19]
# the served game through the port's normal entry, gw.run()
GAME_SLOTS = 1 << 20      # the width of [11]'s World
GAME_MONSTERS = 1 << 16   # random-walking Monsters booted before serving
GAME_BOTS = 64            # strict BotClients through the gate
GAME_GROUP = 4            # bots logged in together, inside one AOI
GAME_WALK_S = 3.0         # seconds the bots walk with position syncs
GAME_BOOT_BUDGET_S = 30.0  # the boot's limit; past it, halve the Monsters


class GameAccount(gw.Entity):
    """The boot entity (``tests/test_cluster.py``'s ``Account``): its
    ``Login_Client`` creates an Avatar in the Arena at the client's
    spot and hands it the client."""

    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"

    def Login_Client(self, name, x, z):
        avatar = self.world.create_entity(
            "Avatar", space=self.world.arena, pos=(float(x), 0.0, float(z)))
        avatar.attrs["name"] = name
        self.give_client_to(avatar)
        self.destroy()


class GameAvatar(gw.Entity):
    """A player: ``Say_Client`` calls ``OnSay`` on every client that
    sees it, and records whose clients the server holds as watchers."""

    ATTRS = {"name": "allclients", "level": "client"}

    def OnClientConnected(self):
        self.attrs["level"] = 1

    def Say_Client(self, text):
        ents = self.world.entities
        seen = sorted(w for w in self.interested_by
                      if w in ents and ents[w].client is not None)
        self.world.said.append((self.id, text, seen))
        self.call_all_clients("OnSay", self.id, text)


class GameMonster(gw.Entity):
    ATTRS = {"hp": "allclients"}


class GameArena(gw.Space):
    pass


def boot_monsters(world, pop: int, seed: int, log: dict) -> None:
    """The served game's boot (an ``on_boot`` callback of ``gw.run``):
    the Arena, then ``pop`` Monsters uniform over the extent, entered in
    batches through ticks whose events stay within half of
    ``enter_cap`` at the population's own density (``workload``'s
    ``_boot_batch`` rule), each boot tick's caps checked."""
    t0 = time.perf_counter()
    world.arena = world.create_space("Arena")
    world.said = []
    cfg, g = world.cfg, world.cfg.grid
    rng = np.random.default_rng(seed)
    pos = np.zeros((pop, 3))
    pos[:, 0] = rng.uniform(0, g.extent_x, pop)
    pos[:, 2] = rng.uniform(0, g.extent_z, pop)
    nb = pop * (2.0 * g.radius) ** 2 / (g.extent_x * g.extent_z)
    done = ticks = events = 0
    while done < pop:
        hi = min(pop, done + max(1, int(
            -done + np.sqrt(done ** 2 + cfg.enter_cap / 2.0 * pop / nb))))
        for i in range(done, hi):
            world.arena.create_entity("Monster", pos=tuple(pos[i]),
                                      moving=True, attrs={"hp": 100})
        done = hi
        before = dict(kernels.LAUNCHES)
        world.tick()
        if world.device.type == "cuda":
            check_game_launches(before, f"boot tick {ticks + 1}")
        out = world.last_outputs
        for lane, cap in (("enter_n", cfg.enter_cap),
                          ("leave_n", cfg.leave_cap),
                          ("delta_rows_n", cfg.delta_rows_cap_eff)):
            if int(getattr(out, lane).max()) > cap:
                fail(f"[19] boot tick {ticks + 1}: {lane} > {cap}")
        ticks += 1
        events += int(out.enter_n.sum())
    log.update(seconds=time.perf_counter() - t0, ticks=ticks,
               events=events, monsters=pop)


def check_game_launches(before: dict, what: str, want: dict | None = None,
                        label: str = "[19]") -> None:
    got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if got != (want or {"sweep_fused": 1, "counting_sort": 1,
                        "halo_ship_phase": 0, "npc_mlp": 0}):
        fail(f"{label} {what} launched {got}")


def game_spots(world, groups: int, size: int, seed: int) -> list:
    """Where the bots log in: ``groups`` spots where the Monsters are
    densest (the cells of side ``radius`` holding the most), ``size``
    bots a spot a few units apart, so that each bot has Monsters and
    its group in its AOI."""
    r = world.cfg.grid.radius
    alive = world.state.alive[0].cpu().numpy()
    xz = world.state.pos[0][:, [0, 2]].cpu().numpy()[alive]
    cell = np.floor(xz / r).astype(np.int64)
    key = cell[:, 0] * (1 << 20) + cell[:, 1]
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    spots = []
    rng = np.random.default_rng(seed)
    for c in np.argsort(-cnt, kind="stable")[:groups]:
        x, z = xz[inv == c].mean(0)
        spots += [(float(x + rng.uniform(-3, 3)), float(z + rng.uniform(-3, 3)))
                  for _ in range(size)]
    return spots


async def bots_login(bots, spots) -> float:
    """Connect every bot, wait for its Account, log it in at its spot
    and wait for its Avatar: the logins' wall seconds."""
    t0 = time.perf_counter()
    await asyncio.gather(*(b.connect() for b in bots))
    for b in bots:
        b._recv_task = asyncio.ensure_future(b._recv_loop())
    await asyncio.wait_for(asyncio.gather(
        *(b.player_ready.wait() for b in bots)), 120)
    for b, (x, z) in zip(bots, spots):
        b.call_server("Login_Client", f"bot{b.bot_id}", x, z)
    for _ in range(2400):
        if all(b.player is not None and b.player.type_name == "Avatar"
               for b in bots):
            break
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def bots_walk(bots, seconds: float) -> None:
    """Every bot random-walks with position syncs for ``seconds``."""
    for b in bots:
        b._stop = False
    moves = [asyncio.ensure_future(b._move_loop()) for b in bots]
    await asyncio.sleep(seconds)
    for b in bots:
        b._stop = True
    for m in moves:
        m.cancel()
    await asyncio.gather(*moves, return_exceptions=True)


async def bots_say(bots, world) -> None:
    """Every bot says one line; wait until the server recorded each say
    and every client it names as a watcher got the ``OnSay``."""
    for b in bots:
        b.call_server("Say_Client", f"hello from bot{b.bot_id}")
    by_eid = {b.player.eid: b for b in bots}
    for _ in range(2400):
        said = list(world.said)
        if len(said) == len(bots) and all(
                any(m == "OnSay" and a == [sp, text]
                    for _, m, a in by_eid[w].rpc_log)
                for sp, text, seen in said for w in [sp, *seen]):
            return
        await asyncio.sleep(0.05)


async def bots_leave(bots) -> None:
    for b in bots:
        await b.conn.close()
        b._recv_task.cancel()
        if getattr(b, "_hb_task", None) is not None:
            b._hb_task.cancel()


def traced_bot_class():
    """A ``BotClient`` that stamps, per mirrored entity, the server's
    tick count at its last create and its last destroy (read off
    ``TracedBot.tick``, which the game loop sets), for the mirror
    printout of [19]."""
    from goworld_tpu_torch.net import proto
    from goworld_tpu_torch.net.botclient import BotClient

    class TracedBot(BotClient):
        tick = [0]

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stamps: dict = {}

        def _handle_inner(self, msgtype, pkt):
            if msgtype in (proto.MT_CREATE_ENTITY_ON_CLIENT,
                           proto.MT_DESTROY_ENTITY_ON_CLIENT):
                eid = bytes(pkt.buf[pkt.rpos:pkt.rpos + 16]).decode(
                    "ascii", "replace")
                st = self.stamps.setdefault(eid, [None, None])
                st[msgtype == proto.MT_DESTROY_ENTITY_ON_CLIENT] = \
                    self.tick[0]
            super()._handle_inner(msgtype, pkt)

    return TracedBot


def mirror_report(world, avatar, bot, server_stamps: dict) -> list:
    """Each entity where ``bot``'s mirror and ``avatar``'s interest set
    differ: its id and type, its distance to the Avatar (the sweep's
    Chebyshev distance on x, z and the Euclidean one), its rank by
    that distance among the Space's live rows (1 = nearest; the
    server's list holds the k nearest, k = the grid's), where it is
    (server, mirror, both) and the tick of its last enter and leave on
    the server (``server_stamps``) and of its last create and destroy
    at the bot."""
    ents = world.entities
    want = {avatar.id, *avatar.interested_in}
    got = set(bot.entities)
    if avatar.slot is None:
        return [f"{avatar.id}: no slot"]
    sh = avatar.shard
    pos = world.state.pos[sh].cpu().numpy()
    alive = world.state.alive[sh].cpu().numpy()
    me = pos[avatar.slot]
    cheb = np.maximum(np.abs(pos[:, 0] - me[0]), np.abs(pos[:, 2] - me[2]))
    cheb = np.where(alive, cheb, np.inf)
    cheb[avatar.slot] = np.inf
    out = []
    for eid in sorted(want ^ got):
        e = ents.get(eid)
        side = "server only" if eid in want else "mirror only"
        if e is None or e.slot is None or e.shard != sh:
            out.append(f"{eid} ({side}): not a live row of the Space "
                       f"(type {getattr(e, 'type_name', None)}); bot "
                       f"create/destroy ticks {bot.stamps.get(eid)}")
            continue
        p = pos[e.slot]
        d = float(cheb[e.slot])
        rank = int((cheb < d).sum()) + 1
        eu = float(np.hypot(p[0] - me[0], p[2] - me[2]))
        out.append(
            f"{eid} {e.type_name} ({side}): chebyshev {d:.3f}, euclid "
            f"{eu:.3f}, rank {rank} (k {world.cfg.grid.k}, radius "
            f"{world.cfg.grid.radius}); server enter/leave ticks "
            f"{server_stamps.get((avatar.id, eid))}; bot create/destroy "
            f"ticks {bot.stamps.get(eid)}")
    return out


def served_game_phase(dev, tag: str, slots: int = GAME_SLOTS,
                      monsters: int = GAME_MONSTERS,
                      n_bots: int = GAME_BOTS) -> dict:
    """[19] (see the module docstring): launches of the served game's
    ticks (boot, serving, the restored World's first)."""
    from goworld_tpu_torch import api
    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.net.game import GameServer
    from goworld_tpu_torch.net.standalone import ClusterHarness

    BotClient = traced_bot_class()
    phase0 = time.perf_counter()
    kernels.reset_launches()
    grid = slice_config(slots).grid
    extent = grid.extent_x
    harness = ClusterHarness(n_dispatchers=2, n_gates=1, desired_games=1,
                             position_sync_interval_ms=50)
    harness.start()
    home = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="served_game_")
    rt = None
    try:
        os.chdir(tmp)
        disp = "".join(f"[dispatcher{i + 1}]\nhost = {h}\nport = {p}\n\n"
                       for i, (h, p) in enumerate(harness.dispatcher_addrs))
        with open("goworld_tpu.ini", "w") as f:
            f.write(
                f"{disp}[game_common]\nboot_entity = Account\n"
                f"capacity = {slots}\nn_spaces = 1\naoi_radius = 50.0\n"
                f"extent_x = {extent}\nextent_z = {extent}\n"
                f"aoi_k = {grid.k}\naoi_cell_cap = {grid.cell_cap}\n"
                "aoi_sweep_impl = fused\naoi_sort_impl = pallas\n"
                "position_sync_interval_ms = 50\n\n[game1]\n\n[gate1]\n"
                f"host = {harness.gate_addrs[0][0]}\n"
                f"port = {harness.gate_addrs[0][1]}\n\n"
                "[storage]\nkind = filesystem\ndirectory = entity_storage\n"
                "\n[kvdb]\nkind = filesystem\npath = kvdb_data\n")
        gw.register_entity("Account", GameAccount)
        gw.register_entity("Avatar", GameAvatar)
        gw.register_entity("Monster", GameMonster)
        gw.register_space("Arena", GameArena)
        boot = {}
        gw.on_boot(lambda w: boot_monsters(w, monsters, SEED, boot))
        rt = gw.run(["-gid", "1", "-configfile", "goworld_tpu.ini"],
                    block=False, device=dev.type)
        server, world = rt.server, rt.world
        if world.device.type != dev.type or \
                world.cfg.grid.sweep_impl != "fused" or \
                world.cfg.grid.sort_impl != "pallas":
            fail(f"[19] gw.run built {world.device} "
                 f"{world.cfg.grid.sweep_impl}/{world.cfg.grid.sort_impl}")
        if "seconds" not in boot:
            fail("[19] the on_boot callback failed (logged above)")
        if boot["seconds"] > GAME_BOOT_BUDGET_S:
            print(f"[19] note: the boot of {monsters} Monsters took "
                  f"{boot['seconds']:.1f} s, over {GAME_BOOT_BUDGET_S} s",
                  flush=True)
        gc.collect()
        gc.freeze()   # as serve_forever does at boot (ini gc_freeze)
        tl = metrics.timeline
        rows = []
        # (avatar, entity) -> [tick of its last enter, of its last
        # leave] in the avatar's interest set on the server
        stamps: dict = {}
        seen_sets: dict = {}

        def stamp_interest() -> None:
            t = world.tick_count
            for b in bots:
                av = b.player
                e = world.entities.get(av.eid) if av is not None else None
                if e is None or e.type_name != "Avatar":
                    continue
                now = set(e.interested_in)
                before_ = seen_sets.get(e.id, set())
                for x in now - before_:
                    stamps.setdefault((e.id, x), [None, None])[0] = t
                for x in before_ - now:
                    stamps.setdefault((e.id, x), [None, None])[1] = t
                seen_sets[e.id] = now

        def game_tick(timed: bool) -> None:
            before = dict(kernels.LAUNCHES)
            tl.begin_tick()
            t0 = time.perf_counter()
            with tl.span("drain_inputs"):
                server.pump()
            server.tick()
            wall = time.perf_counter() - t0
            tl.end_tick()
            BotClient.tick[0] = world.tick_count
            stamp_interest()
            if dev.type == "cuda":
                check_game_launches(before, f"game tick {len(rows) + 1}")
            rows.append((timed, wall, {name: d for name, _, d, _ in
                                       tl.records()[-1][2]}))

        def tick_until(fut, timed: bool, limit: float = 300.0):
            t_end = time.perf_counter() + limit
            while not fut.done():
                if time.perf_counter() > t_end:
                    fail("[19] the bots did not finish within "
                         f"{limit:.0f} s")
                game_tick(timed)
            return fut.result(timeout=1)

        bots = [BotClient(*harness.gate_addrs[0], bot_id=i, strict=True,
                          speed=1.0, move_interval=0.1, seed=SEED + i)
                for i in range(n_bots)]
        spots = game_spots(world, n_bots // GAME_GROUP, GAME_GROUP, SEED)
        login_s = tick_until(harness.submit(bots_login(bots, spots)), False)
        avatars = {b.player.eid: b for b in bots if b.player is not None
                   and b.player.type_name == "Avatar"}
        if len(avatars) != n_bots:
            fail(f"[19] {len(avatars)} of {n_bots} logins reached an "
                 "Avatar")
        t_win = time.perf_counter()
        tick_until(harness.submit(bots_walk(bots, GAME_WALK_S)), True)
        tick_until(harness.submit(bots_say(bots, world)), True)
        win_s = time.perf_counter() - t_win
        # the end of the window: two more ticks, then the card rests
        # while the gate's last flushes reach the bots
        for _ in range(2):
            game_tick(False)
        time.sleep(1.0)
        errors = [e for b in bots for e in b.errors]
        if errors:
            fail(f"[19] strict mirrors report {len(errors)} errors: "
                 f"{errors[:4]}")
        ents = world.entities
        mons, mism = [], []
        for eid, b in avatars.items():
            want = {eid, *ents[eid].interested_in}
            got = set(b.entities)
            if got != want:
                mism.append((b.bot_id, len(got ^ want)))
            mons.append(sum(ents[e].type_name == "Monster" for e in want
                            if e in ents))
        if mism:
            # ROADMAP C9: every differing entity, readable
            for eid, b in avatars.items():
                for line in mirror_report(world, ents[eid], b, stamps):
                    print(f"[19] C9 bot{b.bot_id} avatar {eid} at tick "
                          f"{world.tick_count}: {line}", flush=True)
            fail(f"[19] bot mirrors differ from the server's interest "
                 f"sets: (bot, words) {mism[:8]}")
        if min(mons) < 1:
            fail(f"[19] a bot has no Monster in its AOI: {mons}")
        said = list(world.said)
        groups = {eid: {a for a, b2 in avatars.items()
                        if b2.bot_id // GAME_GROUP == b.bot_id // GAME_GROUP}
                  for eid, b in avatars.items()}
        deliveries = 0
        for sp, text, seen in said:
            for w in [sp, *seen]:
                if not any(m == "OnSay" and a == [sp, text]
                           for _, m, a in avatars[w].rpc_log):
                    fail(f"[19] OnSay of {sp} did not reach {w}")
                deliveries += 1
            if not groups[sp] <= {sp, *seen}:
                fail(f"[19] {sp}'s group is not in its AOI at its say")
        if len(said) != n_bots:
            fail(f"[19] {len(said)} of {n_bots} says reached the server")
        tick_until(harness.submit(bots_leave(bots)), False)
        for _ in range(200):
            if all(ents[e].client is None for e in avatars):
                break
            game_tick(False)
        if any(ents[e].client is not None for e in avatars):
            fail("[19] the server still binds a client after the bots left")
        # freeze (the SIGHUP path): every dispatcher acks, then the
        # serve loop's freeze writes the file and stops the server
        server.request_freeze()
        for _ in range(2000):
            if server.run_state == "freezing":
                server._do_freeze()
                break
            game_tick(False)
        path = os.path.join(tmp, freeze_mod.freeze_filename(1))
        if server.run_state != "frozen" or not os.path.isfile(path):
            fail(f"[19] freeze: run state {server.run_state}, file "
                 f"{os.path.isfile(path)}")
        frozen = {e.id: (e.type_name, e.attrs.to_dict(), e.position,
                         e.yaw) for e in ents.values()
                  if not e.destroyed and e.slot is not None}
        # a fresh World of the same ini restores through the server
        t0 = time.perf_counter()
        gc_ = rt.world   # keep the frozen World for the comparison
        w2 = api._build_world(api.config_mod.load("goworld_tpu.ini")
                              .games[1], 1, dev.type)
        api._apply_registrations(w2)
        gs2 = GameServer(1, w2, [], restore=True, freeze_dir=tmp)
        restore_s = time.perf_counter() - t0
        back = {e.id: (e.type_name, e.attrs.to_dict(), e.position, e.yaw)
                for e in w2.entities.values()
                if not e.destroyed and e.slot is not None}
        if back != frozen:
            diff = [k for k in frozen if back.get(k) != frozen[k]]
            fail(f"[19] the restored World differs from the frozen one in "
                 f"{len(diff) + len(set(back) - set(frozen))} entities")
        before = dict(kernels.LAUNCHES)
        gs2.tick()
        if dev.type == "cuda":
            check_game_launches(before, "the restored World's first tick")
        launches = dict(kernels.LAUNCHES)
        win = [w for t, w, _ in rows if t]
        wall = np.array(win) * 1e3
        spans = {k: float(np.mean([s.get(k, 0.0) for t, _, s in rows if t]))
                 * 1e3 for k in rows[-1][2]}
        print(f"[19] served game through gw.run() (ini: {slots} slots, "
              f"fused/pallas, 2 dispatchers, 1 gate over TCP): boot of "
              f"{boot['monsters']} Monsters in {boot['seconds']:.2f} s over "
              f"{boot['ticks']} ticks ({boot['events']} enter events); "
              f"{n_bots}/{n_bots} logins in {login_s:.2f} s; window "
              f"{win_s:.2f} s: {len(win)} game ticks (pump + tick) p50 "
              f"{np.percentile(wall, 50):.3f} p99 "
              f"{np.percentile(wall, 99):.3f} ms, mean span ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
              + f"; {len(rows)} game ticks in all, 1 sweep + 1 sort launch "
              f"each (launches {launches}); strict mirrors 0 errors; every "
              f"mirror == its Avatar's interest set (Monsters a bot min "
              f"{min(mons)} mean {np.mean(mons):.1f}); {len(said)} says, "
              f"{deliveries} OnSay deliveries; frozen to "
              f"{os.path.getsize(path)} B, restored {len(back)} entities "
              f"in {restore_s:.2f} s, equal, first tick ran; phase "
              f"{time.perf_counter() - phase0:.1f} s {tag}", flush=True)
        del gc_, w2, gs2
        return launches
    finally:
        os.chdir(home)
        if rt is not None:
            rt.server.stop()
            rt.storage.shutdown()
            rt.workers.wait_clear()
        harness.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        release_worlds()


# ---------------------------------------------------------------- [20]

def slice_configs(base) -> dict:
    """``base`` under the btree, the mlp policy and the mixed scenario."""
    from goworld_tpu_torch.scenarios.spec import resolve_bench_behavior

    behavior, spec = resolve_bench_behavior("mixed")
    return {"btree": dataclasses.replace(base, behavior="btree"),
            "mlp": dataclasses.replace(base, behavior="mlp"),
            "mixed": dataclasses.replace(base, behavior=behavior,
                                         scenario=spec)}


def lockstep_singles(tick, start, inputs, pol, n_ticks: int) -> int:
    """``n_ticks`` batched ticks from ``start`` beside one single-Space
    tick a Space on its view; the words that differ."""
    spaces = start.pos.shape[0]
    singles = [tile_view(start, d).apply(torch.clone) for d in range(spaces)]
    one_in = [TickInputs(**{f.name: getattr(inputs, f.name)[d]
                            for f in dataclasses.fields(TickInputs)})
              for d in range(spaces)]
    st, diffs = start, []
    for _ in range(n_ticks):
        st, out = tick(st, inputs, pol)
        for d in range(spaces):
            singles[d], o1 = tick(singles[d], one_in[d], pol)
            la, lb = lanes(tile_view(st, d)), lanes(singles[d])
            oa = lanes(type(out)(**{f.name: getattr(out, f.name)[d]
                                    for f in dataclasses.fields(out)}))
            ob = lanes(o1)
            diffs += [diff_count(la[k], lb[k]) for k in la
                      if la[k] is not None or lb[k] is not None]
            diffs += [diff_count(oa[k], ob[k]) for k in oa]
    return int(torch.stack(diffs).sum())


def slice_phase(dev, tag, profiled: dict, walk: tuple) -> dict:
    """[20] this slice on the card: the batched tick of SPACES x SPACE_N
    under btree, mlp and mixed (SLICE_TICKS ticks by events, launches a
    tick, two ticks under the sync guard, one tick against its plain
    twin, SLICE_LOCKSTEP ticks in lockstep with single-Space ticks);
    SLICE_FLOAT_SPACES Spaces of FLOAT_N on the card and the CPU port,
    bit-equal; the served World of SPACES Spaces under mlp with its
    migrations, and its kernel/plain twins; the bench world uncut at q16
    under mlp; the sweep impls at 2^20 and on a clustered world. Returns
    the launches by path. ``walk`` is [15]'s random-walk p50/p99."""
    phase0 = time.perf_counter()
    launches = {}
    pol = init_policy(POLICY_SEED, device=dev)
    base = multi_config(SPACES, SPACE_N)
    for name, cfg in slice_configs(base).items():
        p = pol if name == "mlp" else None
        st0, inputs = multi_world(cfg, SPACES, SEED, dev)
        start = st0.apply(torch.clone)
        tick = make_tick(cfg, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        for _ in range(2):
            tick(st0, inputs, p)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = {"sweep_fused": 1, "counting_sort": 1, "halo_ship_phase": 0,
                "npc_mlp": int(name == "mlp")}
        kernels.reset_launches()
        st, p50, p99, snap = tick_run(tick, start.apply(torch.clone), inputs,
                                      p, SLICE_TICKS, want)
        launches[f"spaces_{name}"] = dict(kernels.LAUNCHES)
        with mlp_held_to_plain() as held:
            got = tick(snap, inputs, p)
        if name == "mlp" and (held != [(SPACES * SPACE_N, True)]):
            fail(f"[20] {SPACES} Spaces mlp: npc_mlp against its plain "
                 f"version on the batched observations (rows, equal): "
                 f"{held}")
        check_twin(f"[20] {SPACES} Spaces {name}", got,
                   make_tick(plain_twin(cfg), device=dev)(snap, inputs, p))
        bad = lockstep_singles(tick, start, inputs, p, SLICE_LOCKSTEP)
        if bad:
            fail(f"[20] {name}: the batched tick differs from {SPACES} "
                 f"single-Space ticks in {bad} words")
        if name == "mlp":
            keep = (st, inputs)
            profiled[f"batched tick, {SPACES} Spaces, mlp"] = \
                lambda k=keep, tk=tick: tk(k[0], k[1], pol)
        print(f"[20] batched tick, {SPACES} Spaces x {SPACE_N} under "
              f"{name}: {SLICE_TICKS} ticks, launches a tick {want}; two "
              f"ticks under the sync guard; tick {SLICE_TICKS // 2 + 1} =="
              f" its plain twin (ranges/counting; under mlp npc_mlp == its "
              f"plain version on all {SPACES * SPACE_N} rows); "
              f"{SLICE_LOCKSTEP} ticks "
              f"== {SPACES} single-Space ticks in every lane; ms/tick "
              f"p50={p50:.3f} p99={p99:.3f} (CUDA events, ticks "
              f"2-{SLICE_TICKS}; [15]'s random walk p50={walk[0]:.3f} "
              f"p99={walk[1]:.3f}) {tag}", flush=True)
        del st0, start, st, snap
    # several Spaces on the card against the CPU port, every lane
    small = multi_config(SLICE_FLOAT_SPACES, FLOAT_N)
    for name, cfg in slice_configs(small).items():
        sides = []
        for d in (dev, torch.device("cpu")):
            s_, i_ = multi_world(cfg, SLICE_FLOAT_SPACES, SEED, d)
            p = init_policy(POLICY_SEED, device=d) if name == "mlp" \
                else None
            tk = make_tick(cfg, device=d)
            for _ in range(FLOAT_TICKS):
                s_, o_ = tk(s_, i_, p)
            sides.append((s_, o_))
        la, lb = lanes(sides[0][0]), lanes(sides[1][0])
        la.update({f"out.{k}": v for k, v in lanes(sides[0][1]).items()})
        lb.update({f"out.{k}": v for k, v in lanes(sides[1][1]).items()})
        bad = [k for k in la if not same_bits(
            la[k], None if lb[k] is None else lb[k].to(dev))]
        if bad:
            fail(f"[20] {SLICE_FLOAT_SPACES} Spaces {name}: the card "
                 f"differs from the CPU port in {bad}")
    print(f"[20] card == CPU port: {SLICE_FLOAT_SPACES} Spaces x "
          f"{FLOAT_N}, {FLOAT_TICKS} ticks under btree, mlp and mixed, "
          f"every lane and output bit for bit {tag}", flush=True)

    # the served World of SPACES Spaces, its Mobs under mlp
    served = serve_world(SPACE_WORLD_N, SEED, dev, boot=True,
                         world_kw=PLANES, spaces=SPACES, behavior="mlp")
    w = served.world
    n_pop = len(w.entities) - SPACES - 1
    rows, w_launches = world_ticks(served, SLICE_WORLD_TICKS,
                                   teleport=False, mlp=True)
    launches["spaces_world_mlp"] = w_launches
    staged = sum(r["staged"]["migrations"] for r in rows)
    applied = sum(r["migrated"] for r in rows)
    print(f"[20] served World of {SPACES} Spaces x {SPACE_WORLD_N} slots "
          f"under mlp at its defaults: {n_pop} entities booted through "
          f"{served.boot_ticks} ticks in {served.populate_s:.2f} s; "
          f"{SLICE_WORLD_TICKS} World.ticks of [15]'s traffic, launches "
          f"{w_launches} (one sweep, one sort and one npc_mlp a tick); "
          f"migrations applied {applied} of {staged} staged; "
          f"{world_summary(rows, w.cfg)} {tag}", flush=True)
    del served, w
    release_worlds()
    twins = [serve_world(SLICE_TWIN_N, SEED + 5, dev, keep=True, boot=True,
                         record_hooks=True, spaces=SPACES, behavior="mlp",
                         sweep_impl=a, sort_impl=b)
             for a, b in (("fused", "pallas"), ("ranges", "argsort"))]
    for t in range(SLICE_TWIN_TICKS):
        for sv in twins:
            sv.stage()
            sv.world.tick()
        ka, kb = (sv.sink.take()["kept"] for sv in twins)
        sa, sb = (interop.state_to_numpy(sv.world.state) for sv in twins)
        if not kept_same(ka, kb) or twins[0].hooks != twins[1].hooks or \
                any(sa[k].tobytes() != sb[k].tobytes() for k in sa):
            fail(f"[20] the served mlp twins of {SPACES} Spaces differ at "
                 f"tick {t + 1}")
    print(f"[20] twin Worlds of {SPACES} Spaces x {SLICE_TWIN_N} under mlp"
          f" with migrations, kernels and plain versions: equal in sinks, "
          f"hooks and state for {SLICE_TWIN_TICKS} ticks {tag}", flush=True)
    del twins
    release_worlds()

    # the bench world uncut at q16 under mlp
    cfg = behavior_config(N, "mlp", precision="q16")
    s0, i, p = behavior_world(cfg, SEED, dev)
    tk = make_tick(cfg, device=dev)
    tk(s0, i, p)
    kernels.reset_launches()
    want = {"sweep_fused": 1, "counting_sort": 1, "halo_ship_phase": 0,
            "npc_mlp": 1}
    s, p50, p99, snap = tick_run(tk, s0, i, p, SLICE_Q16_TICKS, want)
    launches["q16_mlp"] = dict(kernels.LAUNCHES)
    if s.vel.dtype != torch.bfloat16:
        fail(f"[20] q16 mlp: velocity lane {s.vel.dtype}")
    check_twin("[20] q16 mlp", tk(snap, i, p),
               make_tick(plain_twin(cfg), device=dev)(snap, i, p))
    print(f"[20] bench world uncut at q16 under mlp: {SLICE_Q16_TICKS} "
          f"ticks of {N}, launches a tick {want}, the velocity lane "
          f"bfloat16, tick {SLICE_Q16_TICKS // 2 + 1} == its plain twin; "
          f"ms/tick p50={p50:.3f} p99={p99:.3f} {tag}", flush=True)
    del s0, s, snap

    # the sweep impls at 2^20, skin 0
    g = slice_config(N).grid
    st, _ = bench_world(slice_config(N), SEED, dev)
    flags = st.dirty.to(torch.int32) | (st.has_client.to(torch.int32) << 1)

    def sweep(**kw):
        spec = dataclasses.replace(g, **kw)
        return lambda: grid_neighbors_flags(
            spec, st.pos, st.alive, watch_radius=st.aoi_radius,
            flag_bits=flags, with_stats=True)

    def equal(a, b, rows=None):
        if rows is not None:
            return all(torch.equal(x[rows], y[rows])
                       for x, y in zip(a[:3], b[:3]))
        return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and \
            all(int(x) == int(y) for x, y in zip(a[3], b[3]))

    runs = {k: sweep(**kw) for k, kw in (
        ("fused", {}), ("table", dict(sweep_impl="table")),
        ("cellrow", dict(sweep_impl="cellrow")),
        ("shift", dict(sweep_impl="shift")),
        ("ranges_f32", dict(sweep_impl="ranges", topk_impl="f32")),
        ("ranges_approx", dict(sweep_impl="ranges", topk_impl="approx")),
        ("fused_f32", dict(topk_impl="f32")),
        ("fused_approx", dict(topk_impl="approx")))}
    got = {k: f() for k, f in runs.items()}
    ok = ~window_over_cap(g, st.pos, st.alive, st.aoi_radius)
    checks = {
        "cellrow == table": equal(got["cellrow"], got["table"]),
        "approx == f32 (ranges)": equal(got["ranges_approx"],
                                        got["ranges_f32"]),
        "approx == f32 (fused)": equal(got["fused_approx"],
                                       got["fused_f32"]),
        "shift == table below the caps": equal(got["shift"], got["table"],
                                               ok)}
    if not all(checks.values()):
        fail(f"[20] sweep impls at {N}: {checks}")
    del got
    ms = {k: time_ms(f, 5, 1) for k, f in runs.items()}
    # a clustered world of 4096 (cells past cell_cap): shift on the card
    # == the CPU port's shift
    crng = np.random.default_rng(SEED + 31)
    cn = FLOAT_N
    cg = slice_config(cn, sweep_impl="shift").grid
    cpos = np.zeros((cn, 3), np.float32)
    cpos[:, 0] = crng.uniform(0, cg.extent_x, cn)
    cpos[:, 2] = crng.uniform(0, cg.extent_z, cn)
    cpos[:cn // 3, 0] = 200.0 + crng.uniform(0, 150, cn // 3)
    cpos[:cn // 3, 2] = 200.0 + crng.uniform(0, 150, cn // 3)
    calive = crng.random(cn) < 0.95
    cflags = crng.integers(0, 4, cn).astype(np.int32)
    cradius = np.where(crng.random(cn) < 0.2, 20.0, np.inf) \
        .astype(np.float32)
    outs = [grid_neighbors_flags(
        cg, *(torch.tensor(x, device=d) for x in (cpos, calive)),
        watch_radius=torch.tensor(cradius, device=d),
        flag_bits=torch.tensor(cflags, device=d), with_stats=True)
        for d in (dev, "cpu")]
    over = int(outs[1][3][3])
    if over <= 0 or not all(same_bits(x.cpu(), y) for x, y in
                            zip(outs[0][:3], outs[1][:3])) or \
            [int(x) for x in outs[0][3]] != [int(x) for x in outs[1][3]]:
        fail(f"[20] shift on the clustered world: the card differs from "
             f"the CPU port ({over} cells past cell_cap)")
    print(f"[20] sweep impls at {N}, skin 0: "
          f"{ {k: v for k, v in checks.items()} } ({int(ok.sum())} rows "
          f"below the caps, {int((~ok).sum())} apart); "
          f"grid_neighbors_flags ms by events "
          f"{ {k: round(v, 3) for k, v in ms.items()} }; shift on a "
          f"clustered world of {cn} ({over} cells past cell_cap): card =="
          f" CPU port bit for bit; phase {time.perf_counter() - phase0:.1f}"
          f" s {tag}", flush=True)
    return launches


def underflow_on_card(dev, tag: str) -> dict:
    """[17] the subnormal gate: ``workload.underflow_world``'s 4 ticks
    (``tests/test_torch_cap.py``'s underflow case, 512 rows) under mlp
    and under the random walk, on the card against the CPU port, which
    gives the jitted JAX tick's flushed bits: each tick the card
    restarts from the CPU port's state (as the test restarts the port
    from JAX's), and every word of every lane must agree. Then the
    flush helpers on float32's edge words and at the tininess edge, on
    the card against the CPU, and ``npc_mlp`` on ``mlp_underflow_case``
    against the CPU port's plain version under the flush scope. Returns
    the differing words by behavior (all 0, else the run fails)."""
    from goworld_tpu_torch.ops import xla_order as xo
    from goworld_tpu_torch.utils import fpenv

    words_by = {}
    for behavior in ("mlp", "random_walk"):
        cfg, st_c, in_c, pol_c = underflow_world(512, device="cpu",
                                                 behavior=behavior)
        _, _, in_g, pol_g = underflow_world(512, device=dev,
                                            behavior=behavior)
        tick_c = make_tick(cfg, device="cpu")
        tick_g = make_tick(cfg, device=dev)
        diffs = {}
        for _ in range(4):
            st_g = interop.state_from_numpy(interop.state_to_numpy(st_c),
                                            dev)
            st_c, out_c = tick_c(st_c, in_c, pol_c)
            st_g, out_g = tick_g(st_g, in_g, pol_g)
            for what, a, b in (("", st_c, st_g), ("out.", out_c, out_g)):
                la, lb = lanes(a), lanes(b)
                for name, x in la.items():
                    if x is None or name.startswith("aoi_cache"):
                        continue
                    n = int((words(x) != words(lb[name].cpu())).sum())
                    if n:
                        diffs[what + name] = diffs.get(what + name, 0) + n
        words_by[behavior] = diffs
    # the helpers at float32's edges: the card's ops == the CPU's
    bits = np.array([0x00800000, 0x80800000, 0x007FFFFF, 0x807FFFFF,
                     0x00000001, 0x80000001, 0x0, 0x80000000, 0x7FC00000,
                     0x7F800000, 0xFF800000, 0x7F7FFFFF, 0x3F800000],
                    np.uint32).view(np.float32)
    rng = np.random.default_rng(SEED + 29)
    a = (rng.uniform(1, 2, 1 << 16) * np.exp2(rng.integers(-70, -55,
                                                           1 << 16)))
    b = (rng.uniform(1, 2, 1 << 16) * np.exp2(rng.integers(-70, -55,
                                                           1 << 16)))
    a, b = a.astype(np.float32), b.astype(np.float32)
    # exact float64 values at and around the tininess edge
    t = 2.0 ** -126
    edge = np.array([t - 2.0 ** -150, t - 2.0 ** -151, t - 2.0 ** -151
                     - 2.0 ** -170, t - 2.0 ** -151 + 2.0 ** -170,
                     2.0 ** -150, t], np.float64)
    edge = np.concatenate([edge, -edge])

    def helpers(d):
        x, pa, pb = (torch.tensor(v, device=d) for v in (bits, a, b))
        # a / (1 / b) and the fused residual of a * b: quotients and
        # sums that land around 2^-126 too
        return (xo.ftz(x), xo.mul32(pa, pb),
                xo.div32(pa, (1.0 / pb.double()).float()),
                xo.fma32(pa, pb, -xo.mul32(pa, pb)),
                xo.round_ftz(torch.tensor(edge, device=d)))

    with fpenv.flushed():
        want = helpers("cpu")
    got = helpers(dev)
    # a NaN stays a NaN; its payload is the device's
    helper_ok = [nan_same(g.cpu(), w) for g, w in zip(got, want)]
    # npc_mlp's .ftz ops against the CPU port's flushed plain version
    uobs, uws = mlp_underflow_case(4096, SEED, dev)
    with fpenv.flushed():
        cpu_plain = npc_mlp_plain(uobs.cpu(), *(w.cpu() for w in uws))
    mlp_ok = nan_same(npc_mlp(uobs, *uws).cpu(), cpu_plain) and nan_same(
        npc_mlp_plain(uobs, *uws).cpu(), cpu_plain)
    print(f"[17] the subnormal gate: the underflow case on the card (512 "
          f"rows, 4 ticks, the card restarted from the CPU port's state "
          f"each tick) differs from the CPU port's flushed tick in "
          f"{sum(words_by['mlp'].values())} words under mlp "
          f"{words_by['mlp'] or ''} and "
          f"{sum(words_by['random_walk'].values())} under the random walk"
          f" {words_by['random_walk'] or ''}; the flush helpers (ftz, "
          f"mul32, div32, fma32, round_ftz at the tininess edge) card == "
          f"CPU {helper_ok}; npc_mlp and its plain version on "
          f"mlp_underflow_case (4096 rows) == the CPU port's flushed plain"
          f" version: {mlp_ok} {tag}", flush=True)
    if any(words_by.values()) or not all(helper_ok) or not mlp_ok:
        fail("[17] the card does not flush subnormals as the CPU port "
             "does")
    return words_by


# ---------------------------------------------------------------- [21]

MESH_TICKS = 24          # (a) lockstep ticks and migration ticks
MESH_MIGRATIONS = 256    # (a) migration requests a tick, 32 a shard
MESH_FULL = SPACES - 1   # (a) the shard kept nearly full
MESH_FULL_FREE = 16      # (a) its free slots at the start
MEGA_GAME_SLOTS = 1 << 17   # (c) slots a tile: 2^20 in all
MEGA_GAME_SHAPE = (4, 2)
MEGA_GAME_MONSTERS = 1 << 16   # (c) cut from 2^17 with [25] (PERF.md §4)
MEGA_GAME_BOTS = 16
MEGA_GAME_GROUP = 4
MEGA_GAME_WALK_S = 3.0
MEGA_TWIN_N = 1 << 13    # (d) kernel/plain twins: 8 tiles of 2^13
MEGA_TWIN_TICKS = 8
CARD_CPU_N = 1024        # (d) card against the CPU port: 8 x 1024
CARD_CPU_SPARE = 256
CARD_CPU_TICKS = 4
MEGA_LAUNCHES = {"sweep_fused": SPACES, "counting_sort": SPACES,
                 "halo_ship_phase": 2, "npc_mlp": 0}


def mesh_requests(rng, n: int, tick: int, dev):
    """(target, tag) i32[SPACES, n] of one tick: 32 rows a shard asked
    to move to another shard, 8 of them into MESH_FULL; tags unique."""
    tgt = np.full((SPACES, n), -1, np.int32)
    tag = np.full((SPACES, n), -1, np.int32)
    per = MESH_MIGRATIONS // SPACES
    t = 0
    for d in range(SPACES):
        rows = rng.choice(n, per, replace=False)
        dst = (d + rng.integers(1, SPACES, per)) % SPACES
        if d != MESH_FULL:
            dst[:8] = MESH_FULL
        tgt[d, rows] = dst
        tag[d, rows] = np.arange(t, t + per) + tick * MESH_MIGRATIONS
        t += per
    return (torch.from_numpy(tgt).to(dev), torch.from_numpy(tag).to(dev))


def mesh_tick_part(dev, tag) -> tuple[dict, str]:
    """[21] (a): ``make_multi_tick`` at 8 x 2^17 ([15]'s worlds): with
    no migration requests in lockstep with the batched tick, every lane
    equal; with MESH_MIGRATIONS requests a tick, some into a shard kept
    nearly full, against its plain twin (ranges/argsort) in every lane
    and output; two ticks under the sync guard; p50/p99 by events."""
    cfg = multi_config(SPACES, SPACE_N)
    n = cfg.capacity
    st0, inputs = multi_world(cfg, SPACES, SEED, dev)
    mesh = make_mesh(SPACES, device=dev)
    mtick = make_multi_tick(cfg, mesh)
    btick = make_tick(cfg, device=dev)
    none = torch.full((SPACES, n), -1, dtype=torch.int32, device=dev)
    idle = MultiTickInputs(base=inputs, migrate_target=none,
                           migrate_tag=none)
    sm, sb = st0.apply(torch.clone), st0
    diffs = []
    kernels.reset_launches()
    for _ in range(MESH_TICKS):
        sm, om = mtick(sm, idle)
        sb, ob = btick(sb, inputs)
        la, lb = lanes(sm), lanes(sb)
        diffs += [diff_count(la[k], lb[k]) for k in la
                  if la[k] is not None or lb[k] is not None]
        oa, obb = lanes(om.base), lanes(ob)
        diffs += [diff_count(oa[k], obb[k]) for k in oa]
        diffs += [om.arr_n.sum(), om.migrate_dropped.sum(),
                  (om.global_alive != sm.alive.sum()).sum()]
    lock_launches = dict(kernels.LAUNCHES)
    bad = int(torch.stack(diffs).sum())
    if bad:
        fail(f"[21] make_multi_tick without requests differs from the "
             f"batched tick in {bad} words")
    if lock_launches != {"sweep_fused": 2 * MESH_TICKS,
                         "counting_sort": 2 * MESH_TICKS,
                         "halo_ship_phase": 0, "npc_mlp": 0}:
        fail(f"[21] lockstep launches {lock_launches}")
    del sm, sb, om, ob, la, lb, oa, obb, diffs

    # free rows: 1/8 of every shard's, MESH_FULL_FREE of MESH_FULL's
    rng = np.random.default_rng(SEED + 21)
    dead = np.zeros((SPACES, n), bool)
    for d in range(SPACES):
        k = MESH_FULL_FREE if d == MESH_FULL else n // 8
        dead[d, rng.choice(n, k, replace=False)] = True
    dead_t = torch.from_numpy(dead).to(dev)
    start = st0.replace(
        alive=st0.alive & ~dead_t, npc_moving=st0.npc_moving & ~dead_t,
        has_client=st0.has_client & ~dead_t,
        client_gate=torch.where(dead_t, -1, st0.client_gate))
    del st0
    reqs = [mesh_requests(rng, n, t, dev) for t in range(MESH_TICKS)]
    plain_cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, sweep_impl="ranges", sort_impl="argsort"))
    ptick = make_multi_tick(plain_cfg, mesh)
    # two ticks under the sync guard, from a copy of the start
    guard = start.apply(torch.clone)
    torch.cuda.set_sync_debug_mode("error")
    for t in range(2):
        guard, _ = mtick(guard, MultiTickInputs(inputs, *reqs[t]))
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del guard
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(MESH_TICKS)]
    sk, sp = start, start.apply(torch.clone)
    diffs, gauges = [], []
    for t, (a, b) in enumerate(ev):
        mi = MultiTickInputs(inputs, *reqs[t])
        kernels.reset_launches()
        a.record()
        sk, ok = mtick(sk, mi)
        b.record()
        got = dict(kernels.LAUNCHES)
        if got != {"sweep_fused": 1, "counting_sort": 1,
                   "halo_ship_phase": 0, "npc_mlp": 0}:
            fail(f"[21] make_multi_tick {t + 1} launched {got}")
        sp, op = ptick(sp, mi)
        la, lb = lanes(sk), lanes(sp)
        diffs += [diff_count(la[k], lb[k]) for k in la
                  if la[k] is not None or lb[k] is not None]
        oa, obb = lanes(ok), lanes(op)
        diffs += [diff_count(oa[k], obb[k]) for k in oa]
        gauges.append(torch.stack([
            ok.arr_n.sum(), ok.migrate_dropped.sum(),
            ok.migrate_demand.sum(), ok.global_alive[0],
            ok.base.enter_n.sum()]))
    torch.cuda.synchronize()
    bad = int(torch.stack(diffs).sum())
    if bad:
        fail(f"[21] make_multi_tick with migrations differs from its "
             f"plain twin in {bad} words")
    gv = torch.stack(gauges).cpu().numpy()
    alive0 = int((~dead).sum())
    if gv[:, 1].max() <= 0 or gv[:, 0].min() <= 0:
        fail(f"[21] migrations: arrivals a tick {gv[:, 0].tolist()}, "
             f"dropped {gv[:, 1].tolist()}")
    # every request either arrived or was dropped; the mesh keeps its
    # population less the dropped arrivals
    if int(gv[-1, 3]) != alive0 - int(gv[:, 1].sum()):
        fail(f"[21] global_alive {int(gv[-1, 3])} != {alive0} less "
             f"{int(gv[:, 1].sum())} dropped")
    ms = np.array([a.elapsed_time(b) for a, b in ev])[1:]
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    del sk, sp, ok, op, la, lb, oa, obb, diffs, reqs, start
    text = (f"(a) make_multi_tick at {SPACES} x {SPACE_N}: {MESH_TICKS} "
            f"ticks without requests == the batched tick in every lane "
            f"and output (launches {lock_launches} for both); "
            f"{MESH_TICKS} ticks of {MESH_MIGRATIONS} requests == the "
            f"plain twin (ranges/argsort) in every lane, arrivals a tick "
            f"{int(gv[:, 0].min())}-{int(gv[:, 0].max())}, dropped at the "
            f"nearly full shard {gv[:, 1].astype(int).tolist()}, "
            f"global_alive {alive0} -> {int(gv[-1, 3])}; 1 sweep + 1 sort "
            f"launch a tick; two ticks under the sync guard raised "
            f"nothing; ms/tick p50={p50:.3f} p99={p99:.3f} (ticks "
            f"2-{MESH_TICKS}, CUDA events)")
    return ({"mesh_lockstep": lock_launches,
             "mesh_migrations": {"sweep_fused": MESH_TICKS,
                                 "counting_sort": MESH_TICKS,
                                 "halo_ship_phase": 0, "npc_mlp": 0}},
            text)


def mesh_world_part(dev, tag) -> tuple[dict, str]:
    """[21] (b): [15]'s World of SPACES Spaces built on a mesh of SPACES
    (``make_mesh``): the game's traffic and SERVE_MIGRATIONS moves a
    tick riding the step's exchange, every move arrived and each moved
    entity's (shard, slot) an alive row of its type on the card."""
    served = serve_world(SPACE_WORLD_N, SEED, dev, boot=True,
                         world_kw=PLANES, spaces=SPACES, mesh=True)
    w = served.world
    n_pop = len(w.entities) - SPACES - 1
    checked = [0]

    def moves_on_card():
        moved = [(w.entities[eid], dst) for eid, dst in served.migrating
                 if eid in w.entities]
        if not moved:
            return
        sh = torch.tensor([e.shard for e, _ in moved], device=dev)
        sl = torch.tensor([e.slot for e, _ in moved], device=dev)
        alive, tid = w._dget([w.state.alive[sh, sl],
                              w.state.type_id[sh, sl]])
        for (e, dst), a, ti in zip(moved, alive, tid):
            if e.shard != dst or not a or ti != e._type_desc.type_id \
                    or w._slot_owner[e.shard].get(e.slot) != e.id:
                fail(f"[21] moved entity {e.id} at ({e.shard}, {e.slot}) "
                     f"wanted shard {dst}: row alive {bool(a)}, type {ti}")
        checked[0] += len(moved)

    rows, launches = world_ticks(served, WORLD_TICKS, teleport=False,
                                 after=moves_on_card)
    staged = sum(r["staged"]["migrations"] for r in rows)
    applied = sum(r["migrated"] for r in rows)
    planes = (f"lanes hold {sum(w._telem_lanes['rebuilt']['counts'])} "
              f"ticks, signature {w.workload_signature()['sig']}, audit "
              f"skips {audit_state(w)['oracle']['skipped']}")
    text = (f"(b) World of {SPACES} Spaces x {SPACE_WORLD_N} on a mesh of "
            f"{SPACES}: {n_pop} entities booted in {served.boot_ticks} "
            f"ticks; {WORLD_TICKS} World.ticks, launches {launches}; "
            f"moves riding the step's exchange: {applied} of {staged} "
            f"arrived, {checked[0]} rows checked on the card (alive, "
            f"type, owner); {world_summary(rows, w.cfg)}; planes: "
            f"{planes}")
    del served, w
    release_worlds()
    return {"mesh_world": launches}, text


class GameMegaArena(gw.Space):
    pass


def mega_boot(world, pop: int, extent: float, seed: int,
              log: dict, launches: dict | None = None,
              label: str = "[21]") -> None:
    """(c)'s boot (``on_boot``): the megaspace Arena, then ``pop`` btree
    Monsters uniform over the world, entered in batches whose enter
    events stay within half of a tile's ``enter_cap`` spread over the
    tiles, each boot tick's caps checked on every tile."""
    t0 = time.perf_counter()
    world.arena = world.create_space("Arena")
    world.said = []
    cfg, g = world.cfg, world.cfg.grid
    tiles = world.n_spaces
    rng = np.random.default_rng(seed)
    pos = np.zeros((pop, 3))
    pos[:, 0] = rng.uniform(0, extent, pop)
    pos[:, 2] = rng.uniform(0, extent, pop)
    nb = pop * (2.0 * g.radius) ** 2 / (extent * extent)
    budget = cfg.enter_cap / 4.0 * tiles
    done = ticks = events = 0
    while done < pop:
        hi = min(pop, done + max(1, int(
            -done + np.sqrt(done ** 2 + budget * pop / nb))))
        for i in range(done, hi):
            world.arena.create_entity("Monster", pos=tuple(pos[i]),
                                      moving=True, attrs={"hp": 100})
        done = hi
        before = dict(kernels.LAUNCHES)
        world.tick()
        check_game_launches(before, f"boot tick {ticks + 1}",
                            launches or MEGA_LAUNCHES, label)
        out = world.last_outputs
        for lane, cap in (("enter_n", cfg.enter_cap),
                          ("leave_n", cfg.leave_cap),
                          ("delta_rows_n", cfg.delta_rows_cap_eff)):
            if int(getattr(out.base, lane).max()) > cap:
                fail(f"{label} boot tick {ticks + 1}: {lane} > {cap}")
        ticks += 1
        events += int(out.base.enter_n.sum())
    log.update(seconds=time.perf_counter() - t0, ticks=ticks,
               events=events, monsters=pop)


def corner_spots(mc_shape, tile_w: float, tile_d: float) -> list:
    """(c)'s bots: MEGA_GAME_GROUP bots a group, 3 units off a point
    where tiles meet on both axes (the 4 x 2 grid's three inner corners,
    then a point of the middle x border), each heading across it."""
    tx, tz = mc_shape
    points = [(i * tile_w, j * tile_d) for j in range(1, tz)
              for i in range(1, tx)]
    points.append((tile_w * (tx // 2), tile_d / 2))
    groups = MEGA_GAME_BOTS // MEGA_GAME_GROUP
    spots = []
    for x, z in points[:groups]:
        for sx, sz in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            spots.append((x + 3.0 * sx, z + 3.0 * sz, -sx, -sz))
    return spots


async def bots_cross(bots, spots, seconds: float, step: float) -> None:
    """Every bot walks straight across the border its spot faces, one
    ``step`` each 0.1 s with a position sync, for ``seconds``."""
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for b, (_, _, dx, dz) in zip(bots, spots):
            x, y, z = b.player.pos
            x, z = x + step * dx, z + step * dz
            b.player.pos = (x, y, z)
            b.send_position(x, y, z, 0.0)
        await asyncio.sleep(0.1)


def mega_game_part(dev, tag) -> tuple[dict, str]:
    """[21] (c): the megaspace World through ``gw.run()`` (see the
    module docstring). Returns the launches of its game ticks."""
    from goworld_tpu_torch import api
    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.net.botclient import BotClient
    from goworld_tpu_torch.net.game import GameServer
    from goworld_tpu_torch.net.standalone import ClusterHarness

    api._reset_for_tests()
    api._boot_callbacks.clear()
    kernels.reset_launches()
    tx, tz = MEGA_GAME_SHAPE
    mc = mega_config(SPACES * MEGA_GAME_SLOTS, SPACES)
    extent = float(int((SPACES * MEGA_GAME_SLOTS * 10000 / 12) ** 0.5))
    tile_w, tile_d = extent / tx, extent / tz
    harness = ClusterHarness(n_dispatchers=2, n_gates=1, desired_games=1,
                             position_sync_interval_ms=50)
    harness.start()
    home = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="mega_game_")
    rt = None
    try:
        os.chdir(tmp)
        disp = "".join(f"[dispatcher{i + 1}]\nhost = {h}\nport = {p}\n\n"
                       for i, (h, p) in enumerate(harness.dispatcher_addrs))
        with open("goworld_tpu.ini", "w") as f:
            f.write(
                f"{disp}[game_common]\nboot_entity = Account\n"
                f"capacity = {MEGA_GAME_SLOTS}\nmesh_devices = {SPACES}\n"
                f"megaspace = true\nmega_shape = {tx}x{tz}\n"
                f"extent_x = {extent}\nextent_z = {extent}\n"
                f"aoi_radius = {mc.cfg.grid.radius}\nbehavior = btree\n"
                f"aoi_k = {mc.cfg.grid.k}\n"
                f"aoi_cell_cap = {mc.cfg.grid.cell_cap}\n"
                "aoi_sweep_impl = fused\naoi_sort_impl = pallas\n"
                f"halo_impl = async\nhalo_cap = {mc.halo_cap}\n"
                f"migrate_cap = {mc.migrate_cap}\n"
                "position_sync_interval_ms = 50\n\n[game1]\n\n[gate1]\n"
                f"host = {harness.gate_addrs[0][0]}\n"
                f"port = {harness.gate_addrs[0][1]}\n\n"
                "[storage]\nkind = filesystem\ndirectory = entity_storage\n"
                "\n[kvdb]\nkind = filesystem\npath = kvdb_data\n")
        gw.register_entity("Account", GameAccount)
        gw.register_entity("Avatar", GameAvatar)
        gw.register_entity("Monster", GameMonster)
        gw.register_space("Arena", GameMegaArena, megaspace=True)
        boot = {}
        gw.on_boot(lambda w: mega_boot(w, MEGA_GAME_MONSTERS, extent, SEED,
                                       boot))
        rt = gw.run(["-gid", "1", "-configfile", "goworld_tpu.ini"],
                    block=False, device=dev.type)
        server, world = rt.server, rt.world
        m = world.mega
        if world.device.type != dev.type or m is None or \
                m.shape != MEGA_GAME_SHAPE or m.halo_impl != "async" or \
                world.cfg.grid.sweep_impl != "fused" or \
                world.cfg.behavior != "btree":
            fail(f"[21] gw.run built {world.device} mega {m}")
        if "seconds" not in boot:
            fail("[21] the on_boot callback failed (logged above)")
        gc.collect()
        gc.freeze()
        tl = metrics.timeline
        rows, crossings = [], {}

        def game_tick(timed: bool) -> None:
            before = dict(kernels.LAUNCHES)
            tl.begin_tick()
            t0 = time.perf_counter()
            with tl.span("drain_inputs"):
                server.pump()
            server.tick()
            wall = time.perf_counter() - t0
            tl.end_tick()
            check_game_launches(before, f"game tick {len(rows) + 1}",
                                MEGA_LAUNCHES, "[21]")
            out = world.last_outputs
            if int(out.migrate_dropped.sum()) or \
                    int(out.halo_demand.max()) > m.halo_cap:
                fail(f"[21] game tick {len(rows) + 1}: dropped "
                     f"{out.migrate_dropped.tolist()}, halo demand "
                     f"{out.halo_demand.tolist()}")
            for eid, shard in crossings.items():
                e = world.entities.get(eid)
                if e is None or e.id != eid or e.slot is None:
                    fail(f"[21] Avatar {eid} lost its row or its id")
                if e.shard != shard[-1]:
                    shard.append(e.shard)
            rows.append((timed, wall, {name: d for name, _, d, _ in
                                       tl.records()[-1][2]}))

        def tick_until(fut, timed: bool, limit: float = 300.0):
            t_end = time.perf_counter() + limit
            while not fut.done():
                if time.perf_counter() > t_end:
                    fail(f"[21] the bots did not finish within "
                         f"{limit:.0f} s")
                game_tick(timed)
            return fut.result(timeout=1)

        bots = [BotClient(*harness.gate_addrs[0], bot_id=i, strict=True,
                          seed=SEED + i) for i in range(MEGA_GAME_BOTS)]
        spots = corner_spots(MEGA_GAME_SHAPE, tile_w, tile_d)
        login_s = tick_until(harness.submit(bots_login(
            bots, [(x, z) for x, z, _, _ in spots])), False)
        avatars = {b.player.eid: b for b in bots if b.player is not None
                   and b.player.type_name == "Avatar"}
        if len(avatars) != MEGA_GAME_BOTS:
            fail(f"[21] {len(avatars)} of {MEGA_GAME_BOTS} logins reached "
                 "an Avatar")
        for eid in avatars:
            crossings[eid] = [world.entities[eid].shard]
        t_win = time.perf_counter()
        tick_until(harness.submit(bots_cross(bots, spots, MEGA_GAME_WALK_S,
                                             0.5)), True)
        win_s = time.perf_counter() - t_win
        for _ in range(2):
            game_tick(False)
        time.sleep(1.0)
        errors = [e for b in bots for e in b.errors]
        if errors:
            fail(f"[21] strict mirrors report {len(errors)} errors: "
                 f"{errors[:4]}")
        hops = {eid: len(s) - 1 for eid, s in crossings.items()}
        if min(hops.values()) < 1:
            fail(f"[21] Avatars that crossed no border: "
                 f"{[e for e, h in hops.items() if h < 1]}")
        ents = world.entities
        mism = [(b.bot_id, len(set(b.entities) ^ {eid, *ents[eid]
                                                  .interested_in}))
                for eid, b in avatars.items()
                if set(b.entities) != {eid, *ents[eid].interested_in}]
        if mism:
            fail(f"[21] bot mirrors differ from the server's interest "
                 f"sets: (bot, words) {mism[:8]}")
        # the Avatars' interest sets against a brute-force oracle over
        # the fetched positions (the last tick's, which its sweep read)
        pos, alive = world._dget([world.state.pos, world.state.alive])
        owner = world._slot_owner
        live = [(sh, sl, eid) for sh in range(world.n_spaces)
                for sl, eid in owner[sh].items() if alive[sh, sl]]
        xz = np.array([pos[sh, sl][[0, 2]] for sh, sl, _ in live])
        ids_ = [eid for _, _, eid in live]
        r, k = world.cfg.grid.radius, world.cfg.grid.k
        over_k = 0
        for eid in avatars:
            e = ents[eid]
            p = pos[e.shard, e.slot][[0, 2]]
            near = np.flatnonzero(np.abs(xz - p).max(1) <= r)
            want = {ids_[i] for i in near} - {eid}
            if len(want) > k:
                over_k += 1   # nearest-k by design past k
                continue
            if e.interested_in != want:
                fail(f"[21] Avatar {eid}: {len(e.interested_in)} in its "
                     f"interest set, the oracle {len(want)}, "
                     f"{len(e.interested_in ^ want)} differ")
        tick_until(harness.submit(bots_leave(bots)), False)
        for _ in range(200):
            if all(ents[e].client is None for e in avatars):
                break
            game_tick(False)
        server.request_freeze()
        for _ in range(2000):
            if server.run_state == "freezing":
                server._do_freeze()
                break
            game_tick(False)
        path = os.path.join(tmp, freeze_mod.freeze_filename(1))
        if server.run_state != "frozen" or not os.path.isfile(path):
            fail(f"[21] freeze: run state {server.run_state}, file "
                 f"{os.path.isfile(path)}")
        frozen = {e.id: (e.type_name, e.attrs.to_dict(), e.position,
                         e.yaw) for e in ents.values()
                  if not e.destroyed and e.slot is not None}
        t0 = time.perf_counter()
        w2 = api._build_world(api.config_mod.load("goworld_tpu.ini")
                              .games[1], 1, dev.type)
        api._apply_registrations(w2)
        gs2 = GameServer(1, w2, [], restore=True, freeze_dir=tmp)
        restore_s = time.perf_counter() - t0
        back = {e.id: (e.type_name, e.attrs.to_dict(), e.position, e.yaw)
                for e in w2.entities.values()
                if not e.destroyed and e.slot is not None}
        if back != frozen or w2.mega is None:
            diff = [kk for kk in frozen if back.get(kk) != frozen[kk]]
            fail(f"[21] the restored megaspace World differs from the "
                 f"frozen one in {len(diff) + len(set(back) - set(frozen))}"
                 f" entities")
        before = dict(kernels.LAUNCHES)
        gs2.tick()
        check_game_launches(before, "the restored World's first tick",
                            MEGA_LAUNCHES, "[21]")
        launches = dict(kernels.LAUNCHES)
        win = [wl for t, wl, _ in rows if t]
        wall = np.array(win) * 1e3
        spans = {kk: float(np.mean([sp.get(kk, 0.0) for t, _, sp in rows
                                    if t])) * 1e3 for kk in rows[-1][2]}
        text = (f"(c) the megaspace World through gw.run() (ini: "
                f"{SPACES} tiles {tx}x{tz} of {MEGA_GAME_SLOTS} slots, "
                f"world {extent:.0f}^2, radius {r}, btree, fused/pallas, "
                f"halo async, halo_cap {m.halo_cap}; 2 dispatchers, 1 gate)"
                f": boot of {boot['monsters']} Monsters in "
                f"{boot['seconds']:.2f} s over {boot['ticks']} ticks "
                f"({boot['events']} enter events); {MEGA_GAME_BOTS} logins "
                f"in {login_s:.2f} s; window {win_s:.2f} s: {len(win)} "
                f"game ticks p50 {np.percentile(wall, 50):.3f} p99 "
                f"{np.percentile(wall, 99):.3f} ms, mean span ms "
                + ", ".join(f"{kk} {v:.3f}" for kk, v in spans.items())
                + f"; {len(rows)} game ticks, each {MEGA_LAUNCHES} "
                f"(launches {launches}); border crossings an Avatar "
                f"{sorted(hops.values())}, every EntityID kept, 0 dropped;"
                f" strict mirrors 0 errors, == interest sets; oracle == "
                f"interest sets for {MEGA_GAME_BOTS - over_k} Avatars "
                f"({over_k} past k); frozen to {os.path.getsize(path)} B, "
                f"restored {len(back)} entities in {restore_s:.2f} s, "
                f"equal, first tick ran")
        del w2, gs2
        return {"mega_game": launches}, text
    finally:
        os.chdir(home)
        if rt is not None:
            rt.server.stop()
            rt.storage.shutdown()
            rt.workers.wait_clear()
        harness.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        api._reset_for_tests()
        api._boot_callbacks.clear()
        release_worlds()


def twin_diff(a, b, t: int, what: str) -> None:
    """Fail where two served Worlds differ after their tick ``t``:
    sinks, hooks, state, telemetry lanes and signatures, audit stats and
    ledgers."""
    ka, kb = a.sink.take()["kept"], b.sink.take()["kept"]
    if len(ka) != len(kb) or any(
            x[0] != y[0] or x[1] != y[1] or not (
                all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
                    for u, v in zip(x[2:], y[2:])) if x[0] == "sync"
                else x[2:] == y[2:]) for x, y in zip(ka, kb)):
        fail(f"[21] {what}: sinks differ at tick {t + 1}")
    if a.hooks != b.hooks:
        fail(f"[21] {what}: hooks differ at tick {t + 1}")
    a.hooks.clear()
    b.hooks.clear()
    sa = interop.state_to_numpy(a.world.state)
    sb = interop.state_to_numpy(b.world.state)
    bad = [k for k in sa if sa[k].tobytes() != sb[k].tobytes()]
    if bad:
        fail(f"[21] {what}: state lanes {bad} differ at tick {t + 1}")
    wa, wb = a.world, b.world
    if wa._telem_lanes != wb._telem_lanes or any(
            unkeyed(getattr(wa, sig)()) != unkeyed(getattr(wb, sig)())
            for sig in ("workload_signature", "window_signature")):
        fail(f"[21] {what}: telemetry lanes or signatures differ at tick "
             f"{t + 1}")
    if audit_state(wa) != audit_state(wb) or \
            wa.audit.ledger.snapshot(tick=t) != \
            wb.audit.ledger.snapshot(tick=t):
        fail(f"[21] {what}: audit stats or ledgers differ at tick {t + 1}")
    return len(ka)


def twins_part(dev, tag) -> tuple[dict, str]:
    """[21] (d): megaspace twins of 8 x MEGA_TWIN_N, kernels (fused,
    pallas, async) against plain versions (ranges, argsort, ppermute),
    MEGA_TWIN_TICKS ticks; then a megaspace World and a World on a mesh
    of 8 x CARD_CPU_N on the card and on the CPU port, CARD_CPU_TICKS
    ticks, every lane equal."""
    kw = dict(record_hooks=True, keep=True, boot=True, world_kw=PLANES,
              mega_shape=MEGA_GAME_SHAPE)
    kern = serve_world(MEGA_TWIN_N, SEED + 2, dev, halo_impl="async", **kw)
    plain = serve_world(MEGA_TWIN_N, SEED + 2, dev, halo_impl="ppermute",
                        sweep_impl="ranges", sort_impl="argsort", **kw)
    records = 0
    twin_launches = {"kernels": [], "plain": []}
    for t in range(MEGA_TWIN_TICKS):
        for name, sv in (("kernels", kern), ("plain", plain)):
            sv.stage(teleport=t % 2 == 1)
            kernels.reset_launches()
            sv.world.tick()
            twin_launches[name].append(dict(kernels.LAUNCHES))
        records += twin_diff(kern, plain, t, "megaspace twins")
    if twin_launches != {
            "kernels": [MEGA_LAUNCHES] * MEGA_TWIN_TICKS,
            "plain": [dict.fromkeys(MEGA_LAUNCHES, 0)] * MEGA_TWIN_TICKS}:
        fail(f"[21] megaspace twins' launches {twin_launches}")
    n_pop = len(kern.world.entities) - 2
    del kern, plain
    release_worlds()
    # the card against the CPU port, megaspace and mesh
    compared = []
    for shape in ("mega", "mesh"):
        kw = dict(keep=True, boot=True, world_kw=PLANES,
                  spare=CARD_CPU_SPARE)
        if shape == "mega":
            kw.update(mega_shape=MEGA_GAME_SHAPE)
        else:
            kw.update(spaces=SPACES, mesh=True)
        card = serve_world(CARD_CPU_N, SEED + 3, dev, **kw)
        cpu = serve_world(CARD_CPU_N, SEED + 3, "cpu", **kw)
        for t in range(CARD_CPU_TICKS):
            for sv in (card, cpu):
                sv.stage()
                sv.world.tick()
            sa = interop.state_to_numpy(card.world.state)
            sb = interop.state_to_numpy(cpu.world.state)
            bad = [k for k in sa if sa[k].tobytes() != sb[k].tobytes()]
            oa, ob = (lanes(sv.world.last_outputs) for sv in (card, cpu))
            bad += [f"outputs {k}" for k in oa if (oa[k] is None) != (
                ob[k] is None) or oa[k] is not None
                and np.asarray(oa[k]).tobytes()
                != np.asarray(ob[k]).tobytes()]
            if bad:
                fail(f"[21] {shape} World of {SPACES} x {CARD_CPU_N}: the "
                     f"card != the CPU port in lanes {bad} at tick "
                     f"{t + 1}")
        compared.append(f"{shape} {len(card.world.entities)} entities")
        del card, cpu
        release_worlds()
    text = (f"(d) megaspace twins of {SPACES} x {MEGA_TWIN_N} ({n_pop} "
            f"entities; kernels fused/pallas/async, launches a tick "
            f"{MEGA_LAUNCHES}; plain ranges/argsort/ppermute, none) equal "
            f"in sinks ({records} records), hooks, state, telemetry lanes,"
            f" signatures, audit stats and ledgers for {MEGA_TWIN_TICKS} "
            f"ticks, walking and stress syncs in turns; {SPACES} x "
            f"{CARD_CPU_N} on the card == the CPU port in every lane, "
            f"floats included, {CARD_CPU_TICKS} ticks ({', '.join(compared)})")
    return {"mega_twins": {k: MEGA_TWIN_TICKS * v
                           for k, v in MEGA_LAUNCHES.items()}}, text


def mesh_phase(dev, tag) -> dict:
    """[21] the World on a mesh and the megaspace World on the card:
    (a) ``make_multi_tick``, (b) the World on a mesh, (c) the megaspace
    World through ``gw.run()``, (d) twins. Returns launches by path."""
    phase0 = time.perf_counter()
    launches = {}
    for part in (mesh_tick_part, mesh_world_part, mega_game_part,
                 twins_part):
        t0 = time.perf_counter()
        got, text = part(dev, tag)
        launches.update(got)
        print(f"[21] {text}; {time.perf_counter() - t0:.1f} s {tag}",
              flush=True)
    print(f"[21] phase {time.perf_counter() - phase0:.1f} s {tag}",
          flush=True)
    return launches


# ---------------------------------------------------------------- [22]
# the deployment through the port's ops CLI: [19]'s game and ini served
# by `python -m goworld_tpu_torch start`, with bots on every client edge
DEPLOY_EDGES = {"tcp": 32, "ws": 16, "kcp": 16}   # strict bots an edge
DEPLOY_CLI_S = 600.0      # the limit of one CLI call
DEPLOY_HTTP_S = 60.0      # the limit of one debug-HTTP read
KERNEL_NAMES = {"sweep_fused": ("sweep_fused_kernel",),
                "counting_sort": ("radix_hist", "radix_scatter")}

# [22]'s game script: [19]'s types and boot, served by gw.run() (the
# World on the card). Its serve loop's tick publishes, on the debug
# HTTP's /vars, the tick count, the kernel launch counts, the enter
# events so far and the poses still staged (a restore stages every
# entity's pose, input_cap a tick), taken at one point of the logic
# thread, the boot's
# log, the bots' spots (the
# densest cells, as [19]) and the says; while a PAUSE file exists in
# its directory it does not tick and publishes every bot Avatar's
# interest set, so that the checker reads a World at rest, as [19]
# reads its World between ticks.
DEPLOY_GAME = '''"""chip_smoke.py [22]'s game: [19]'s, served by the port's CLI."""
import os

import goworld_tpu_torch as gw
import chip_smoke as cs
from goworld_tpu_torch import kernels
from goworld_tpu_torch.net.game import GameServer
from goworld_tpu_torch.utils import opmon

BOOT = {{}}
ENTERS = [0]
gw.register_entity("Account", cs.GameAccount)
gw.register_entity("Avatar", cs.GameAvatar)
gw.register_entity("Monster", cs.GameMonster)
gw.register_space("Arena", cs.GameArena)
gw.on_boot(lambda w: cs.boot_monsters(w, {monsters}, cs.SEED, BOOT))
_tick = GameServer.tick
_spots = []


def interest(w):
    ents, out = w.entities, {{}}
    for e in list(ents.values()):
        if e.type_name == "Avatar" and not e.destroyed \\
                and e.client is not None:
            want = sorted({{e.id, *e.interested_in}})
            out[e.id] = [want, sum(1 for x in want if x in ents
                                   and ents[x].type_name == "Monster")]
    return out


def tick(self):
    w = self.world
    if not hasattr(w, "arena"):   # a restored World: find its Arena
        w.arena = next(s for s in w.spaces.values()
                       if s.type_name == "Arena")
        w.said = []
    if not _spots:
        _spots.extend(cs.game_spots(w, {groups}, cs.GAME_GROUP, cs.SEED))
    if os.path.exists("PAUSE"):
        v = opmon.vars().get("smoke", {{}})
        if "interest" not in v:
            opmon.expose("smoke", dict(v, interest=interest(w)))
        return
    _tick(self)
    ENTERS[0] += int(w.last_outputs.enter_n.sum())
    opmon.expose("smoke", {{
        "tick": w.tick_count, "launches": dict(kernels.LAUNCHES),
        "enters": ENTERS[0], "staged": len(w._staged_pos),
        "boot": BOOT, "spots": _spots, "said": list(w.said)}})


GameServer.tick = tick
gw.run({run_args})
'''


def deploy_ini(slots: int, ports: dict) -> str:
    """[19]'s ini on fixed free ports: 2 dispatchers, the game, a gate
    with TCP, WebSocket and KCP listeners compressing with snappy, a
    debug HTTP port on every process. The overload plane is off: a 2^20
    World ticks slower than the 60 Hz target, and the plane would shed
    the bots' syncs and refuse their logins."""
    grid = slice_config(slots).grid
    ext = grid.extent_x
    disp = "".join(
        f"[dispatcher{i}]\nhost = 127.0.0.1\nport = {ports[f'd{i}']}\n"
        f"http_port = {ports[f'hd{i}']}\n\n" for i in (1, 2))
    return (f"{disp}[game_common]\nboot_entity = Account\n"
            f"capacity = {slots}\nn_spaces = 1\naoi_radius = 50.0\n"
            f"extent_x = {ext}\nextent_z = {ext}\naoi_k = {grid.k}\n"
            f"aoi_cell_cap = {grid.cell_cap}\naoi_sweep_impl = fused\n"
            "aoi_sort_impl = pallas\nposition_sync_interval_ms = 50\n"
            f"overload = false\nhttp_port = {ports['hg']}\n\n[game1]\n\n"
            f"[gate1]\nhost = 127.0.0.1\nport = {ports['tcp']}\n"
            f"ws_port = {ports['ws']}\nkcp_port = {ports['kcp']}\n"
            "compress = true\ncompress_codec = snappy\n"
            f"http_port = {ports['ht']}\n\n[storage]\nkind = filesystem\n"
            "directory = entity_storage\n\n[kvdb]\nkind = filesystem\n"
            "path = kvdb_data\n")


def free_ports(names) -> dict:
    import socket

    socks, out = [], {}
    for name in names:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        out[name] = s.getsockname()[1]
    for s in socks:
        s.close()
    return out


def start_cli(args: list) -> subprocess.Popen:
    """Start ``python -m goworld_tpu_torch *args`` from the repo's root,
    the root on ``PYTHONPATH``; its output merged into one pipe."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "goworld_tpu_torch", *args], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def run_cli(args: list) -> tuple[int, str, float]:
    """One CLI call: (exit code, output, seconds)."""
    t0 = time.perf_counter()
    proc = start_cli(args)
    out, _ = proc.communicate(timeout=DEPLOY_CLI_S)
    return proc.returncode, out, time.perf_counter() - t0


def cli_step(server_dir: str, pids: set, label: str, args: list,
             want_rc: int, what: str) -> tuple[str, float]:
    """One CLI command on ``server_dir`` (output, seconds); the pids of
    its processes added to ``pids``; it fails, with every process's log,
    unless the command exits ``want_rc``."""
    rc, out, secs = run_cli([args[0], server_dir, *args[1:]])
    rd = os.path.join(server_dir, "run")
    names = sorted(os.listdir(rd)) if os.path.isdir(rd) else []
    for name in names:
        if name.endswith(".pid"):
            with open(os.path.join(rd, name)) as f:
                pids.add(int(f.read().strip()))
    if rc != want_rc:
        logs = ""
        for name in names:
            if name.endswith(".log"):
                with open(os.path.join(rd, name), errors="replace") as f:
                    logs += f"== {name}\n{f.read()[-3000:]}\n"
        fail(f"{label} {what} exited {rc}, not {want_rc}:\n{out[-3000:]}"
             f"\n{logs}")
    return out, secs


def http_get(port: int, path: str, timeout: float = DEPLOY_HTTP_S):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        body = r.read().decode()
    return json.loads(body) if path != "/metrics" else body


def smoke_vars(port: int, want=None, label: str = "[22]") -> dict:
    """The game's published ``smoke`` var; polled until ``want(var)``
    holds (every poll bounded)."""
    t_end = time.perf_counter() + DEPLOY_CLI_S
    while True:
        try:
            v = http_get(port, "/vars").get("smoke") or {}
        except OSError as e:   # the game's debug HTTP not serving yet
            if time.perf_counter() > t_end:
                fail(f"{label} the game's debug HTTP: {e}")
            time.sleep(0.2)
            continue
        if want is None or want(v):
            return v
        if time.perf_counter() > t_end:
            fail(f"{label} the game never published what was awaited: "
                 f"{sorted(v)}")
        time.sleep(0.05)


def tick_hist(port: int) -> dict:
    """The game's ``tick_latency_ms`` histogram: {le: cumulative}."""
    series = metrics.parse_prometheus_text(http_get(port, "/metrics"))
    out = {}
    for k, v in series.items():
        if k.startswith("tick_latency_ms_bucket{"):
            le = k.split('le="', 1)[1].split('"', 1)[0]
            out[float("inf") if le == "+Inf" else float(le)] = v
    return out


def hist_quantiles(a: dict, b: dict, qs=(0.5, 0.99)) -> tuple:
    """Quantiles of the ticks between two reads of the histogram, by
    linear interpolation inside the bucket (Prometheus'
    ``histogram_quantile``); (n ticks, *quantiles in ms)."""
    les = sorted(b)
    cum = [b[le] - a.get(le, 0.0) for le in les]
    n = cum[-1]
    out = [n]
    for q in qs:
        rank, prev_le, prev = q * n, 0.0, 0.0
        for le, c in zip(les, cum):
            if c >= rank:
                hi = les[-2] if le == float("inf") else le
                out.append(prev_le + (hi - prev_le) * (
                    (rank - prev) / (c - prev) if c > prev else 1.0))
                break
            prev_le, prev = le, c
    return tuple(out)


async def deploy_round(ports: dict, spots: list, hport: int,
                       first_id: int, marks: dict) -> dict:
    """[19]'s pattern over the three edges: every bot logs in at its
    spot (per-bot seconds from connect to Avatar), walks with position
    syncs, says a line; the game's tick histogram and published counts
    are read into ``marks`` ("h1", "v1"); the game rests (PAUSE) while
    every mirror is read against its Avatar's interest set; then the
    bots leave."""
    from goworld_tpu_torch.net.botclient import BotClient

    loop = asyncio.get_running_loop()
    bots, edge_of = [], {}
    i = first_id
    for edge, n in DEPLOY_EDGES.items():
        kw = dict(ws=True) if edge == "ws" else dict(
            kcp=edge == "kcp", compress=True, compress_codec="snappy")
        for _ in range(n):
            b = BotClient("127.0.0.1", ports[edge], bot_id=i, strict=True,
                          speed=1.0, move_interval=0.1, seed=SEED + i, **kw)
            bots.append(b)
            edge_of[i] = edge
            i += 1
    t0 = time.perf_counter()
    await asyncio.gather(*(b.connect() for b in bots))
    for b in bots:
        b._recv_task = asyncio.ensure_future(b._recv_loop())
    await asyncio.wait_for(asyncio.gather(
        *(b.player_ready.wait() for b in bots)), DEPLOY_CLI_S)
    for b, (x, z) in zip(bots, spots):
        b.call_server("Login_Client", f"bot{b.bot_id}", x, z)
    login = {}
    t_end = time.perf_counter() + DEPLOY_CLI_S
    while len(login) < len(bots) and time.perf_counter() < t_end:
        for b in bots:
            if b.bot_id not in login and b.player is not None \
                    and b.player.type_name == "Avatar":
                login[b.bot_id] = time.perf_counter() - t0
        await asyncio.sleep(0.01)
    if len(login) != len(bots):
        fail(f"[22] {len(login)} of {len(bots)} logins reached an Avatar")
    t_win = time.perf_counter()
    await bots_walk(bots, GAME_WALK_S)
    for b in bots:
        b.call_server("Say_Client", f"hello from bot{b.bot_id}")
    by_eid = {b.player.eid: b for b in bots}
    said = []
    for _ in range(int(DEPLOY_CLI_S / 0.1)):
        said = (await loop.run_in_executor(
            None, smoke_vars, hport)).get("said", [])
        if len(said) == len(bots) and all(
                any(m == "OnSay" and a == [sp, text]
                    for _, m, a in by_eid[w].rpc_log)
                for sp, text, seen in said for w in [sp, *seen]
                if w in by_eid):
            break
        await asyncio.sleep(0.1)
    win_s = time.perf_counter() - t_win
    marks["h1"] = await loop.run_in_executor(None, tick_hist, hport)
    marks["v1"] = await loop.run_in_executor(None, smoke_vars, hport)
    # the World at rest, the gate's last flushes delivered
    rest = os.path.join(ports["dir"], "PAUSE")
    open(rest, "w").close()
    try:
        v = await loop.run_in_executor(
            None, smoke_vars, hport, lambda v: "interest" in v)
        await asyncio.sleep(1.0)
    finally:
        os.unlink(rest)
    errors = [e for b in bots for e in b.errors]
    if errors:
        fail(f"[22] strict mirrors report {len(errors)} errors: "
             f"{errors[:4]}")
    interest = v["interest"]
    mism, mons = [], []
    for eid, b in by_eid.items():
        if eid not in interest:
            fail(f"[22] bot{b.bot_id}'s Avatar {eid} holds no client")
        want, n_mon = interest[eid]
        if set(b.entities) != set(want):
            mism.append((b.bot_id, len(set(b.entities) ^ set(want))))
        mons.append(n_mon)
    if mism:
        fail(f"[22] bot mirrors differ from the server's interest sets: "
             f"(bot, words) {mism[:8]}")
    if min(mons) < 1:
        fail(f"[22] a bot has no Monster in its AOI: {mons}")
    if len(said) != len(bots):
        fail(f"[22] {len(said)} of {len(bots)} says reached the server")
    deliveries = 0
    for sp, text, seen in said:
        for w in [sp, *seen]:
            if w in by_eid and not any(
                    m == "OnSay" and a == [sp, text]
                    for _, m, a in by_eid[w].rpc_log):
                fail(f"[22] OnSay of {sp} did not reach {w}")
            deliveries += w in by_eid
    await bots_leave(bots)
    p50 = {e: float(np.percentile([t for i2, t in login.items()
                                   if edge_of[i2] == e], 50))
           for e in DEPLOY_EDGES}
    return dict(login_p50=p50, win_s=win_s, mons=mons,
                deliveries=deliveries, says=len(said))


def trace_kernels(path: str) -> tuple[dict, dict]:
    """Launches of the sweep and sort kernels in a torch.profiler
    Chrome trace (its kernel events by name; the sweep's is a template,
    so its name reads ``void sweep_fused_kernel<...>(...)``), and the
    trace's event counts by category."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {k: 0 for k in KERNEL_NAMES}
    cats: dict = {}
    for e in events:
        cat = e.get("cat", "")
        cats[cat] = cats.get(cat, 0) + 1
        if cat != "kernel":
            continue
        name = e.get("name", "")
        for k, names in KERNEL_NAMES.items():
            if any(n + "(" in name or n + "<" in name for n in names):
                out[k] += 1
    return out, cats


def deployment_phase(dev, tag: str, slots: int = GAME_SLOTS,
                     monsters: int = GAME_MONSTERS) -> dict:
    """[22] (see the module docstring): the sweep and sort launches of
    the game's ticks while the bots played, both rounds."""
    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.utils import audit

    phase0 = time.perf_counter()
    release_worlds()
    on_card = dev.type == "cuda"
    where = f"on {dev}"
    if on_card:
        torch.cuda.empty_cache()
        where += f" ({torch.cuda.get_device_name(dev)})"
    tmp = tempfile.mkdtemp(prefix="deployment_")
    ports = free_ports(["d1", "d2", "hd1", "hd2", "hg", "ht", "tcp", "ws",
                        "kcp"])
    ports["dir"] = tmp
    n_bots = sum(DEPLOY_EDGES.values())
    pids: set = set()

    def step(args, want_rc: int, what: str) -> tuple[str, float]:
        return cli_step(tmp, pids, "[22]", args, want_rc, what)

    try:
        with open(os.path.join(tmp, "goworld_tpu.ini"), "w") as f:
            f.write(deploy_ini(slots, ports))
        with open(os.path.join(tmp, "server_torch.py"), "w") as f:
            f.write(DEPLOY_GAME.format(
                monsters=monsters, groups=n_bots // GAME_GROUP,
                # the World on the card, as gw.run() places it by default
                run_args="" if on_card else 'device="cpu"'))
        build_out, build_s = step(["build"], 0, "build")
        _, start_s = step(["start"], 0, "start")
        with open(os.path.join(tmp, "run", "game1.log")) as f:
            glog = f.read()
        if f"started (restore=False) {where}" not in glog:
            fail(f"[22] the game's log does not say it started {where}:\n"
                 f"{glog[-2000:]}")
        # `start` returns at the game's STARTED tag, before its serve loop
        # has timed a tick: status reads the histogram after two
        first = smoke_vars(ports["hg"], lambda v: "tick" in v)["tick"]
        smoke_vars(ports["hg"], lambda v: v.get("tick", 0) > first)
        status_out, _ = step(["status"], 0, "status")
        table = [ln.split() for ln in status_out.splitlines()]
        head = next((r for r in table if r[:1] == ["series"]), [])
        col = head.index("game1") if "game1" in head else -1
        if col < 0 or not any(
                r[:1] == ["tick_latency_ms_count"]
                and r[col] not in ("-", "0") for r in table):
            fail(f"[22] status shows no game tick metrics:\n"
                 f"{status_out[-2000:]}")
        boot = smoke_vars(ports["hg"], lambda v: v.get("spots"))
        rounds = []
        for r in range(2):
            v0 = smoke_vars(ports["hg"], lambda v: v.get("spots")
                            and "interest" not in v)
            h0, marks = tick_hist(ports["hg"]), {}
            got = asyncio.run(deploy_round(ports, v0["spots"], ports["hg"],
                                           r * n_bots, marks))
            h1, v1 = marks["h1"], marks["v1"]
            got["launches"] = {k: v1["launches"][k] - v0["launches"][k]
                               for k in v0["launches"]}
            got["ticks"] = v1["tick"] - v0["tick"]
            n_k = got["ticks"] if on_card else 0
            if got["launches"] != {"sweep_fused": n_k, "counting_sort": n_k,
                                   "halo_ship_phase": 0, "npc_mlp": 0} \
                    or got["ticks"] <= 0:
                fail(f"[22] round {r + 1}: {got['ticks']} game ticks "
                     f"launched {got['launches']}")
            got["hist"] = hist_quantiles(h0, h1)
            got["enters"] = (v1["enters"] - v0["enters"]) / got["ticks"]
            got["at"] = (v0["tick"], v0["staged"])
            rounds.append(got)
            if r == 0:
                # reload: SIGHUP, a fresh freeze file, -restore
                old = cli_pid(tmp, "game1")
                t0 = time.perf_counter()
                proc = start_cli(["reload", tmp])
                while pid_alive(old) and proc.poll() is None:
                    time.sleep(0.02)
                freeze_s = time.perf_counter() - t0
                out, _ = proc.communicate(timeout=DEPLOY_CLI_S)
                restore_s = time.perf_counter() - t0 - freeze_s
                if proc.returncode != 0 or "game1: reloaded" not in out:
                    fail(f"[22] reload exited {proc.returncode}:\n"
                         f"{out[-3000:]}")
                pids.add(cli_pid(tmp, "game1"))
                # the census of the freeze file against the restored
                # game's ledger, type by type (the nil space is made
                # anew at a restore)
                rec = freeze_mod.read_freeze_file(
                    os.path.join(tmp, freeze_mod.freeze_filename(1)))
                by_type: dict = {}
                for e in rec["spaces"] + rec["entities"]:
                    by_type.setdefault(e["type"], []).append(e["id"])
                census = {t: {"count": len(ids),
                              "crc": audit.crc_fold(ids)}
                          for t, ids in sorted(by_type.items())}
                led = http_get(ports["hg"], "/audit")["game1"]["census"]
                led = {t: c for t, c in led.items() if t != "NilSpace"}
                if led != census:
                    fail(f"[22] the restored game's census {led} != the "
                         f"freeze file's {census}")
                with open(os.path.join(tmp, "run", "game1.log")) as f:
                    if f"started (restore=True) {where}" not in f.read():
                        fail(f"[22] the reloaded game did not restore "
                             f"{where}")
        # /profile last before the stop (the profiler hazard)
        prof = http_get(ports["hg"], "/profile?seconds=2")
        if not prof.get("started"):
            fail(f"[22] /profile did not start: {prof}")
        t_end = time.perf_counter() + DEPLOY_CLI_S
        traces = []
        while time.perf_counter() < t_end:
            st = http_get(ports["hg"], "/profile?status=1")
            traces = [os.path.join(prof["logdir"], n)
                      for n in os.listdir(prof["logdir"])] \
                if os.path.isdir(prof["logdir"]) else []
            if not st["active"] and traces:
                break
            time.sleep(0.2)
        if len(traces) != 1:
            fail(f"[22] /profile wrote {traces}")
        in_trace, cats = trace_kernels(traces[0])
        if on_card and min(in_trace.values()) < 1:
            with open(traces[0]) as f:
                names = sorted({e.get("name", "")[:60] for e in
                                json.load(f)["traceEvents"]
                                if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "cuda_runtime")})
            fail(f"[22] the profile holds no sweep or sort launch: "
                 f"{in_trace}; events by category {cats}; names "
                 f"{names[:40]}")
        trace_mb = os.path.getsize(traces[0]) / 2 ** 20
        _, stop_s = step(["stop"], 0, "stop")
        step(["status"], 1, "status after stop")
        alive = [p for p in pids if pid_alive(p)]
        if alive:
            fail(f"[22] processes of the deployment still alive: {alive}")
        launches = {k: sum(r["launches"][k] for r in rounds)
                    for k in rounds[0]["launches"]}
        power = gpu_line() if on_card else "the CPU"
        cores = [ln.strip() for ln in build_out.splitlines()
                 if ln.strip().endswith(": ok")]
        print(f"[22] the deployment through the ops CLI "
              f"(python -m goworld_tpu_torch, ini: {slots} slots, "
              f"fused/pallas, 2 dispatchers, a gate on TCP + WS + KCP, "
              f"snappy): build {build_s:.2f} s ({', '.join(cores)}); "
              f"start to all started {start_s:.2f} s; boot of "
              f"{boot['boot']['monsters']} Monsters in "
              f"{boot['boot']['ticks']} ticks "
              f"({boot['boot']['seconds']:.2f} s); status scraped the "
              f"game's metrics; freeze (SIGHUP to exit, from the reload "
              f"call) {freeze_s:.2f} s, restore (exit to started) "
              f"{restore_s:.2f} s; census of the freeze file == the "
              f"restored game's ledger; profile trace {trace_mb:.1f} MB "
              f"with {in_trace} kernel events; stop {stop_s:.2f} s, "
              f"status 1, no process left ({power})", flush=True)
        for r, got in enumerate(rounds):
            n, p50, p99 = got["hist"]
            print(f"[22] round {r + 1} ({'before' if r == 0 else 'after'} "
                  f"the reload): {n_bots} strict bots "
                  f"{dict(DEPLOY_EDGES)}, login p50 s "
                  + ", ".join(f"{e} {t:.3f}"
                              for e, t in got["login_p50"].items())
                  + f"; window {got['win_s']:.2f} s, {got['ticks']} game "
                  f"ticks, tick_latency_ms histogram p50 {p50:.2f} p99 "
                  f"{p99:.2f} ms over {n:.0f} ticks, {got['enters']:.0f} "
                  f"enter events a tick (from the process's tick "
                  f"{got['at'][0]}, {got['at'][1]} restored poses still "
                  f"staged); launches "
                  f"{got['launches']}; mirrors == interest sets (Monsters "
                  f"a bot min {min(got['mons'])} mean "
                  f"{np.mean(got['mons']):.1f}); {got['says']} says, "
                  f"{got['deliveries']} OnSay deliveries ({power})",
                  flush=True)
        print(f"[22] wall {time.perf_counter() - phase0:.1f} s ({power})",
              flush=True)
        return {"deployment_cli": launches}
    finally:
        for p in pids:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)


def cli_pid(server_dir: str, name: str) -> int:
    with open(os.path.join(server_dir, "run", f"{name}.pid")) as f:
        return int(f.read().strip())


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


# ---------------------------------------------------------------- [23]
# examples/test_game through the port's ops CLI on networked stores: the
# port's minimongo and a three-node miniredis cluster, preloaded with a
# deployment's persistent store at [19]'s population
TG_PRELOAD = 1 << 16      # Avatar documents and avatarOf/ keys
TG_BATCH = 4096           # documents an insert, SETs a pipelined write
TG_BOTS = 64              # strict bots over TCP; half log in as preloaded
TG_SPLIT = [(0, 5460), (5461, 10922), (10923, 16383)]   # the cluster's slots
TG_SHARDS = 10            # OnlineService 3, SpaceService 3, Mail 1, Pubsub 3
TG_HOLD_S = 2.0           # seconds the bots stay in the game a round
TG_ENTRY = "smoke_entry.py"
# [23]'s entry: the stock server_torch.py (its registrations), its serve
# loop's tick publishing on the debug HTTP's /vars the tick count, the
# kernel launch counts, the service shards placed here, the mails the
# MailService holds, the live Avatars and the last Avatar save this
# process issued for each id (what the store must hold once it drained)
TG_GAME = '''"""chip_smoke.py [23]'s entry: examples/test_game/server_torch.py as
it stands, its tick publishing what [23] reads on /vars."""
import runpy

import goworld_tpu_torch as gw
from goworld_tpu_torch import kernels
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.net.game import GameServer
from goworld_tpu_torch.utils import opmon

runpy.run_path("server_torch.py")  # the stock game: registrations only
_tick = GameServer.tick
_save_entity = World.save_entity
SAVES = {{}}


def save_entity(self, e):
    _save_entity(self, e)
    if e.type_name == "Avatar" and self.storage is not None:
        SAVES[e.id] = e.get_persistent_data()


def tick(self):
    _tick(self)
    w = self.world
    svc = w.service_mgr
    live = [e for e in list(w.entities.values()) if not e.destroyed]
    # (a restored MailService holds none: the stock type keeps its
    # mails in a plain attribute that OnInit makes)
    mails = sum(sum(len(v) for v in getattr(e, "mails", {{}}).values())
                for e in live if e.type_name == "MailService")
    opmon.expose("smoke", {{
        "tick": w.tick_count, "launches": dict(kernels.LAUNCHES),
        "placed": 0 if svc is None else len(svc._local_shards),
        "mails": mails,
        "avatars": sum(e.type_name == "Avatar" for e in live),
        "saves": dict(SAVES)}})


World.save_entity = save_entity
GameServer.tick = tick
gw.run({run_args})
'''


def tg_ini(src: str, ports: dict, mongo: str, cluster: str) -> str:
    """``examples/test_game``'s stock ini with [23]'s changes only: the
    dispatcher's and gate's ports moved to free ones, an ``http_port`` on
    each process, the kernels, the networked stores and the entry."""
    out, sec = [], ""
    with open(src) as f:
        lines = f.read().splitlines()
    for line in lines:
        head = line.strip()
        if head.startswith("[") and head.endswith("]"):
            sec = head[1:-1]
            out.append(line)
            extra = {
                "dispatcher1": [f"http_port = {ports['hd']}"],
                "game_common": [f"http_port = {ports['hg']}",
                                "aoi_sweep_impl = fused",
                                "aoi_sort_impl = pallas",
                                "aoi_cell_cap = 28"],
                "gate1": [f"http_port = {ports['ht']}"],
                "storage": ["kind = mongodb", f"directory = {mongo}"],
                "kvdb": ["kind = redis_cluster", f"path = {cluster}"],
            }.get(sec, [])
            out += extra
            continue
        key = head.split("=", 1)[0].strip()
        if sec in ("storage", "kvdb") and key in ("kind", "directory",
                                                  "path"):
            continue
        if key == "port" and sec in ("dispatcher1", "gate1"):
            line = f"port = {ports['d' if sec == 'dispatcher1' else 'tcp']}"
        out.append(line)
    return "[deployment]\nentry = " + TG_ENTRY + "\n\n" + "\n".join(out) \
        + "\n"


def tg_set_pipelined(addr: str, pairs: list, batch: int) -> None:
    """``SET key val`` for every pair on one node, ``batch`` commands a
    write and their ``+OK`` replies read back before the next."""
    from goworld_tpu_torch.ext.db.resp import parse_addr

    host, port, _ = parse_addr(addr)
    with socket.create_connection((host, port), timeout=30.0) as s:
        f = s.makefile("rb")
        for i in range(0, len(pairs), batch):
            part = pairs[i:i + batch]
            s.sendall(b"".join(
                b"*3\r\n$3\r\nSET\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                % (len(k), k, len(v), v) for k, v in part))
            want = b"+OK\r\n" * len(part)
            got = f.read(len(want))
            if got != want:
                fail(f"[23] a pipelined SET on {addr} answered "
                     f"{got[:200]!r}")


def tg_preload(mongo: str, cluster: str, n: int,
               used: int) -> tuple[dict, list, dict]:
    """``n`` Avatar documents (level 0, which the game never writes) and
    their ``avatarOf/<name>`` keys: the ``used`` names the bots log in
    with through ``MongoDBStorage`` and ``RedisClusterKVDB``, the others
    in bulk in the same layout (``{_id, data}`` documents in batched
    ``insert`` commands; ``goworld:``-prefixed keys pipelined to the
    node that owns their slot); ({name: id}, {what: seconds})."""
    from goworld_tpu_torch.ext.db.mongowire import MongoClient
    from goworld_tpu_torch.ext.db.resp import key_slot
    from goworld_tpu_torch.kvdb import RedisClusterKVDB, RedisKVDB
    from goworld_tpu_torch.storage import MongoDBStorage
    from goworld_tpu_torch.utils import ids

    names = {f"pre{i}": ids.gen_entity_id() for i in range(n)}
    picked = [f"pre{i * n // used}" for i in range(used)]
    rest = [nm for nm in names if nm not in set(picked)]
    doc = {nm: {"name": nm, "level": 0, "exp": 0} for nm in names}
    secs = {}
    t0 = time.perf_counter()
    st = MongoDBStorage(mongo)
    for nm in picked:
        st.write("Avatar", names[nm], doc[nm])
    st.close()
    kv = RedisClusterKVDB(cluster.split(","))
    for nm in picked:
        kv.put(f"avatarOf/{nm}", names[nm])
    kv.close()
    secs["clients"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mc = MongoClient.from_addr(mongo)
    for i in range(0, len(rest), TG_BATCH):
        part = rest[i:i + TG_BATCH]
        if mc.insert("Avatar", [{"_id": names[nm], "data": doc[nm]}
                                for nm in part]) != len(part):
            fail(f"[23] a bulk insert of {len(part)} Avatars fell short")
    mc.close()
    secs["mongodb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_node = {addr: [] for addr in cluster.split(",")}
    for nm in rest:
        key = (RedisKVDB.PREFIX + f"avatarOf/{nm}").encode()
        slot = key_slot(key)
        owner = next(a for a, (lo, hi) in zip(by_node, TG_SPLIT)
                     if lo <= slot <= hi)
        by_node[owner].append((key, names[nm].encode()))
    for addr, pairs in by_node.items():
        tg_set_pipelined(addr, pairs, TG_BATCH)
    secs["redis_cluster"] = time.perf_counter() - t0
    return names, picked, secs


async def tg_round(port: int, names: list, first: bool,
                   label: str) -> dict:
    """TG_BOTS strict bots log in by ``names`` (per-bot seconds from the
    login call to the Avatar); on the ``first`` round they subscribe to
    ``news.*``, bot 0 publishes ``news.tpu`` until every subscriber's
    client received it, and each sends a mail; they stay TG_HOLD_S
    seconds and leave."""
    from goworld_tpu_torch.net.botclient import BotClient

    bots = [BotClient("127.0.0.1", port, bot_id=i, strict=True)
            for i in range(len(names))]
    await asyncio.gather(*(b.connect() for b in bots))
    for b in bots:
        b._recv_task = asyncio.ensure_future(b._recv_loop())
    await asyncio.wait_for(asyncio.gather(
        *(b.player_ready.wait() for b in bots)), DEPLOY_CLI_S)
    t0 = time.perf_counter()
    for b, name in zip(bots, names):
        b.call_server("Login_Client", name)
    login = {}
    t_end = t0 + DEPLOY_CLI_S
    while len(login) < len(bots) and time.perf_counter() < t_end:
        for b, name in zip(bots, names):
            if name not in login and b.player is not None \
                    and b.player.type_name == "Avatar" \
                    and b.player.attrs.get("name") == name:
                login[name] = time.perf_counter() - t0
        await asyncio.sleep(0.01)
    if len(login) != len(bots):
        fail(f"{label} {len(login)} of {len(bots)} logins reached their "
             f"Avatar")
    got = dict(ids={n: b.player.eid for b, n in zip(bots, names)},
               login_p50=float(np.percentile(list(login.values()), 50)),
               publishes=0)
    if first:
        for b in bots:
            b.call_server("Subscribe_Client", "news.*")
        await asyncio.sleep(1.0)

        def delivered(b):
            return any(m == "OnPublish" and a == ["news.tpu", "tpu news"]
                       for _, m, a in b.rpc_log)

        t_end, t_pub = time.perf_counter() + 60.0, 0.0
        while not all(delivered(b) for b in bots):
            if time.perf_counter() > t_end:
                fail(f"{label} OnPublish reached "
                     f"{sum(map(delivered, bots))} of {len(bots)} "
                     f"subscribers in {got['publishes']} publishes")
            if time.perf_counter() - t_pub > 10.0:
                bots[0].call_server("Publish_Client", "news.tpu",
                                    "tpu news")
                got["publishes"] += 1
                t_pub = time.perf_counter()
            await asyncio.sleep(0.05)
        for i, b in enumerate(bots):
            b.call_server("SendMail_Client", names[(i + 1) % len(bots)],
                          f"mail from {names[i]}")
    await asyncio.sleep(TG_HOLD_S)
    errors = [e for b in bots for e in b.errors]
    if errors:
        fail(f"{label} strict mirrors report {len(errors)} errors: "
             f"{errors[:4]}")
    got["mails_sent"] = len(bots) if first else 0
    await bots_leave(bots)
    return got


# ROADMAP C8: the stock services' state lives in attributes their OnInit
# makes, which a restore does not run; {service: (attribute, methods)}
TG_C8 = {"OnlineService": ("online", {"NotifyOnline", "NotifyOffline"}),
         "SpaceService": ("space_loads", {"EnterSpace"}),
         "MailService": ("mails", {"SendMail"})}


def tg_tracebacks(text: str, c8: bool) -> tuple[list, int]:
    """The traceback blocks of a log, each as (the line logged before
    it, its exception line); with ``c8`` those of a failed service RPC
    that ROADMAP C8 explains (an ``AttributeError`` on the attribute the
    service's OnInit makes, in one of its own methods) are counted and
    not listed. A chained exception's later block follows no RPC line,
    so it is listed."""
    lines = text.splitlines()
    bad, n_c8 = [], 0
    for i, line in enumerate(lines):
        if "Traceback (most recent call last)" not in line:
            continue
        head = lines[i - 1] if i else ""
        j = i + 1
        while j < len(lines) and (not lines[j] or lines[j][0].isspace()):
            j += 1
        exc = lines[j] if j < len(lines) else ""
        m = re.search(r"RPC <(\w+) [^>]*>\.(\w+) failed$", head)
        if c8 and m and m.group(1) in TG_C8:
            attr, methods = TG_C8[m.group(1)]
            if m.group(2) in methods and re.fullmatch(
                    rf"AttributeError: '{m.group(1)}' object has no "
                    rf"attribute '{attr}'(\. Did you mean: '\w+'\?)?", exc):
                n_c8 += 1
                continue
        bad.append((head, exc))
    return bad, n_c8


def tg_read_back(maddr: str, ids_of: dict, saves: dict, what: str) -> float:
    """Every bot's Avatar from minimongo through a fresh
    ``MongoDBStorage``, equal to the last save the game issued for it;
    the seconds the reads took."""
    from goworld_tpu_torch.storage import MongoDBStorage

    t0 = time.perf_counter()
    st = MongoDBStorage(maddr)
    docs = {n: st.read("Avatar", eid) for n, eid in ids_of.items()}
    st.close()
    bad = [(n, docs[n], saves.get(eid)) for n, eid in ids_of.items()
           if docs[n] is None or docs[n] != saves.get(eid)
           or docs[n].get("name") != n or docs[n].get("level", 0) < 1]
    if bad:
        fail(f"[23] Avatars not read back as {what} saved them "
             f"(name, read, saved): {bad[:4]}")
    return time.perf_counter() - t0


def test_game_phase(dev, tag: str, preload: int = TG_PRELOAD,
                    n_bots: int = TG_BOTS) -> dict:
    """[23] (see the module docstring): the sweep and sort launches of the
    game's ticks in both rounds."""
    from goworld_tpu_torch.ext.db.minimongo import MiniMongo
    from goworld_tpu_torch.ext.db.miniredis import MiniRedis
    from goworld_tpu_torch.kvdb import RedisClusterKVDB
    from goworld_tpu_torch.storage import MongoDBStorage

    label = "[23]"
    phase0 = time.perf_counter()
    on_card = dev.type == "cuda"
    where = f"on {dev}"
    if on_card:
        torch.cuda.empty_cache()
        where += f" ({torch.cuda.get_device_name(dev)})"
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "examples", "test_game")
    tmp = tempfile.mkdtemp(prefix="test_game_")
    ports = free_ports(["d", "hd", "hg", "ht", "tcp"])
    mongo = MiniMongo().start()
    nodes = [MiniRedis(cluster_slots=r).start() for r in TG_SPLIT]
    for n in nodes:
        n.peers = {m.addr: m.cluster_slots for m in nodes if m is not n}
    maddr = mongo.addr + "/goworld"
    cluster = ",".join(n.addr for n in nodes)
    pids: set = set()

    def step(args, want_rc: int, what: str) -> float:
        return cli_step(tmp, pids, label, args, want_rc, what)[1]

    try:
        half = n_bots // 2
        names, picked, pre_s = tg_preload(maddr, cluster, preload, half)
        t_pre = time.perf_counter() - phase0
        shutil.copy(os.path.join(src, "server_torch.py"), tmp)
        with open(os.path.join(tmp, "goworld_tpu.ini"), "w") as f:
            f.write(tg_ini(os.path.join(src, "goworld_tpu.ini"), ports,
                           maddr, cluster))
        with open(os.path.join(tmp, TG_ENTRY), "w") as f:
            f.write(TG_GAME.format(
                run_args="" if on_card else 'device="cpu"'))
        bot_names = picked + [f"new{i}" for i in range(n_bots - half)]
        start_s = step(["start"], 0, "start")
        with open(os.path.join(tmp, "run", "game1.log")) as f:
            if f"started (restore=False) {where}" not in f.read():
                fail(f"{label} the game did not start {where}")
        rounds = []
        for r in range(2):
            v0 = smoke_vars(ports["hg"], lambda v: v.get("placed", 0)
                            >= TG_SHARDS, label)
            h0 = tick_hist(ports["hg"])
            got = asyncio.run(tg_round(ports["tcp"], bot_names, r == 0,
                                       label))
            # the bots' Avatars destroyed, each save issued
            v1 = smoke_vars(ports["hg"], lambda v: v.get("mails", 0)
                            >= got["mails_sent"] and v["avatars"] == 0
                            and set(got["ids"].values()) <= set(v["saves"]),
                            label)
            got["saves"] = v1["saves"]
            got["hist"] = hist_quantiles(h0, tick_hist(ports["hg"]))
            got["ticks"] = v1["tick"] - v0["tick"]
            got["launches"] = {k: v1["launches"][k] - v0["launches"][k]
                               for k in v0["launches"]}
            got["mails"] = v1["mails"]
            n_k = got["ticks"] if on_card else 0
            if got["ticks"] <= 0 or \
                    got["launches"]["sweep_fused"] < n_k or \
                    got["launches"]["counting_sort"] < n_k or \
                    got["launches"]["halo_ship_phase"] or \
                    got["launches"]["npc_mlp"]:
                fail(f"{label} round {r + 1}: {got['ticks']} game ticks "
                     f"launched {got['launches']}")
            rounds.append(got)
            if r == 0:
                reload_s = step(["reload"], 0, "reload")
                with open(os.path.join(tmp, "run", "game1.log")) as f:
                    if f"started (restore=True) {where}" not in f.read():
                        fail(f"{label} the reloaded game did not restore "
                             f"{where}")
                # the first game drained its saves at its freeze: read
                # them back, then set every bot's Avatar to level 0 (which
                # the game never writes), so that only the restored
                # game's saves can pass the read-back after stop
                read1_s = tg_read_back(maddr, got["ids"], got["saves"],
                                       "the first game")
                st = MongoDBStorage(maddr)
                for name, eid in got["ids"].items():
                    st.write("Avatar", eid, {"name": name, "level": 0,
                                             "exp": 0})
                st.close()
        stop_s = step(["stop"], 0, "stop")
        step(["status"], 1, "status after stop")
        alive = [p for p in pids if pid_alive(p)]
        if alive:
            fail(f"{label} processes of the deployment still alive: "
                 f"{alive}")
        # no traceback in a log, but for the restored game's service
        # RPCs that ROADMAP C8 explains: a restore runs OnRestored and not
        # OnInit (as the JAX package's does), so the stock services lack
        # the attributes their OnInit makes; counted and printed
        rd = os.path.join(tmp, "run")
        restored_rpc_failures = 0
        for name in sorted(n for n in os.listdir(rd) if n.endswith(".log")):
            with open(os.path.join(rd, name), errors="replace") as f:
                text = f.read()
            before, mark, after = text.partition("started (restore=True)")
            bad, _ = tg_tracebacks(before, False)
            if name == "game1.log" and mark:
                bad_after, restored_rpc_failures = tg_tracebacks(after, True)
                bad += bad_after
            if bad:
                fail(f"{label} {name} holds {len(bad)} traceback(s) "
                     f"(logged line, exception): {bad[:4]}")
        first, second = rounds
        for name in bot_names:
            if name in names and first["ids"][name] != names[name]:
                fail(f"{label} {name} logged in to {first['ids'][name]}, "
                     f"not its preloaded Avatar {names[name]}")
            if second["ids"][name] != first["ids"][name]:
                fail(f"{label} {name}'s second login reached "
                     f"{second['ids'][name]}, not {first['ids'][name]}")
        # acknowledged writes, read back through fresh clients
        t0 = time.perf_counter()
        kv = RedisClusterKVDB(cluster.split(","))
        new = [n for n in bot_names if n not in names]
        keys = {n: kv.get(f"avatarOf/{n}") for n in new}
        kv.close()
        if keys != {n: first["ids"][n] for n in new}:
            bad = sorted(n for n in new if keys[n] != first["ids"][n])
            fail(f"{label} the cluster lost avatarOf/ keys: {bad[:8]}")
        read_s = time.perf_counter() - t0 + tg_read_back(
            maddr, second["ids"], second["saves"], "the restored game")
        if first["mails"] < first["mails_sent"]:
            fail(f"{label} the MailService holds {first['mails']} of "
                 f"{first['mails_sent']} mails")
        launches = {k: sum(r["launches"][k] for r in rounds)
                    for k in first["launches"]}
        power = gpu_line() if on_card else "the CPU"
        print(f"{label} examples/test_game through the ops CLI on mongodb "
              f"and a 3-node redis cluster (stock ini: capacity 4096, "
              f"n_spaces 4; fused/pallas, cell_cap 28): preload of "
              f"{preload} Avatar documents and as many avatarOf/ keys: "
              f"{half} of each through MongoDBStorage and "
              f"RedisClusterKVDB {pre_s['clients']:.2f} s, the rest in "
              f"bulk {pre_s['mongodb']:.2f} s (documents) and "
              f"{pre_s['redis_cluster']:.2f} s (keys) ({t_pre:.2f} s "
              f"with the servers' start); start "
              f"{start_s:.2f} s, reload {reload_s:.2f} s, stop "
              f"{stop_s:.2f} s, status 1, no process left; {n_bots} "
              f"strict bots ({n_bots // 2} preloaded names, each on its "
              f"preloaded Avatar); OnPublish to all {n_bots} subscribers "
              f"in {first['publishes']} publish(es); {first['mails']} "
              f"mails held; {len(bot_names)} Avatars read back as the "
              f"first game saved them in {read1_s:.2f} s; {len(new)} new "
              f"keys and {len(bot_names)} Avatars read back as the "
              f"restored game saved them in {read_s:.2f} s; "
              f"{restored_rpc_failures} service RPCs failed in the "
              f"restored game (ROADMAP C8) ({power})", flush=True)
        for r, got in enumerate(rounds):
            n, p50, p99 = got["hist"]
            print(f"{label} round {r + 1} ({'before' if r == 0 else 'after'}"
                  f" the reload): login p50 {got['login_p50']:.3f} s; "
                  f"{got['ticks']} game ticks, tick_latency_ms histogram "
                  f"p50 {p50:.2f} p99 {p99:.2f} ms over {n:.0f} ticks; "
                  f"launches {got['launches']}; every name on the same "
                  f"Avatar id in both rounds ({power})", flush=True)
        print(f"{label} wall {time.perf_counter() - phase0:.1f} s "
              f"({power})", flush=True)
        return {"test_game_cli": launches}
    finally:
        for p in pids:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        for srv in [mongo, *nodes]:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- [24]
# hot-standby replication and the rebalance plane. (a) the failover
# soak's sequence (goworld_tpu_torch/tools/chaos_soak.py run_failover)
# at the served game's population on the card's kernels; (b) the
# deployment through the ops CLI with a standby, a third game and the
# rebalance plane on.
# [19]'s population is 2^17; every frame packs and unpacks each
# entity's host record in Python (PERF.md §4): 2^15 took 62.2 s of
# soak and [24] 207.7 s with twins at 2^13 / 2^12 and (b) at 2^14
# Monsters (FC); with the twins at 2^10 / 2^9 and (b) at 2^12 it fits
# [24]'s 150 s; 2^14 since [25] joined the run (PERF.md §4)
FAILOVER_N = 1 << 14
FAILOVER_TICKS = 24         # streamed ticks; the kill at the last
FAILOVER_KEYFRAME = 8
FAILOVER_PROMOTED = 8       # promoted ticks at least, on until drained
FAILOVER_DRAIN_MAX = 64
FAILOVER_TWIN_N = 1 << 10   # kernel/plain twins
FAILOVER_CPU_N = 1 << 9     # the card against the CPU port
LAG_BUDGET_TICKS = 16       # the standby's lag budget (ini default)


def failover_build_kw(n: int, plain: bool = False) -> dict:
    """``build_world``'s arguments for the soak's mixed World of ``n``
    at the bench world's density and grid (``slice_config``: radius 50,
    k 32, cell_cap 12, fused/pallas; with the soak's skin 4 the Verlet
    rebuild runs the gated sweep at k 48) and [19]'s caps; ``plain``
    puts the sweep and the sort on their plain versions."""
    g = slice_config(n).grid
    grid = dict(k=g.k, cell_cap=g.cell_cap, row_block=g.row_block,
                topk_impl=g.topk_impl, precision=g.precision,
                sweep_impl="ranges" if plain else g.sweep_impl,
                sort_impl="counting" if plain else g.sort_impl)
    c = slice_config(n)
    caps = dict(enter_cap=c.enter_cap, leave_cap=c.leave_cap,
                sync_cap=c.sync_cap, attr_sync_cap=c.attr_sync_cap,
                input_cap=c.input_cap, delta_rows_cap=c.delta_rows_cap)
    return dict(extent=g.extent_x, radius=g.radius, grid_kw=grid,
                cfg_kw=caps)


@contextlib.contextmanager
def seeded_ids(key: str):
    """``ids.gen_entity_id`` as one seeded sequence (two runs of the
    soak then mint the same ids, as the tests make both packages do)."""
    from goworld_tpu_torch.utils import ids

    real, seq = ids.gen_entity_id, [0]

    def fixed() -> str:
        seq[0] += 1
        return ids.gen_fixed_id(f"{key}.{seq[0]}")

    ids.gen_entity_id = fixed
    try:
        yield
    finally:
        ids.gen_entity_id = real


def sync_guard_for(dev):
    """A context manager in which any op that makes the host wait on the
    card raises (a no-op off the card)."""
    @contextlib.contextmanager
    def guard():
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    return guard


def soak_failover(dev, n: int, plain: bool = False, guard=None,
                  on_build=None) -> tuple[dict, dict]:
    """``run_failover`` on ``dev`` at ``n``: (report, kept Worlds); it
    fails unless the soak's verdicts hold and no frame was torn."""
    from goworld_tpu_torch.tools import chaos_soak as soak

    keep: dict = {}
    rep = soak.run_failover(
        SEED, n=n, ticks=FAILOVER_TICKS, keyframe_every=FAILOVER_KEYFRAME,
        device=dev.type, build_kw=failover_build_kw(n, plain),
        capture_guard=guard, on_build=on_build, keep=keep)
    bad = [k for k in ("stream_ok", "promote_ok", "arbitration_ok",
                       "decision_log_replay_ok", "census_ok",
                       "conservation_ok", "cold_restore_ok")
           if rep.get(k) is not True]
    # the soak's ``converged`` also needs its A/B (a warm promotion 10x
    # a cold restore), which the port misses: reported, not gated
    # (ROADMAP.md Queue C15)
    if rep.get("error") or bad or rep["frames_rejected"]:
        side = "plain" if plain else "kernels"
        fail(f"[24] failover at {n} on {dev} ({side}): error "
             f"{rep.get('error')}, failed {bad}, torn "
             f"frames {rep.get('frames_rejected')}; lost "
             f"{rep.get('lost_eids')} duplicated "
             f"{rep.get('duplicated_eids')}; "
             f"{rep.get('conservation_verdict')}")
    return rep, keep


def promoted_view(w) -> dict:
    """A promoted World as plain values: every lane of its state and
    last outputs, its census by type and its ledger's snapshot."""
    # copies: on the CPU ``.cpu()`` aliases the lanes, which the next
    # tick writes in place
    view = {f"state.{k}": v.cpu().clone() if torch.is_tensor(v) else v
            for k, v in lanes(w.state).items()}
    view.update({f"out.{k}": v.cpu().clone() for k, v in lanes(
        w.last_outputs).items() if torch.is_tensor(v)})
    led = w.audit.ledger.snapshot(tick=w.tick_count, eids=True)
    return {"lanes": view, "ledger": led,
            "census": sorted((e.id, e.type_name)
                             for e in w.entities.values()
                             if not e.destroyed)}


def views_differ(a: dict, b: dict) -> list:
    bad = [k for k in a["lanes"] if not (
        a["lanes"][k] is None and b["lanes"].get(k) is None
        or a["lanes"][k] is not None and b["lanes"].get(k) is not None
        and same_bits(a["lanes"][k], b["lanes"][k]))]
    if a["census"] != b["census"]:
        bad.append("census")
    if a["ledger"] != b["ledger"]:
        bad.append("ledger")
    return bad


def failover_twins(dev) -> str:
    """The same sequence at FAILOVER_TWIN_N on the kernels and on the
    plain versions (every lane, the census and the ledger equal after
    promotion and on 3 more ticks), and at FAILOVER_CPU_N on the card
    and on the CPU port (the same)."""
    out = []
    for n, sides in ((FAILOVER_TWIN_N, ((dev, False), (dev, True))),
                     (FAILOVER_CPU_N, ((dev, False),
                                       (torch.device("cpu"), False)))):
        views = []
        for d, plain in sides:
            with seeded_ids(f"failover.{n}"):
                rep, keep = soak_failover(d, n, plain)
                w = keep["standby"]
                seq = [promoted_view(w)]
                for _ in range(3):
                    w.tick()
                    seq.append(promoted_view(w))
            views.append((rep, seq))
            del keep, w
        (ra, va), (rb, vb) = views
        for t, (a, b) in enumerate(zip(va, vb)):
            bad = views_differ(a, b)
            if bad:
                fail(f"[24] failover twins at {n} ({sides[1]}) differ at "
                     f"promoted tick {t}: {bad[:8]}")
        for k in ("decision_log", "frames_applied", "entities_promoted",
                  "replication_bytes_per_tick", "frame_kinds"):
            if ra[k] != rb[k]:
                fail(f"[24] failover twins at {n}: {k} {ra[k]} != {rb[k]}")
        out.append(f"{n}: {len(va)} promoted views equal")
        release_worlds()
    return "; ".join(out)


def failover_part(dev, tag: str, n: int | None = None) -> dict:
    """[24] (a): ``run_failover`` at ``n`` (FAILOVER_N) on the card's
    kernels, the captures under the sync guard, then the promoted World
    ticked on until no pose stays staged; the twins. Returns the
    launches of its paths."""
    from goworld_tpu_torch.net import codec

    n = n or FAILOVER_N
    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    sync = {"bytes": 0, "records": 0}

    def on_build(primary, standby):
        def sink(gate_id, cids, eids, vals):
            sync["records"] += len(cids)
            sync["bytes"] += len(codec.encode_client_sync_batch(
                np.asarray(cids, "S16"), np.asarray(eids, "S16"),
                np.asarray(vals, np.float32).reshape(-1, 4)))
        primary.sync_sink = sink

    kernels.reset_launches()
    rep, keep = soak_failover(dev, n, guard=sync_guard_for(dev),
                              on_build=on_build)
    soak_s = time.perf_counter() - t0
    soak_launches = dict(kernels.LAUNCHES)
    # the soak ran: 24 primary ticks, the standby's warm tick, its first
    # promoted tick and the cold restore's first tick, each 1 + 1
    want = FAILOVER_TICKS + 3 if on_card else 0
    if (soak_launches["sweep_fused"], soak_launches["counting_sort"]) \
            != (want, want):
        fail(f"[24] the failover soak's ticks launched {soak_launches}, "
             f"not {want} sweeps and sorts")
    w = keep["standby"]
    staged = [len(w._staged_pos)]
    kernels.reset_launches()
    ticks = 0
    while ticks < FAILOVER_PROMOTED or (
            w._staged_pos and ticks < FAILOVER_DRAIN_MAX):
        w.tick()
        ticks += 1
        staged.append(len(w._staged_pos))
    promoted = dict(kernels.LAUNCHES)
    if on_card and (promoted["sweep_fused"], promoted["counting_sort"]) \
            != (ticks, ticks):
        fail(f"[24] {ticks} promoted ticks launched {promoted}")
    drain = next((i for i, s in enumerate(staged) if s == 0), None)
    if drain is None:
        fail(f"[24] staged poses after {ticks} promoted ticks: {staged}")
    apply = np.array(rep["apply_ms_frames"])
    lag = np.array(rep["frame_lag_ms"]) * 60.0 / 1e3
    wk = rep["worker"]
    line = (
        f"[24] (a) failover at {n} (mixed, skin 4, fused/pallas, k 32 "
        f"gated at 48): {rep['ticks']} streamed ticks at keyframe cadence "
        f"{rep['keyframe_every']}, {rep['frame_kinds']['key']} keyframes "
        f"and {rep['frame_kinds']['delta']} deltas applied, "
        f"{rep['frames_rejected']} torn, {wk['captures_dropped']} "
        f"captures dropped, {wk['disk_writes']} chain records on disk "
        f"from the worker; replication {rep['replication_bytes_per_tick']}"
        f" B a tick beside the client syncs' {sync['bytes'] / rep['ticks']:.1f}"
        f" B a tick ({sync['records'] / rep['ticks']:.0f} records); apply "
        f"ms a frame p50 {np.percentile(apply, 50):.3f} p99 "
        f"{np.percentile(apply, 99):.3f}; lag capture-to-applied in 60 Hz "
        f"ticks p50 {np.percentile(lag, 50):.2f} p99 "
        f"{np.percentile(lag, 99):.2f} against the budget of "
        f"{LAG_BUDGET_TICKS}; promotion {rep['promotion_latency_ticks']} "
        f"ticks, {rep['promotion_secs']} s (claim, arbitration and the "
        f"first promoted tick), cold restore from the worker's chain "
        f"{rep['cold_restore_secs']} s ({rep['warm_vs_cold_speedup']}x, "
        f"reported, not gated); {rep['entities_promoted']} entities "
        f"promoted, 0 lost, 0 duplicated, both stale-claim orders "
        f"refused, decision log replayed byte for byte, conservation "
        f"verdict green; the staged poses ({staged[0]}) drained after "
        f"{drain} promoted ticks; {ticks} promoted ticks launched "
        f"{promoted}; the captures ran under the sync guard")
    del keep, w
    release_worlds()
    t_tw = time.perf_counter()
    twins = failover_twins(dev)
    line += (f"; twins {twins} in {time.perf_counter() - t_tw:.1f} s; "
             f"the soak {soak_s:.1f} s, (a) {time.perf_counter() - t0:.1f}"
             f" s {tag}")
    print(line, flush=True)
    return {"failover_soak": soak_launches, "failover_promoted": promoted}


# Monsters on game1: (a) carries the size. With a standby attached the
# primary captures every host record a tick, and the handoff pumps
# every 16 ticks: at 2^14 the tick p50 read 799.5 ms and the handoff
# 14.45 s (FD), which with (a) at 2^15 would take [24] past its 150 s
STANDBY_MONSTERS = 1 << 12
STANDBY_BOTS = 16           # strict TCP bots
STANDBY_HANDOFF = 64        # the JAX default rebalance_batch
STANDBY_WALK_S = 2.0

# [24] (b)'s game script: [22]'s types; game1 boots the Monsters and
# game3 an empty Arena, game2 is game1's standby and boots nothing. Its
# serve loop publishes on /vars what the checker reads: the tick count,
# the launch counts, the poses still staged, the role, the wall time of
# the first promoted tick, the dispatcher's pause lane for game1 as the
# game's kvreg mirror holds it, the replication worker's counts and the
# serve loop's spans summed over its closed tick records (the capture's
# share of the tick); while a PAUSE file exists, a serving game does not
# tick and publishes every bot Avatar's interest set (the World at rest,
# as [22]).
STANDBY_GAME = '''"""chip_smoke.py [24]'s game: a primary, its standby, a peer."""
import os
import time

import goworld_tpu_torch as gw
import chip_smoke as cs
from goworld_tpu_torch import kernels
from goworld_tpu_torch.net.game import GameServer
from goworld_tpu_torch.utils import metrics, opmon

BOOT = {{}}
STATE = {{"promoted_at": None, "promoted_tick": None}}
# the closed tick records' spans: ticks, their wall ms, ms by span
SPANS = {{"ticks": 0, "tick_ms": 0.0, "ms": {{}}, "last": 0.0}}
gw.register_entity("Account", cs.GameAccount)
gw.register_entity("Avatar", cs.GameAvatar)
gw.register_entity("Monster", cs.GameMonster)
gw.register_space("Arena", cs.GameArena)


def boot(w):
    if w.game_id == 1:
        cs.boot_monsters(w, {monsters}, cs.SEED, BOOT)
    else:
        w.arena = w.create_space("Arena")
        w.said = []


gw.on_boot(boot)
_tick = GameServer.tick
_spots = []


def interest(w):
    ents, out = w.entities, {{}}
    for e in list(ents.values()):
        if e.type_name == "Avatar" and not e.destroyed \\
                and e.client is not None:
            out[e.id] = sorted({{e.id, *e.interested_in}})
    return out


def tally_spans():
    for wall_us, dur, spans, _ in metrics.timeline.records():
        if wall_us <= SPANS["last"]:
            continue
        SPANS["last"] = wall_us
        SPANS["ticks"] += 1
        SPANS["tick_ms"] += dur * 1e3
        for name, _, d, _ in spans:
            SPANS["ms"][name] = SPANS["ms"].get(name, 0.0) + d * 1e3


def tick(self):
    w = self.world
    standby = self._standby_applier is not None and not self._promoted
    if not standby and getattr(w, "arena", None) is None:
        w.arena = next((s for s in w.spaces.values()
                        if s.type_name == "Arena"), None)
        w.said = []
    if w.game_id == 1 and not _spots:
        _spots.extend(cs.game_spots(w, {groups}, cs.GAME_GROUP, cs.SEED))
    if os.path.exists("PAUSE") and not standby:
        v = opmon.vars().get("smoke", {{}})
        if "interest" not in v:
            opmon.expose("smoke", dict(v, interest=interest(w)))
        return
    _tick(self)
    if self._promoted and STATE["promoted_at"] is None:
        STATE["promoted_at"] = time.time()
        STATE["promoted_tick"] = w.tick_count
    rw = self.repl_worker
    tally_spans()
    opmon.expose("smoke", {{
        "tick": w.tick_count, "launches": dict(kernels.LAUNCHES),
        "spans": {{k: v for k, v in SPANS.items() if k != "last"}},
        "staged": len(w._staged_pos), "boot": BOOT, "spots": _spots,
        "standby": standby, **STATE,
        "pause_lane": self.kvreg.get("rebalance/pause/game1"),
        "worker": rw.stats() if rw is not None else None}})


GameServer.tick = tick
gw.run({run_args})
'''


def standby_ini(slots: int, ports: dict) -> str:
    """[22]'s ini with a TCP gate only, the rebalance plane on at the
    JAX defaults, game1's chain checkpoint on the replication worker,
    game2 its standby and game3 a peer that takes no boot entity."""
    grid = slice_config(slots).grid
    ext = grid.extent_x
    disp = "".join(
        f"[dispatcher{i}]\nhost = 127.0.0.1\nport = {ports[f'd{i}']}\n"
        f"http_port = {ports[f'hd{i}']}\n\n" for i in (1, 2))
    return (f"[deployment]\nrebalance = true\n\n{disp}[game_common]\n"
            f"boot_entity = Account\ncapacity = {slots}\nn_spaces = 1\n"
            f"aoi_radius = 50.0\nextent_x = {ext}\nextent_z = {ext}\n"
            f"aoi_k = {grid.k}\naoi_cell_cap = {grid.cell_cap}\n"
            "aoi_sweep_impl = fused\naoi_sort_impl = pallas\n"
            "position_sync_interval_ms = 50\noverload = false\n\n"
            f"[game1]\nhttp_port = {ports['g1']}\n"
            "checkpoint_interval = 1\nsnapshot_keyframe_every = 8\n\n"
            f"[game2]\nhttp_port = {ports['g2']}\nstandby_of = 1\n\n"
            f"[game3]\nhttp_port = {ports['g3']}\nban_boot_entity = true"
            f"\n\n[gate1]\nhost = 127.0.0.1\nport = {ports['tcp']}\n"
            f"http_port = {ports['ht']}\n\n[storage]\nkind = filesystem\n"
            "directory = entity_storage\n\n[kvdb]\nkind = filesystem\n"
            "path = kvdb_data\n")


def replayed_log(text: bytes) -> bytes:
    """A promotion log's lines back through ``replay_decisions``."""
    from goworld_tpu_torch.replication.promote import replay_decisions

    inputs = []
    for line in text.decode().splitlines():
        event, *pairs = line.split(" ")
        inputs.append((event, dict(p.split("=", 1) for p in pairs)))
    return replay_decisions(inputs)


async def standby_login(bots, spots) -> None:
    await bots_login(bots, spots)
    if not all(b.player is not None and b.player.type_name == "Avatar"
               for b in bots):
        fail("[24] not every bot reached an Avatar")


async def standby_mirrors(bots, ports: dict, games: list, moved: set,
                          at_kill: dict) -> tuple[int, int, int]:
    """The serving games at rest (PAUSE): every bot's mirror against
    its Avatar's interest set, wherever the Avatar lives; the strict
    mirrors' errors. Two kinds of entry are counted apart, both held
    to the JAX package: an entity the handoff moved to game3
    (``moved``) stays in its old watchers' mirrors, since the World
    keeps it in their interest sets (ROADMAP.md Queue C12) and the
    promoted game never held it; and an entity a bot held when the
    primary died (``at_kill``: bot id -> its mirror then) that stays in
    its mirror alone, since the promoted game starts from its last
    applied frame and never re-syncs its clients (C13). Any other
    difference fails. Returns (bots checked, C12 entries, C13
    entries)."""
    loop = asyncio.get_running_loop()
    rest = os.path.join(ports["dir"], "PAUSE")
    open(rest, "w").close()
    try:
        sets: dict = {}
        for g in games:
            v = await loop.run_in_executor(
                None, smoke_vars, ports[g], lambda v: "interest" in v,
                "[24]")
            sets.update(v["interest"])
        await asyncio.sleep(1.0)
        mism, stale, stale13 = [], 0, 0
        for b in bots:
            want = sets.get(b.player.eid)
            if want is None:
                fail(f"[24] bot{b.bot_id}'s Avatar {b.player.eid} holds "
                     f"no client on {games}")
            diff = set(b.entities) ^ set(want)
            c12 = {x for x in diff if x in moved and x in b.entities}
            c13 = {x for x in diff - c12 if x in b.entities
                   and x in at_kill[b.bot_id]}
            stale += len(c12)
            stale13 += len(c13)
            if diff - c12 - c13:
                mism.append((b.bot_id, [
                    (x, "mirror only" if x in b.entities else "server only")
                    for x in sorted(diff - c12 - c13)[:3]]))
        errors = [e for b in bots for e in b.errors]
        if errors or mism:
            fail(f"[24] strict mirrors: {len(errors)} errors {errors[:4]}; "
                 f"(bot, entities) differing from the interest sets "
                 f"{mism[:8]}")
    finally:
        os.unlink(rest)
    return len(bots), stale, stale13


def standby_deploy_part(dev, tag: str, slots: int = GAME_SLOTS,
                        monsters: int = STANDBY_MONSTERS) -> tuple:
    """[24] (b): the deployment through the ops CLI. Returns the sweep
    and sort launches of its three game processes and its line."""
    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.net.botclient import BotClient

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="standby_")
    ports = free_ports(["d1", "d2", "hd1", "hd2", "g1", "g2", "g3", "ht",
                        "tcp"])
    ports["dir"] = tmp
    pids: set = set()

    def step(args, want_rc: int, what: str) -> tuple[str, float]:
        return cli_step(tmp, pids, "[24]", args, want_rc, what)

    def verdict() -> dict:
        # the target first, then the donor: an entity read live on the
        # donor cannot then be read arrived on the target
        snaps = [http_get(ports["g3"], "/audit")["game3"],
                 http_get(ports["g1"], "/audit")["game1"]]
        return audit_mod.conservation_verdict(snaps)

    bots = []
    try:
        with open(os.path.join(tmp, "goworld_tpu.ini"), "w") as f:
            f.write(standby_ini(slots, ports))
        with open(os.path.join(tmp, "server_torch.py"), "w") as f:
            f.write(STANDBY_GAME.format(
                monsters=monsters, groups=STANDBY_BOTS // GAME_GROUP,
                run_args="" if on_card else 'device="cpu"'))
        _, start_s = step(["start"], 0, "start")
        t_sb = time.perf_counter()
        t_end = t_sb + DEPLOY_CLI_S
        while True:
            sb = http_get(ports["g2"], "/standby").get("game2") or {}
            if sb.get("pass") and sb.get("frames", 0) > 0:
                break
            if time.perf_counter() > t_end:
                fail(f"[24] the standby's verdict never passed: {sb}")
            time.sleep(0.1)
        attach_s = time.perf_counter() - t_sb
        spots = smoke_vars(ports["g1"], lambda v: v.get("spots"),
                           "[24]")["spots"]
        bots = [BotClient("127.0.0.1", ports["tcp"], bot_id=i,
                          strict=True, speed=1.0, move_interval=0.1,
                          seed=SEED + i) for i in range(STANDBY_BOTS)]
        loop = asyncio.new_event_loop()
        loop.run_until_complete(standby_login(bots, spots))
        h0 = tick_hist(ports["g1"])
        s0 = smoke_vars(ports["g1"], None, "[24]")["spans"]
        loop.run_until_complete(bots_walk(bots, STANDBY_WALK_S))
        h1 = tick_hist(ports["g1"])

        # the manual drain of 64 entities of game1's fullest Space
        got = http_get(ports["g1"],
                       f"/rebalance?handoff=3&batch={STANDBY_HANDOFF}")
        if not got.get("requested"):
            fail(f"[24] /rebalance?handoff=3 answered {got}")
        lanes_seen, windows, t_h = set(), 0, time.perf_counter()
        while True:
            v = verdict()
            windows += 1
            if not v["ok"]:
                fail(f"[24] conservation during the handoff: "
                     f"{v['problems'][:4]}")
            lanes_seen.add(smoke_vars(ports["g1"], None,
                                      "[24]").get("pause_lane"))
            agent = http_get(ports["g1"], "/rebalance")["agents"]["game1"]
            if agent["completed"] or agent["aborted"]:
                break
            if time.perf_counter() - t_h > DEPLOY_CLI_S:
                fail(f"[24] the handoff did not end: {agent}")
            time.sleep(0.05)
        handoff_s = time.perf_counter() - t_h
        if agent["aborted"] or agent["moves_total"] != {
                f"game1->game3:manual": STANDBY_HANDOFF}:
            fail(f"[24] the handoff: {agent}")
        moves = sum(v for k, v in metrics.parse_prometheus_text(
            http_get(ports["g1"], "/metrics")).items()
            if k.startswith("rebalance_moves_total{"))
        lane_after = smoke_vars(
            ports["g1"], lambda v: v.get("pause_lane") == "0",
            "[24]")["pause_lane"]
        if "1" not in lanes_seen or moves != STANDBY_HANDOFF:
            fail(f"[24] pause lane seen {lanes_seen} (after: "
                 f"{lane_after}); rebalance_moves_total {moves}")
        v_end = verdict()
        if not v_end["ok"]:
            fail(f"[24] conservation after the handoff: {v_end}")
        h2 = tick_hist(ports["g1"])
        loop.run_until_complete(bots_walk(bots, STANDBY_WALK_S))
        h3 = tick_hist(ports["g1"])

        # the kill as a crash comes: game1 serving, its standby behind
        # by whatever it lags. Its tick (once its worker wrote two chain
        # records) and the standby's applied tick are read just before
        # it; the bots' mirrors just after, once what game1 sent has
        # arrived
        v1 = smoke_vars(ports["g1"], lambda v: (v.get("worker") or {})
                        .get("disk_writes", 0) >= 2, "[24]")
        applied = http_get(ports["g2"], "/standby")["game2"][
            "applied_tick"]
        g1pid = cli_pid(tmp, "game1")
        t_kill = time.time()
        os.kill(g1pid, 9)
        while pid_alive(g1pid):
            time.sleep(0.01)
        loop.run_until_complete(asyncio.sleep(1.0))
        at_kill = {b.bot_id: set(b.entities) for b in bots}
        wd_out, wd_s = step(["watchdog", "--once"], 0, "watchdog")
        if "game1: standby game2 PROMOTED" not in wd_out \
                or "restarted from" in wd_out:
            fail(f"[24] the watchdog: {wd_out[-2000:]}")
        v2 = smoke_vars(ports["g2"], lambda v: v.get("promoted_at"),
                        "[24]")
        kill_to_tick = v2["promoted_at"] - t_kill
        lag = v1["tick"] - applied
        if os.path.exists(os.path.join(tmp, "run", "game1.pid")):
            fail("[24] the dead primary keeps a pid file")
        with open(os.path.join(tmp, "run", "game1.log")) as f:
            if f.read().count("started (restore=") != 1:
                fail("[24] game1 was restarted")
        # game1's chain, written by its replication worker: the file a
        # -restore would take (the freshest by mtime) resolves; a delta
        # older than the keyframe is one a later keyframe superseded
        cands = freeze_mod.snapshot_candidates(1, tmp)
        if not cands or os.path.basename(cands[0]) not in (
                freeze_mod.chain_key_filename(1),
                freeze_mod.chain_delta_filename(1)):
            fail(f"[24] game1's snapshot files: {cands}")
        rec = freeze_mod.read_freeze_file(cands[0])
        chain = [(os.path.basename(p), "freshest, resolves"
                  if p == cands[0] else "older") for p in cands]
        if len(rec["entities"]) < monsters - STANDBY_HANDOFF:
            fail(f"[24] {cands[0]} holds {len(rec['entities'])} entities")
        with open(os.path.join(tmp, "game2_promotion.log"), "rb") as f:
            plog = f.read()
        if not plog.startswith(b"claim ") or b"\npromoted " not in plog \
                or replayed_log(plog) != plog:
            fail(f"[24] game2_promotion.log: {plog!r}")
        h4 = tick_hist(ports["g2"])
        loop.run_until_complete(bots_walk(bots, STANDBY_WALK_S))
        h5 = tick_hist(ports["g2"])
        moved = set(http_get(ports["g3"], "/audit?eids=1")["game3"]
                    .get("eids", []))
        checked, stale, stale13 = loop.run_until_complete(
            standby_mirrors(bots, ports, ["g2", "g3"], moved, at_kill))
        loop.run_until_complete(bots_leave(bots))
        bots = []
        loop.close()
        launches = {}
        for g in ("g1", "g2", "g3"):
            v = v1 if g == "g1" else smoke_vars(ports[g], None, "[24]")
            for k, n in v["launches"].items():
                launches[k] = launches.get(k, 0) + n
        _, stop_s = step(["stop"], 0, "stop")
        step(["status"], 1, "status after stop")
        alive = [p for p in pids if pid_alive(p)]
        if alive:
            fail(f"[24] processes of the deployment still alive: {alive}")
        if on_card and not (launches["sweep_fused"] > 0
                            and launches["sweep_fused"]
                            == launches["counting_sort"]):
            fail(f"[24] the deployment's games launched {launches}")
        q = {k: hist_quantiles(a, b) for k, (a, b) in
             {"g1_before": (h0, h1), "g1_after_handoff": (h2, h3),
              "g2_promoted": (h4, h5)}.items()}
        # game1's serve-loop spans from the bots' login to the kill, a
        # tick on average, the standby attached all along
        s1 = v1["spans"]
        n_sp = max(s1["ticks"] - s0["ticks"], 1)
        span_ms = {k: (v - s0["ms"].get(k, 0.0)) / n_sp
                   for k, v in s1["ms"].items()}
        tick_ms = (s1["tick_ms"] - s0["tick_ms"]) / n_sp
        spans = ", ".join(f"{k} {v:.3f}" for k, v in span_ms.items())
        power = gpu_line() if on_card else "the CPU"
        line = (
            f"[24] (b) the deployment through the ops CLI ({slots} slots, "
            f"{monsters} Monsters on game1, game2 its standby, game3 a "
            f"peer, rebalance on, chain every 1 s at keyframe 8): start "
            f"{start_s:.2f} s, the standby's verdict passed "
            f"{attach_s:.2f} s later ({sb['frames']} frames, "
            f"{sb['bytes_per_tick']} B a tick); {STANDBY_BOTS} strict "
            f"bots; the handoff of {STANDBY_HANDOFF} to game3 in "
            f"{handoff_s:.2f} s, pause lane set then clear, conservation "
            f"green in {windows} reads, rebalance_moves_total {moves:g}; "
            f"game1's chain {chain} ({len(rec['entities'])} entities) "
            f"from the worker "
            f"({v1['worker']['disk_writes']} writes, "
            f"{v1['worker']['captures_dropped']} captures dropped); kill "
            f"-9 at game1's tick {v1['tick']} with the standby at "
            f"{applied} (lag {lag} ticks against the budget of "
            f"{LAG_BUDGET_TICKS}), the promoted game from tick "
            f"{v2['promoted_tick'] - 1}; to its first tick "
            f"{kill_to_tick:.2f} s "
            f"(watchdog call {wd_s:.2f} s), no restart, the promotion log "
            f"replayed byte for byte; {checked} mirrors == the interest "
            f"sets after it, but {stale} entries of entities the handoff "
            f"moved (ROADMAP C12) and {stale13} entries the bots held at "
            f"the kill that the promoted game never sent a leave for "
            f"(C13, the lag's); game1 with its standby attached, "
            f"{n_sp} ticks from the login to the kill: {tick_ms:.3f} ms a "
            f"tick, mean span ms {spans}; the capture's share "
            f"{span_ms.get('repl_capture', 0.0) / max(tick_ms, 1e-9):.4f}"
            f"; tick_latency_ms p50/p99: "
            + ", ".join(f"{k} {p50:.2f}/{p99:.2f} ({n:.0f} ticks)"
                        for k, (n, p50, p99) in q.items())
            + f"; launches {launches}; stop {stop_s:.2f} s; (b) "
            f"{time.perf_counter() - t0:.1f} s ({power})")
        print(line, flush=True)
        return {"standby_cli": launches}
    finally:
        for b in bots:
            try:
                b._recv_task.cancel()
            except Exception:
                pass
        for p in pids:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)


def standby_phase(dev, tag: str) -> dict:
    """[24]: (a) then (b); the launches of their paths."""
    t0 = time.perf_counter()
    release_worlds()
    out = failover_part(dev, tag)
    out.update(standby_deploy_part(dev, tag))
    print(f"[24] wall {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return out



MH_PROCS = 2               # controller processes on the one card
MH_DEV = SPACES            # shards of the global mesh, 4 a controller
MH_TICKS = 8               # (a) ticks of each step
MH_MEGA_N = 1 << 20        # (a) BASELINE config 4: 2^20 in 4x2 tiles
MH_STEP_S = 300.0          # (a) the limit of one controller pair
MH_GAME_SLOTS = 1 << 17    # (b) slots a tile: [21] (c)'s grid
MH_GAME_MONSTERS = 1 << 15   # (b) cut from 2^17 to keep the run's limit
MH_GAME_BOTS = 16          # (b) strict bots, half on each controller
MH_WALK_S = 3.0

# [25] (b)'s game script: examples/multihost_demo's types ([21] (c)'s
# classes and megaspace boot, widened), run by the CLI as two
# controllers. Every tick starts with one all-gather of the PAUSE flag,
# so both controllers rest at the same tick (a controller resting alone
# would hold the other in its next collective); at rest each publishes
# the interest sets of the Avatars on its own tiles (the decode is
# owner-local) with the shard of every entity in them. Its tick count,
# launches, the group's host syncs and collective seconds, the mutation
# log's backlog gauges and the staging tripwire's counts are published
# on /vars (``smoke``) every tick.
MH_GAME = '''"""chip_smoke.py [25]'s game: the multihost demo on the card."""
import os

import torch

import goworld_tpu_torch as gw
import chip_smoke as cs
from goworld_tpu_torch import kernels
from goworld_tpu_torch.net.game import GameServer
from goworld_tpu_torch.parallel import multihost
from goworld_tpu_torch.utils import opmon

BOOT = {{}}
gw.register_entity("Account", cs.GameAccount)
gw.register_entity("Avatar", cs.GameAvatar)
gw.register_entity("Monster", cs.GameMonster)
gw.register_space("Arena", cs.GameMegaArena, megaspace=True)
gw.on_boot(lambda w: cs.mega_boot(
    w, {monsters}, {extent}, cs.SEED, BOOT, cs.mh_launches(w), "[25]"))
_tick = GameServer.tick


def interest(w):
    ents, out = w.entities, {{}}
    for e in list(ents.values()):
        if e.type_name == "Avatar" and not e.destroyed \\
                and e.client is not None and e.shard in w.local_shards:
            want = sorted({{e.id, *e.interested_in}})
            out[e.id] = [want, {{x: ents[x].shard for x in want
                                if x in ents}}]
    return out


def tick(self):
    w = self.world
    if not hasattr(w, "arena"):   # a restored World: find its Arena
        w.arena = next(s for s in w.spaces.values()
                       if s.type_name == "Arena")
        w.said = []
    before = dict(multihost.STATS)
    rest = w._mh_group.all_gather(torch.tensor(
        [os.path.exists("PAUSE")], dtype=torch.int32)).any()
    pause = w.__dict__.setdefault("pause", dict.fromkeys(before, 0))
    for k in before:   # the PAUSE gather's own share, kept apart
        pause[k] += multihost.STATS[k] - before[k]
    v = opmon.vars().get("smoke", {{}})
    if rest:
        if "interest" not in v:
            opmon.expose("smoke", dict(v, interest=interest(w)))
        return
    _tick(self)
    opmon.expose("smoke", {{
        "tick": w.tick_count, "launches": dict(kernels.LAUNCHES),
        "mh": {{k: multihost.STATS[k] - pause[k] for k in pause}},
        "pause": dict(pause), "rank": w.mh_rank,
        "boot": BOOT, "guard": [w.op_stats["spmd_guard_checks"],
                                w.op_stats["spmd_guard_divergences"]],
        "backlog": [opmon.vars().get("mh_mutation_backlog_packets"),
                    opmon.vars().get("mh_mutation_backlog_bytes")]}})


GameServer.tick = tick
gw.run({run_args})
'''


def mh_phase_launches(mc, rank: int) -> int:
    """The phase kernel's launches in one exchange of megaspace ``mc`` on
    controller ``rank`` of MH_PROCS: one a phase, and one more (its pack
    mode) a phase with legs that this controller ships to another."""
    n_loc = mc.n_dev // MH_PROCS
    place = halo.Placement(mc.n_dev, rank * n_loc, n_loc, None)
    phases = (halo.rings_2d(*mc.mesh_shape) if mc.mesh_shape
              else (halo.rings_1d(mc.n_dev),))
    return sum(1 + bool(halo.phase_legs(place, rings).n_send)
               for rings in phases)


def mh_launches(world) -> dict:
    """A game tick's launches on one controller of a megaspace World:
    one sweep and one sort a local tile, the phase kernel's launches of
    one exchange (:func:`mh_phase_launches`); nothing off the card."""
    n = len(world.local_shards) if world.device.type == "cuda" else 0
    return {"sweep_fused": n, "counting_sort": n,
            "halo_ship_phase": mh_phase_launches(world.mega, world.mh_rank)
            if n else 0, "npc_mlp": 0}


def mh_step_setup(kind: str, dev, mesh=None, mega_n: int = MH_MEGA_N,
                  space_n: int = SPACE_N):
    """(a)'s world: (state, step, inputs of tick t) of the megaspace at
    mega_config(MH_MEGA_N, MH_DEV) or of [21] (a)'s make_multi_tick
    world (its free rows and migration requests), over all MH_DEV
    shards in one process (``mesh`` None) or over this controller's on
    ``mesh``; the same numpy-seeded world either way."""
    loc = range(MH_DEV) if mesh is None else mesh.local_shards

    def cut(t):
        return t[loc.start:loc.stop]

    if kind == "mega":
        mc = mega_config(mega_n, MH_DEV)
        st, inputs = mega_world(mc, mega_n, SEED, dev)
        mine = MultiTickInputs(
            base=TickInputs(**{f.name: cut(getattr(inputs.base, f.name))
                               for f in dataclasses.fields(TickInputs)}),
            migrate_target=cut(inputs.migrate_target),
            migrate_tag=cut(inputs.migrate_tag))
        step = make_mega_tick(mc, device=dev, mesh=mesh)
        return st.apply(cut), step, lambda t: mine
    cfg = multi_config(MH_DEV, space_n)
    n = cfg.capacity
    st0, base = multi_world(cfg, MH_DEV, SEED, dev)
    rng = np.random.default_rng(SEED + 21)
    dead = np.zeros((MH_DEV, n), bool)
    for d in range(MH_DEV):
        dead[d, rng.choice(n, MESH_FULL_FREE if d == MESH_FULL else n // 8,
                           replace=False)] = True
    dead_t = torch.from_numpy(dead).to(dev)
    st = st0.replace(
        alive=st0.alive & ~dead_t, npc_moving=st0.npc_moving & ~dead_t,
        has_client=st0.has_client & ~dead_t,
        client_gate=torch.where(dead_t, -1, st0.client_gate))
    reqs = [mesh_requests(rng, n, t, dev) for t in range(MH_TICKS)]
    mine = TickInputs(**{f.name: cut(getattr(base, f.name))
                         for f in dataclasses.fields(TickInputs)})
    step = make_multi_tick(cfg, mesh if mesh is not None
                           else make_mesh(MH_DEV, device=dev))
    return (st.apply(cut), step,
            lambda t: MultiTickInputs(mine, cut(reqs[t][0]),
                                      cut(reqs[t][1])))


def tile_digests(state, outs, tiles) -> dict:
    """sha256 of every lane of ``state`` and ``outs``, tile by tile
    (``tiles`` the global indices of the leading axis)."""
    import hashlib

    got = {}
    for prefix, obj in (("state", state), ("out", outs)):
        for name, t in lanes(obj).items():
            if t is None:
                continue
            host = t.detach().cpu().numpy()
            for i, d in enumerate(tiles):
                got[f"{prefix}.{name}/{d}"] = hashlib.sha256(
                    np.ascontiguousarray(host[i]).tobytes()).hexdigest()
    return got


def mh_run_ticks(kind: str, dev, mesh=None, sizes=None) -> tuple:
    """MH_TICKS ticks of (a)'s step: per tick the digests and (host
    wall ms, event ms, host syncs, collectives, collective ms, launches
    of this process); ``sizes`` (mega entities, entities a shard) for a
    rehearsal off the card (events then read the wall)."""
    from goworld_tpu_torch.parallel import multihost

    on_card = dev.type == "cuda"
    st, step, inputs_at = mh_step_setup(kind, dev, mesh,
                                        *(sizes or (MH_MEGA_N, SPACE_N)))
    tiles = range(MH_DEV) if mesh is None else mesh.local_shards
    digests, rows = [], []
    for t in range(MH_TICKS):
        inp = inputs_at(t)
        if on_card:
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
        kernels.reset_launches()
        multihost.reset_stats()
        w0 = time.perf_counter()
        if on_card:
            a.record()
        st, out = step(st, inp)
        if on_card:
            b.record()
            torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - w0) * 1e3
        rows.append((wall, a.elapsed_time(b) if on_card else wall,
                     multihost.STATS["host_syncs"],
                     multihost.STATS["collectives"],
                     multihost.STATS["seconds"] * 1e3,
                     dict(kernels.LAUNCHES),
                     multihost.STATS["stage_seconds"] * 1e3,
                     multihost.STATS["wire_seconds"] * 1e3))
        digests.append(tile_digests(st, out, tiles))
    return digests, rows


def mh_step_child(argv: list) -> int:
    """A controller of (a): ``chip_smoke.py --mh-step KIND RANK PORT OUT
    DEVICE MEGA_N SPACE_N``; joins the group, runs its shards' ticks,
    writes its digests and times to ``OUT/rankRANK.json``."""
    from goworld_tpu_torch.parallel import multihost

    kind, rank, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    dev = torch.device(argv[4], 0) if argv[4] == "cuda" \
        else torch.device(argv[4])
    if dev.type == "cuda":
        kernels.lib()
    multihost.init_distributed(f"127.0.0.1:{port}", MH_PROCS, rank,
                               timeout=MH_STEP_S)
    mesh = multihost.global_mesh(MH_DEV, dev)
    digests, rows = mh_run_ticks(kind, dev, mesh,
                                 (int(argv[5]), int(argv[6])))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"digests": digests, "rows": rows}, f)
    multihost.shutdown()
    return 0


def mh_spawn(argv: list, out: str) -> list:
    """MH_PROCS processes of this script with ``argv`` + rank + port +
    ``out``; each one's output into ``out/logRANK``."""
    port = free_ports(["mh"])["mh"]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(MH_PROCS):
        log = open(os.path.join(out, f"log{rank}"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv[:2],
             str(rank), str(port), out, *argv[2:]], cwd=root,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def mh_wait(procs: list, out: str, limit: float, label: str) -> None:
    """Wait for the controllers; one that fails or outlives ``limit``
    fails the run (every process killed, every log printed)."""
    t_end = time.perf_counter() + limit
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > t_end or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        logs = ""
        for r in range(len(procs)):
            with open(os.path.join(out, f"log{r}"), errors="replace") as f:
                logs += f"== rank {r}\n{f.read()[-4000:]}\n"
        fail(f"{label} a controller exited "
             f"{[p.returncode for p in procs]}:\n{logs}")


def mh_afar_parity(dev) -> str:
    """The phase kernel's path for legs that cross processes, held
    against its plain version on the card at (a)'s megaspace shape, in
    one process as the group would run it: rank 0's tiles of the 4x2
    megaspace pack their x phase's crossing legs (the pack mode, one
    launch) as :func:`halo.pack_legs_plain` (``_strip_words``) does, and
    rank 1's tiles (tile0 4) ship the phase reading those words as the
    received block; every word and every ghost word equal."""
    mc = mega_config(MH_MEGA_N, MH_DEV)
    st, _ = mega_world(mc, MH_MEGA_N, SEED, dev)
    n, h = mc.cfg.capacity, mc.halo_cap
    tx, tz = mc.shape
    d = torch.arange(MH_DEV, dtype=torch.int32, device=dev)
    ix = d // tz
    r = float(mc.cfg.grid.radius)
    tmin = ix.to(torch.float32) * float(mc.tile_w)
    x = st.pos[..., 0]
    east = st.alive & (x >= (tmin + float(mc.tile_w) - r)[:, None])
    west = st.alive & (x < (tmin + r)[:, None])
    from goworld_tpu_torch.ops.extract import bounded_extract_batched

    ef, _, ed = bounded_extract_batched(east, h)
    wf, _, wd = bounded_extract_batched(west, h)
    gid = d[:, None] * n + torch.arange(n, dtype=torch.int32,
                                        device=dev)[None, :]
    src = (st.pos, st.yaw, st.dirty, gid)
    rings = halo.rings_2d(tx, tz)[0]
    n_loc = MH_DEV // MH_PROCS
    places = [halo.Placement(MH_DEV, k * n_loc, n_loc, None)
              for k in range(MH_PROCS)]
    legs = [halo.phase_legs(pl, rings) for pl in places]

    def held(k):
        loc = slice(k * n_loc, (k + 1) * n_loc)
        return (tuple(t[loc].contiguous() for t in src),
                tuple((ring, f[loc].contiguous(), c[loc].contiguous())
                      for ring, f, c in zip(rings, (ef, wf), (ed, wd))))

    src0, strips0 = held(0)
    kernels.reset_launches()
    words = halo.pack_legs(src0, strips0, legs[0].send_slots,
                           legs[0].n_send)
    packs = kernels.LAUNCHES["halo_ship_phase"]
    plain = halo.pack_legs_plain(src0, strips0, legs[0].send_slots,
                                 legs[0].n_send)
    (q, a, b), = legs[0].send_split
    if q != 1 or legs[1].recv_rows != ((0, b - a),):
        fail(f"[25] the x phase's legs do not pair up: {legs}")
    src1, strips1 = held(1)
    afar = tuple((words[a:b], t) for t in legs[1].recv_slots)
    outs = [halo._empty_ghosts(n_loc, 4 * h, dev) for _ in range(2)]
    for o in outs:
        for t in o:
            t.zero_()
    kernels.reset_launches()
    halo.ship_phase(src1, strips1, outs[0], 0, places[1], afar)
    launched = kernels.LAUNCHES["halo_ship_phase"]
    halo.ship_phase_plain(src1, strips1, outs[1], 0, places[1], afar)
    torch.cuda.synchronize(dev)
    bad_words = int(diff_count(words, plain))
    bad = sum(int(diff_count(x, y)) for x, y in zip(*outs))
    one = int(dev.type == "cuda")   # a launch on the card
    if bad_words or bad or packs != one or launched != one:
        fail(f"[25] the phase kernel's legs across processes differ from "
             f"its plain version: {bad_words} sent words, {bad} ghost "
             f"words ({packs} pack and {launched} phase launches)")
    return (f"the phase kernel's legs across processes at halo_cap {h}: "
            f"rank 0's pack of its {b - a} crossing strips (one launch) == "
            f"the plain gather and pack in every word, and rank 1's phase "
            f"reading them == its plain version in every ghost word")


def mh_steps_part(dev, tag, sizes=(MH_MEGA_N, SPACE_N)) -> tuple:
    """[25] (a): the two-controller megaspace and make_multi_tick, each
    bit for bit against the one-process step on the card, tile by tile
    and tick by tick; their times. ``sizes`` (mega entities, entities a
    shard) smaller for a rehearsal off the card."""
    texts, launches = [], {}
    for kind in ("mega", "multi"):
        ref, ref_rows = mh_run_ticks(kind, dev, None, sizes)
        release_worlds()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = tempfile.mkdtemp(prefix=f"mh_{kind}_")
        try:
            mh_wait(mh_spawn(["--mh-step", kind, dev.type, *map(str, sizes)],
                             out), out, MH_STEP_S, f"[25] (a) {kind}")
            got = []
            for r in range(MH_PROCS):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    got.append(json.load(f))
        finally:
            shutil.rmtree(out, ignore_errors=True)
        for t in range(MH_TICKS):
            mine = {**got[0]["digests"][t], **got[1]["digests"][t]}
            if mine.keys() != ref[t].keys():
                fail(f"[25] {kind} tick {t + 1}: lanes "
                     f"{sorted(mine.keys() ^ ref[t].keys())[:6]}")
            bad = sorted(k for k in mine if mine[k] != ref[t][k])
            if bad:
                fail(f"[25] {kind} tick {t + 1}: two controllers != one "
                     f"process in {len(bad)} lane tiles: {bad[:6]}")
        per = []
        for r in range(MH_PROCS):
            rows = got[r]["rows"][1:]
            wall = np.array([x[0] for x in rows])
            evs = np.array([x[1] for x in rows])
            per.append(
                f"rank {r}: wall p50 {np.percentile(wall, 50):.3f} p99 "
                f"{np.percentile(wall, 99):.3f}, events p50 "
                f"{np.percentile(evs, 50):.3f} p99 "
                f"{np.percentile(evs, 99):.3f} ms, cross-process legs "
                f"{np.mean([x[4] for x in rows]):.3f} ms (staging "
                f"{np.mean([x[6] for x in rows]):.3f}, gloo "
                f"{np.mean([x[7] for x in rows]):.3f}) in "
                f"{np.mean([x[3] for x in rows]):g} collectives, "
                f"{np.mean([x[2] for x in rows]):g} host syncs a tick, "
                f"launches a tick {rows[0][5]}")
            for k, v in rows[0][5].items():
                launches[f"mh_{kind}_rank{r}"] = launches.get(
                    f"mh_{kind}_rank{r}", {})
                launches[f"mh_{kind}_rank{r}"][k] = sum(
                    x[5][k] for x in got[r]["rows"])
        one = np.array([x[0] for x in ref_rows[1:]])
        texts.append(
            f"{kind} ("
            + (f"mega_config({sizes[0]}, {MH_DEV}): 4x2 tiles of "
               f"{mega_config(sizes[0], MH_DEV).cfg.capacity} slots, halo "
               f"async" if kind == "mega" else
               f"[21] (a)'s {MH_DEV} x {sizes[1]}, migration requests")
            + "): "
            f"{MH_TICKS} ticks, every lane of every tile bit-equal to the "
            f"one-process step; " + "; ".join(per)
            + f"; one process wall p50 {np.percentile(one, 50):.3f} ms")
    return launches, "(a) " + " | ".join(texts)


def mh_ini(ports: dict, extent: float, mc, slots: int) -> str:
    """The multihost demo's ini (one dispatcher, one gate, game1 of
    mesh_devices 8 over mesh_processes 2, a 4x2 megaspace with a
    periodic checkpoint) widened to [21] (c)'s grid; the overload plane
    off, as [22]; a debug HTTP port on the game (rank r serves it at
    port + r) and the gate."""
    tx, tz = MEGA_GAME_SHAPE
    return (f"[deployment]\ndispatchers = 1\ngames = 1\ngates = 1\n\n"
            f"[dispatcher1]\nhost = 127.0.0.1\nport = {ports['d1']}\n\n"
            f"[game1]\nboot_entity = Account\ncapacity = {slots}\n"
            f"mesh_devices = {MH_DEV}\nmesh_processes = {MH_PROCS}\n"
            f"checkpoint_interval = 30\nmegaspace = true\n"
            f"mega_shape = {tx}x{tz}\nextent_x = {extent}\n"
            f"extent_z = {extent}\naoi_radius = {mc.cfg.grid.radius}\n"
            f"aoi_k = {mc.cfg.grid.k}\naoi_cell_cap = {mc.cfg.grid.cell_cap}"
            f"\naoi_sweep_impl = fused\naoi_sort_impl = pallas\n"
            f"halo_impl = async\nhalo_cap = {mc.halo_cap}\n"
            f"migrate_cap = {mc.migrate_cap}\n"
            "position_sync_interval_ms = 50\noverload = false\n"
            f"http_port = {ports['hg']}\n\n"
            f"[gate1]\nhost = 127.0.0.1\nport = {ports['tcp']}\n"
            f"http_port = {ports['ht']}\n\n[storage]\nkind = filesystem\n"
            "directory = entity_storage\n\n[kvdb]\nkind = filesystem\n"
            "path = kvdb_data\n")


def mh_spots(tile_w: float, tile_d: float) -> list:
    """(b)'s bots: MH_GAME_BOTS along the column 1-2 border (the process
    boundary, x = 2 tile_w), half 3 units west of it heading east (rank
    0's tiles), half 3 units east heading west (rank 1's)."""
    half = MH_GAME_BOTS // 2
    zs = [(i + 0.5) * 2 * tile_d / half for i in range(half)]
    x = 2 * tile_w
    return ([(x - 3.0, z, 1, 0) for z in zs]
            + [(x + 3.0, z, -1, 0) for z in zs])


async def mh_round(ports: dict, spots: list, first_id: int,
                   label: str, marks: dict) -> dict:
    """One round of (b): the bots log in at their spots, cross the
    process boundary for MH_WALK_S, each controller's tick histogram
    and published counts are read into ``marks`` ("h1", "v1"), then the
    game rests and every mirror is read against its Avatar's interest
    set (each controller publishes its own tiles' Avatars); the bots
    leave."""
    from goworld_tpu_torch.net.botclient import BotClient

    loop = asyncio.get_running_loop()
    bots = [BotClient("127.0.0.1", ports["tcp"], bot_id=first_id + i,
                      strict=True, seed=SEED + first_id + i)
            for i in range(MH_GAME_BOTS)]
    login_s = await bots_login(bots, [(x, z) for x, z, _, _ in spots])
    if not all(b.player is not None and b.player.type_name == "Avatar"
               for b in bots):
        fail(f"[25] {label}: a login reached no Avatar")
    await bots_cross(bots, spots, MH_WALK_S, 0.5)
    marks["h1"] = [await loop.run_in_executor(None, tick_hist,
                                              ports["hg"] + r)
                   for r in range(MH_PROCS)]
    marks["v1"] = [await loop.run_in_executor(None, smoke_vars,
                                              ports["hg"] + r, None, "[25]")
                   for r in range(MH_PROCS)]
    rest = os.path.join(ports["dir"], "PAUSE")
    open(rest, "w").close()
    try:
        views = [await loop.run_in_executor(
            None, smoke_vars, ports["hg"] + r, lambda v: "interest" in v,
            "[25]") for r in range(MH_PROCS)]
        await asyncio.sleep(1.0)
    finally:
        os.unlink(rest)
    errors = [e for b in bots for e in b.errors]
    if errors:
        fail(f"[25] {label}: strict mirrors report {len(errors)} errors "
             f"(a client message twice, or one missing): {errors[:4]}")
    interest, shard_of = {}, {}
    for r, v in enumerate(views):
        for eid, (want, shards) in v["interest"].items():
            if eid in interest:
                fail(f"[25] {label}: Avatar {eid} published by both "
                     "controllers")
            interest[eid] = (r, want)
            shard_of.update(shards)
    mism, far, ranks = [], 0, []
    for b in bots:
        eid = b.player.eid
        if eid not in interest:
            fail(f"[25] {label}: bot{b.bot_id}'s Avatar is on no "
                 "controller's tiles")
        r, want = interest[eid]
        ranks.append(r)
        if set(b.entities) != set(want):
            extra = sorted(set(b.entities) - set(want))
            gone = sorted(set(want) - set(b.entities))
            mism.append((b.bot_id, r, b.player.pos,
                         [(x, b.entities[x].type_name, shard_of.get(x))
                          for x in extra[:2]],
                         [(x, shard_of.get(x)) for x in gone[:2]]))
        # an entity on rank 1's tiles in the mirror of a bot served by
        # rank 0, or the other way round: the process boundary crossed
        far += sum(1 for x in b.entities
                   if shard_of.get(x, -1) // (MH_DEV // MH_PROCS) != r)
    if mism:
        fail(f"[25] {label}: bot mirrors differ from the interest sets: "
             f"(bot, its controller, its pos, [(in the mirror alone, type, "
             f"shard)], [(in the interest set alone, shard)]) {mism[:8]}")
    if far < 1 or len(set(ranks)) != MH_PROCS:
        fail(f"[25] {label}: {far} entities across the process boundary "
             f"in the mirrors; Avatars by rank {ranks}")
    await bots_leave(bots)
    return dict(login_s=login_s, far=far,
                by_rank=[ranks.count(r) for r in range(MH_PROCS)],
                seen=sum(len(b.entities) for b in bots))


def mh_cli_part(dev, tag, slots: int = MH_GAME_SLOTS,
                monsters: int = MH_GAME_MONSTERS) -> tuple[dict, str]:
    """[25] (b): examples/multihost_demo's deployment through the CLI
    on the card, two controllers; see the module docstring."""
    on_card = dev.type == "cuda"
    tx, tz = MEGA_GAME_SHAPE
    mc = mega_config(MH_DEV * slots, MH_DEV)
    extent = float(int((MH_DEV * slots * 10000 / 12) ** 0.5))
    tile_w, tile_d = extent / tx, extent / tz
    tmp = tempfile.mkdtemp(prefix="mh_deploy_")
    ports = free_ports(["d1", "hg", "hg1", "ht", "tcp"])
    ports["dir"] = tmp
    pids: set = set()

    def step(args, want_rc: int, what: str) -> tuple[str, float]:
        return cli_step(tmp, pids, "[25]", args, want_rc, what)

    try:
        with open(os.path.join(tmp, "goworld_tpu.ini"), "w") as f:
            f.write(mh_ini(ports, extent, mc, slots))
        with open(os.path.join(tmp, "server_torch.py"), "w") as f:
            f.write(MH_GAME.format(
                monsters=monsters, extent=extent,
                run_args="" if on_card else 'device="cpu"'))
        _, start_s = step(["start"], 0, "start")
        boots = [smoke_vars(ports["hg"] + r, lambda v: "tick" in v,
                            "[25]") for r in range(MH_PROCS)]
        where = f"on {dev}"
        for r in range(MH_PROCS):
            with open(os.path.join(tmp, "run", f"game1c{r}.log")) as f:
                if f"started (restore=False) {where}" not in f.read():
                    fail(f"[25] rank {r} did not start {where}")
        spots = mh_spots(tile_w, tile_d)
        rounds = []
        for rnd in range(2):
            v0 = [smoke_vars(ports["hg"] + r, lambda v: "tick" in v
                             and "interest" not in v, "[25]")
                  for r in range(MH_PROCS)]
            h0 = [tick_hist(ports["hg"] + r) for r in range(MH_PROCS)]
            marks = {}
            got = asyncio.run(mh_round(ports, spots, rnd * MH_GAME_BOTS,
                                       f"round {rnd + 1}", marks))
            h1, v1 = marks["h1"], marks["v1"]
            got["hist"] = [hist_quantiles(a, b) for a, b in zip(h0, h1)]
            # each rank's counts between its own two reads (the ranks
            # tick in lockstep; the reads of one rank and the other
            # may fall a tick apart)
            got["ticks"] = [v1[r]["tick"] - v0[r]["tick"]
                            for r in range(MH_PROCS)]
            got["launches"] = [{k: v1[r]["launches"][k]
                                - v0[r]["launches"][k]
                                for k in v0[r]["launches"]}
                               for r in range(MH_PROCS)]
            got["syncs"] = [(v1[r]["mh"]["host_syncs"]
                             - v0[r]["mh"]["host_syncs"]) / got["ticks"][r]
                            for r in range(MH_PROCS)]
            for key, name in (("legs_ms", "seconds"),
                              ("stage_ms", "stage_seconds"),
                              ("wire_ms", "wire_seconds")):
                got[key] = [(v1[r]["mh"][name] - v0[r]["mh"][name]) * 1e3
                            / got["ticks"][r] for r in range(MH_PROCS)]
            got["pause_ms"] = [(v1[r]["pause"]["seconds"]
                                - v0[r]["pause"]["seconds"]) * 1e3
                               / got["ticks"][r] for r in range(MH_PROCS)]
            got["backlog"] = [v1[r]["backlog"] for r in range(MH_PROCS)]
            for r in range(MH_PROCS):
                n_k = got["ticks"][r] if on_card else 0
                if got["launches"][r] != {
                        "sweep_fused": 4 * n_k, "counting_sort": 4 * n_k,
                        "halo_ship_phase": mh_phase_launches(mc, r) * n_k,
                        "npc_mlp": 0} \
                        or got["ticks"][r] < 1:
                    fail(f"[25] round {rnd + 1}: rank {r}'s "
                         f"{got['ticks'][r]} game ticks launched "
                         f"{got['launches'][r]}")
            for r in range(MH_PROCS):
                checks, div = v1[r]["guard"]
                if checks < 1 or div:
                    fail(f"[25] rank {r}: the staging tripwire ran "
                         f"{checks} times and saw {div} divergences")
            rounds.append(got)
            if rnd == 0:
                old = [cli_pid(tmp, f"game1c{r}") for r in range(MH_PROCS)]
                t0 = time.perf_counter()
                proc = start_cli(["reload", tmp])
                while any(pid_alive(p) for p in old) \
                        and proc.poll() is None:
                    time.sleep(0.02)
                freeze_s = time.perf_counter() - t0
                out, _ = proc.communicate(timeout=DEPLOY_CLI_S)
                restore_s = time.perf_counter() - t0 - freeze_s
                if proc.returncode != 0 or "game1: reloaded" not in out:
                    fail(f"[25] reload exited {proc.returncode}:\n"
                         f"{out[-3000:]}")
                for r in range(MH_PROCS):
                    pids.add(cli_pid(tmp, f"game1c{r}"))
                    with open(os.path.join(tmp, "run",
                                           f"game1c{r}.log")) as f:
                        if f"started (restore=True) {where}" not in \
                                f.read():
                            fail(f"[25] rank {r} did not restore {where}")
        logs = ""
        for r in range(MH_PROCS):
            with open(os.path.join(tmp, "run", f"game1c{r}.log")) as f:
                logs += f.read()
        if "SPMD staging divergence" in logs or "Traceback" in logs:
            fail(f"[25] a controller logged a divergence or a traceback:"
                 f"\n{logs[-3000:]}")
        _, stop_s = step(["stop"], 0, "stop")
        step(["status"], 1, "status after stop")
        alive = [p for p in pids if pid_alive(p)]
        if alive:
            fail(f"[25] processes of the deployment still alive: {alive}")
        boot = boots[0]["boot"]
        text = (f"(b) examples/multihost_demo through the CLI (2 "
                f"controllers x 4 tiles of {slots} slots, 4x2, world "
                f"{extent:.0f}^2, radius {mc.cfg.grid.radius}, fused/pallas,"
                f" halo async, halo_cap {mc.halo_cap}): start {start_s:.2f}"
                f" s, boot of {boot['monsters']} Monsters in "
                f"{boot['seconds']:.2f} s over {boot['ticks']} ticks; "
                f"reload: freeze {freeze_s:.2f} s, restore {restore_s:.2f}"
                f" s; stop {stop_s:.2f} s, no process left")
        for i, got in enumerate(rounds):
            text += (f"; round {i + 1}: {MH_GAME_BOTS} strict bots login "
                     f"{got['login_s']:.2f} s, Avatars by rank "
                     f"{got['by_rank']}, game ticks by rank "
                     f"{got['ticks']}, tick p50/p99 by rank "
                     + ", ".join(f"{p50:.2f}/{p99:.2f}"
                                 for _, p50, p99 in got["hist"])
                     + f" ms, the game's cross-process legs a tick "
                     + ", ".join(f"{x:.2f} (staging {y:.2f}, gloo {z:.2f})"
                                 for x, y, z in zip(got["legs_ms"],
                                                    got["stage_ms"],
                                                    got["wire_ms"]))
                     + " ms, the smoke's own PAUSE gather apart "
                     + ", ".join(f"{x:.2f}" for x in got["pause_ms"])
                     + " ms, host syncs a tick "
                     + ", ".join(f"{x:.2f}" for x in got["syncs"])
                     + f", mh_mutation_backlog (packets, bytes) "
                     f"{got['backlog']}; mirrors == interest sets, "
                     f"{got['far']} entities across the process boundary "
                     f"in them, 0 strict errors")
        launches = {k: sum(got["launches"][r][k] for got in rounds
                           for r in range(MH_PROCS))
                    for k in rounds[0]["launches"][0]}
        return {"mh_deployment": launches}, text
    finally:
        for p in pids:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)


def multihost_phase(dev, tag) -> dict:
    """[25]: the game of two controllers on the card (see the module
    docstring). Returns the launches of its paths."""
    from goworld_tpu_torch.parallel import multihost

    phase0 = time.perf_counter()
    release_worlds()
    torch.cuda.empty_cache()
    parity = mh_afar_parity(dev)
    release_worlds()
    launches, a_text = mh_steps_part(dev, tag)
    b_launches, b_text = mh_cli_part(dev, tag)
    launches.update(b_launches)
    multihost.reset_stats()
    print(f"[25] two controllers on the card: {parity}; {a_text} {tag}",
          flush=True)
    print(f"[25] {b_text} {tag}", flush=True)
    print(f"[25] wall {time.perf_counter() - phase0:.1f} s {tag}",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    print(f"[1] gpu: {card}", flush=True)
    tag = f"({card})"
    walls, t_mark = {}, [time.perf_counter()]

    def phase_done(phase: str) -> None:
        now = time.perf_counter()
        walls[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    path, secs, log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2] build: {path.name} in {secs:.1f} s; ptxas: "
          f"{' | '.join(regs[:6])}", flush=True)
    phase_done("[1]-[2]")

    cfg = slice_config(N)
    g = cfg.grid
    st0, inputs = bench_world(cfg, SEED, dev)
    flag_bits = st0.has_client.to(torch.int32) << 1
    fh = aoi.front_half(g, st0.pos, st0.alive, None, st0.aoi_radius,
                        flag_bits, with_stats=True)

    # [3] sort parity: bench keys, then skewed keys with a heavy dump bin
    rng = np.random.default_rng(SEED + 7)
    skew = rng.integers(0, 64, N).astype(np.int32) * (fh.n_rows // 64)
    skew[rng.random(N) < 0.3] = fh.n_rows
    cases = {"bench": fh.srow,
             "skewed": torch.tensor(skew, device=dev)}
    for name, keys in cases.items():
        o_k, s_k = counting_sort_cells_cuda(keys, fh.n_rows)
        o_p, s_p = counting_sort_cells(keys, fh.n_rows)
        o_a = torch.argsort(keys, stable=True).to(torch.int32)
        torch.cuda.synchronize()
        if not (same(o_k, o_p) and same(s_k, s_p) and same(o_k, o_a)
                and same(s_k, keys[o_a.long()])):
            fail(f"counting sort differs from its plain version ({name})")
    # tail tiles, a single key, the megaspace tile's key count, and key
    # widths of 1, 19, 21 and 31 bits
    shapes = []
    for n, n_rows in ((1, 1), (4095, fh.n_rows), (4097, 1),
                      (311_296, fh.n_rows), (N, (1 << 21) - 3),
                      (N, 2**31 - 2)):
        keys = torch.tensor(rng.integers(0, n_rows + 1, n).astype(np.int32),
                            device=dev)
        o_k, s_k = counting_sort_cells_cuda(keys, n_rows)
        o_a = torch.argsort(keys, stable=True).to(torch.int32)
        ok = same(o_k, o_a) and same(s_k, keys[o_a.long()])
        if n_rows < 1 << 24:  # the plain version's n_rows + 1 tables fit
            o_p, s_p = counting_sort_cells(keys, n_rows)
            ok = ok and same(o_k, o_p) and same(s_k, s_p)
        torch.cuda.synchronize()
        if not ok:
            fail(f"counting sort differs from a stable argsort at n={n}, "
                 f"n_rows={n_rows}")
        shapes.append(f"{n}x{n_rows.bit_length()}b"
                      f"{radix_plan(n_rows.bit_length())}")
    phase_done("[3]")
    print(f"[3] sort parity: bit-exact at n={N}, n_rows={fh.n_rows} "
          f"(bench and skewed keys, plan (passes, digit bits) "
          f"{radix_plan(fh.n_rows.bit_length())}); against a stable "
          f"argsort at n x key bits (plan) {', '.join(shapes)}", flush=True)

    # [4] sweep parity at the slice shape, then the whole sweep
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st0.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    top_k, dem_k = aoi.sweep_fused_cuda(*args)
    top_p, dem_p = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    torch.cuda.synchronize()
    if not visits_every_row(fh):
        fail("the sorted slot ids are not a permutation of the rows")
    if not (same(top_k, top_p) and same(dem_k, dem_p)):
        bad = int((top_k != top_p).any(1).sum())
        fail(f"fused sweep differs from its plain version in {bad} rows")
    variants = []
    for k, cc, flagged in ((8, 12, True), (64, 12, True), (32, 3, True),
                           (32, 4, True), (32, 28, True), (32, 12, False)):
        gv = dataclasses.replace(g, k=k, cell_cap=cc)
        fv = aoi.front_half(gv, st0.pos, st0.alive, None, st0.aoi_radius,
                            flag_bits if flagged else None, with_stats=True)
        av = (fv.s_xz, fv.s_w, fv.lo, fv.hi, st0.pos, fv.reach, k, cc,
              fv.code, True)
        if not visits_every_row(fv) or not all(same(x, y) for x, y in zip(
                aoi.sweep_fused_cuda(*av),
                aoi.sweep_fused_plain(*av, row_block=g.row_block))):
            fail(f"fused sweep differs from its plain version at k={k}, "
                 f"cell_cap={cc}, id_shift={fv.code[0]}")
        variants.append(f"k{k}/cc{cc}/shift{fv.code[0]}")
    # a clustered world: ~10 entities a cell, so most rows have more valid
    # candidates than a warp has lanes and take the overflow rounds
    cn, cext = 1 << 18, 8100.0
    crng = np.random.default_rng(SEED + 13)
    cpos = np.zeros((cn, 3), np.float32)
    cpos[:, 0] = crng.uniform(0, cext, cn)
    cpos[:, 2] = crng.uniform(0, cext, cn)
    cpos = torch.tensor(cpos, device=dev)
    calive = torch.tensor(crng.random(cn) < 0.95, device=dev)
    cflags = torch.tensor(crng.integers(0, 4, cn).astype(np.int32),
                          device=dev)
    over = []
    for k, cc in ((32, 28), (64, 12)):
        cg = dataclasses.replace(g, extent_x=cext, extent_z=cext, k=k,
                                 cell_cap=cc)
        fc = aoi.front_half(cg, cpos, calive, None, None, cflags,
                            with_stats=True)
        ac = (fc.s_xz, fc.s_w, fc.lo, fc.hi, cpos, fc.reach, k, cc, fc.code,
              True)
        top_k, dem_k = aoi.sweep_fused_cuda(*ac)
        top_p, dem_p = aoi.sweep_fused_plain(*ac, row_block=g.row_block)
        share = float((dem_p > 32).float().mean())
        if not (visits_every_row(fc) and same(top_k, top_p)
                and same(dem_k, dem_p)):
            fail(f"fused sweep differs from its plain version on the "
                 f"clustered world (k={k}, cell_cap={cc})")
        if share <= 0.1:
            fail(f"the clustered world has only {share:.3f} of rows with "
                 f"demand > 32")
        over.append(f"k{k}/cc{cc}: {share:.3f} of rows over 32")
    flag_bits = (torch.rand(N, generator=torch.Generator(device=dev)
                            .manual_seed(3), device=dev) < 0.5)\
        .to(torch.int32) | (st0.has_client.to(torch.int32) << 1)
    for topk in ("sort", "exact", "f32"):
        outs = {}
        for sweep, sort in (("fused", "pallas"), ("ranges", "argsort")):
            spec = dataclasses.replace(g, sweep_impl=sweep, sort_impl=sort,
                                       topk_impl=topk)
            outs[sweep] = grid_neighbors_flags(
                spec, st0.pos, st0.alive, watch_radius=st0.aoi_radius,
                flag_bits=flag_bits, with_stats=True)
        a, b = outs["fused"], outs["ranges"]
        if not (all(same(x, y) for x, y in zip(a[:3], b[:3]))
                and all(same(x, y) for x, y in zip(a[3], b[3]))):
            fail(f"grid_neighbors_flags fused+pallas != ranges+argsort "
                 f"({topk})")
    small = slice_config(4096).grid
    srng = np.random.default_rng(SEED + 11)
    spos = np.zeros((4096, 3), np.float32)
    spos[:, 0] = srng.uniform(0, small.extent_x, 4096)
    spos[:, 2] = srng.uniform(0, small.extent_z, 4096)
    salive = srng.random(4096) < 0.9
    snbr, scnt, _, sstats = grid_neighbors_flags(
        small, torch.tensor(spos, device=dev),
        torch.tensor(salive, device=dev),
        flag_bits=torch.zeros(4096, dtype=torch.int32, device=dev),
        with_stats=True)
    if int(sstats[1]) or int(sstats[3]):
        fail("small oracle world overflowed its caps")
    oracle = aoi.neighbors_oracle(spos, salive, small.radius)
    snbr = snbr.cpu().numpy()
    got = [set(r[r < 4096].tolist()) for r in snbr]
    if got != oracle:
        fail("fused sweep disagrees with the brute-force oracle")
    print(f"[4] sweep parity: kernel == plain at n={N} (keys, demand), "
          f"also at {', '.join(variants)}; on a clustered world of {cn} "
          f"({'; '.join(over)}); fused+pallas == ranges+argsort for "
          f"sort/exact/f32; oracle exact at n=4096", flush=True)

    phase_done("[4]")

    # [5] the main path
    tick = make_tick(cfg, device=dev)
    st = st0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS)]
    gauges = []
    snapshot = None
    # two untimed ticks in which any op that makes the host wait on the
    # card raises (the debug mode slows the host, so the timed run below
    # goes without it)
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(2):
        tick(st0, inputs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    kernels.reset_launches()
    wall0 = time.perf_counter()
    for t in range(TICKS):
        if t == TICKS // 2:
            snapshot = st
        starts[t].record()
        st, out = tick(st, inputs)
        ends[t].record()
        gauges.append(torch.stack([
            out.enter_n, out.leave_n, out.sync_n, out.attr_n,
            out.delta_rows_n, out.aoi_demand_max, out.aoi_over_k_rows,
            out.aoi_cell_max, out.aoi_over_cap_cells]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = dict(kernels.LAUNCHES)
    if launches != {"sweep_fused": TICKS, "counting_sort": TICKS,
                    "halo_ship_phase": 0, "npc_mlp": 0}:
        fail(f"single-Space path launches {launches} in {TICKS} ticks")
    gv = torch.stack(gauges).cpu().numpy()
    if gv[0, 0] <= 0:
        fail("no enter events on tick 1")
    if (gv[:, 2] <= 0).any():
        fail("a tick produced no sync records")
    for lane in (st.pos, st.vel):
        if not torch.isfinite(lane).all():
            fail("non-finite positions or velocities")
    ms = np.array([a.elapsed_time(b) for a, b in zip(starts, ends)])
    steady = ms[1:]
    p50, p99 = float(np.percentile(steady, 50)), float(
        np.percentile(steady, 99))
    rate = N / (p50 / 1e3)

    # one tick again on the kernels' plain versions, same input state
    st_k, out_k = tick(snapshot, inputs)
    plain_cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, sweep_impl="ranges", sort_impl="counting"))
    st_p, out_p = make_tick(plain_cfg, device=dev)(snapshot, inputs)
    for what, a, b in (("state", st_k, st_p), ("output", out_k, out_p)):
        la, lb = lanes(a), lanes(b)
        for name in la:
            if not same_bits(la[name], lb[name]):
                fail(f"{what} lane {name}: kernels != plain versions")
    print(f"[5] single-Space path: {TICKS} ticks of {N} entities, launches "
          f"{launches}; tick 1 enter_n={int(gv[0, 0])} "
          f"leave_n={int(gv[0, 1])} sync_n={int(gv[0, 2])}; last tick "
          f"sync_n={int(gv[-1, 2])} delta_rows_n={int(gv[-1, 4])}; "
          f"overflow gauges max over run: demand_max={int(gv[:, 5].max())}"
          f" over_k_rows={int(gv[:, 6].max())} cell_max="
          f"{int(gv[:, 7].max())} over_cap_cells={int(gv[:, 8].max())}; "
          f"tick {TICKS // 2 + 1} bit-identical on plain versions; "
          f"ms/tick p50={p50:.3f} p99={p99:.3f} (ticks 2-{TICKS}, CUDA "
          f"events) wall {wall * 1e3 / TICKS:.3f} ms/tick; "
          f"{rate:.4g} entity-ticks/s {tag}", flush=True)

    phase_done("[5]")

    # [6] kernel times at the main path's shapes (state after the run)
    flag_bits = (st.dirty.to(torch.int32)
                 | (st.has_client.to(torch.int32) << 1))
    fh = aoi.front_half(g, st.pos, st.alive, None, st.aoi_radius,
                        flag_bits, with_stats=True)
    args = (fh.s_xz, fh.s_w, fh.lo, fh.hi, st.pos, fh.reach, g.k,
            g.cell_cap, fh.code, True)
    if not visits_every_row(fh):
        fail("the sorted slot ids are not a permutation of the rows")
    k_top, k_dem = aoi.sweep_fused_cuda(*args)
    p_top, p_dem = aoi.sweep_fused_plain(*args, row_block=g.row_block)
    sweep_err = int((k_top.long() - p_top.long()).abs().max()) + int(
        (k_dem - p_dem).abs().max())
    sweep_ms = time_ms(lambda: aoi.sweep_fused_cuda(*args), 20)
    sweep_plain = time_ms(
        lambda: aoi.sweep_fused_plain(*args, row_block=g.row_block), 3, 1)
    n_lanes = 9 * g.cell_cap
    sweep_bytes, sweep_ops, cand = sweep_work(fh, p_dem, g.k, g.cell_cap)
    # the count of earlier bounds, kept beside it so that times before
    # and after the kernel's redesign read against one yardstick: every
    # lane of the 3x3 window, and 2 per lane per selection round
    # (min(demand, k) + 1 rounds a row)
    rounds = int((torch.clamp_max(p_dem, g.k) + 1).sum())
    window_ops = 14 * n_lanes * N + 2 * n_lanes * rounds
    window_bms, _ = bound(sweep_bytes, window_ops)
    o_k, s_k = counting_sort_cells_cuda(fh.srow, fh.n_rows)
    o_p, s_p = counting_sort_cells(fh.srow, fh.n_rows)
    sort_err = int((o_k - o_p).abs().max()) + int((s_k - s_p).abs().max())
    sort_ms = time_ms(
        lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows), 20)
    sort_plain = time_ms(
        lambda: counting_sort_cells(fh.srow, fh.n_rows), 3, 1)
    sort_lib = time_ms(lambda: torch.argsort(fh.srow, stable=True), 20)
    plan = radix_plan(max(1, fh.n_rows.bit_length()))
    # read by torch.profiler after the megaspace path (see device_times)
    profiled = {
        "sweep_fused_cuda": lambda: aoi.sweep_fused_cuda(*args),
        "counting_sort_cells_cuda":
            lambda: counting_sort_cells_cuda(fh.srow, fh.n_rows),
        "torch.argsort": lambda: torch.argsort(fh.srow, stable=True),
        # the whole single-Space tick, beside [15]'s batched tick
        f"tick, one Space of {N}": lambda s=st: tick(s, inputs)}
    sort_bytes = 12 * N
    sort_ops = plan[0] * 12 * N  # digit extract, histogram, rank, scatter

    rows = []
    for name, src, rep, err, kms, pms, lms, nb, no in (
            ("sweep_fused_cuda", "goworld_tpu_torch/csrc/aoi_fused.cu",
             "goworld_tpu/ops/aoi.py:919", sweep_err, sweep_ms,
             sweep_plain, None, sweep_bytes, sweep_ops),
            ("counting_sort_cells_cuda",
             "goworld_tpu_torch/csrc/counting_sort.cu",
             "goworld_tpu/ops/sort.py:157", sort_err, sort_ms,
             sort_plain, sort_lib, sort_bytes, sort_ops)):
        bms, by = bound(nb, no)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["sweep_fused" if "sweep" in name
                                 else "counting_sort"],
            "max_abs_err": err, "ms": kms, "device_ms": None,
            "launches_per_call": None, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
        })
        if "sweep" in name:
            rows[-1]["bound_ms_window_lanes"] = window_bms
        if err != 0:
            fail(f"{name} differs from its plain version at timing inputs")
    print(f"[6] sweep and sort timed at the single-Space shapes, launches "
          f"per tick: { {k: v / TICKS for k, v in launches.items()} }; "
          f"sweep {sweep_ms:.5f} ms a call (bound "
          f"{rows[0]['bound_ms']:.5f} ms by {rows[0]['bound_by']} for "
          f"{cand / N:.2f} in-range candidates a row, {window_bms:.5f} ms "
          f"by the all-lanes count); sort {sort_ms:.5f} ms a call (plan "
          f"{plan}) against torch.argsort(stable=True) {sort_lib:.5f} ms: "
          f"sort {'<=' if sort_ms <= sort_lib else '>'} argsort {tag}",
          flush=True)

    phase_done("[6]")
    mc = mega_config(N, MEGA_DEV)
    halo_parity(dev, mc)
    phase_done("[7]")
    ship_row, mega_device = mega_path(dev, mc, tag)
    rows.append(ship_row)
    phase_done("[8]-[9]")
    small_oracle(dev)
    phase_done("[10]")
    eager = {}
    world, served = world_phase(dev, (p50, p99), tag, profiled, eager)
    phase_done("[11]")
    world.update(planes_phase(dev, served, tag))
    del served
    phase_done("[18]")
    gate, world["verlet"] = verlet_phase(dev, tag, profiled)
    phase_done("[13]")
    gate_q16, world["q16"] = q16_phase(dev, tag)
    phase_done("[14]")
    spaces, spaces_shape, spaces_ms = spaces_phase(dev, (p50, p99), tag,
                                                   profiled)
    world.update(spaces)
    phase_done("[15]")
    mlp_row, beh_launches, mega_mlp_p50 = behavior_phase(
        dev, tag, profiled, (p50, p99))
    rows.append(mlp_row)
    world.update({f"behaviors_{k}": v for k, v in beh_launches.items()})
    underflow_on_card(dev, tag)
    phase_done("[17]")
    world["served_game"] = served_game_phase(dev, tag)
    phase_done("[19]")
    slice_launches = slice_phase(dev, tag, profiled, spaces_ms)
    world.update({f"slice_{k}": v for k, v in slice_launches.items()})
    mlp_row["launches_by_path"].update(
        {f"slice_{k}": v["npc_mlp"] for k, v in slice_launches.items()})
    mlp_row["launches"] = sum(mlp_row["launches_by_path"].values())
    phase_done("[20]")
    world.update(mesh_phase(dev, tag))
    phase_done("[21]")
    world.update(deployment_phase(dev, tag))
    phase_done("[22]")
    world.update(test_game_phase(dev, tag))
    phase_done("[23]")
    world.update(standby_phase(dev, tag))
    phase_done("[24]")
    world.update(multihost_phase(dev, tag))
    phase_done("[25]")
    for row, key in zip(rows[:2], ("sweep_fused", "counting_sort")):
        row["launches_by_path"] = {"single_space": row["launches"],
                                   **{p: n[key] for p, n in world.items()}}
        row["launches"] = sum(row["launches_by_path"].values())
    rows[0]["verlet_rebuild_shape"] = gate
    rows[0]["q16_rebuild_shape"] = gate_q16
    rows[0]["spaces_shape"] = spaces_shape["sweep_fused_cuda"]
    rows[1]["spaces_shape"] = spaces_shape["counting_sort_cells_cuda"]
    rows[2]["launches_by_path"] = {"megaspace": rows[2]["launches"], **{
        p: n["halo_ship_phase"] for p, n in world.items()
        if n.get("halo_ship_phase")}}
    rows[2]["launches"] = sum(rows[2]["launches_by_path"].values())

    got, dev_ms = device_times(profiled, rows[:2], plan)
    mlp_row["device_ms"], mlp_row["launches_per_call"] = got["npc_mlp"]
    if mlp_row["launches_per_call"] != 1:
        fail(f"[12] npc_mlp kernels a call: {mlp_row['launches_per_call']}")
    gate["gate_closed_device_ms"], gate["gate_closed_kernels"] = \
        got["sweep_fused_cuda, gate closed"]
    for row in rows[:2]:
        sh = row["spaces_shape"]
        sh["device_ms"], sh["launches_per_call"] = \
            got[f"{row['name']}, {SPACES} Spaces"]
    if rows[0]["spaces_shape"]["launches_per_call"] != 1 or \
            rows[1]["spaces_shape"]["launches_per_call"] > \
            rows[1]["spaces_shape"]["plan"][0] + 1:
        fail(f"[12] batched kernels' launches a call: "
             f"{[r['spaces_shape']['launches_per_call'] for r in rows[:2]]}")
    b8 = got[f"batched tick, {SPACES} Spaces"]
    b1 = got[f"tick, one Space of {N}"]
    bm = got["megaspace tick, mlp"]
    c5 = got["config 5 tick, mlp"]
    b8m = got[f"batched tick, {SPACES} Spaces, mlp"]
    print(f"[12] device time a call (torch.profiler, after the timed "
          f"paths): {dev_ms}; {mega_device()}; device busy a tick: "
          f"{SPACES} Spaces batched {b8[0]:.3f} ms in {b8[1]:g} kernels "
          f"(idle share against [15]'s p50 {1 - b8[0] / spaces_ms[0]:.3f}),"
          f" one Space of {N} {b1[0]:.3f} ms in {b1[1]:g} kernels (against"
          f" [5]'s p50 {1 - b1[0] / p50:.3f}), the megaspace under mlp "
          f"{bm[0]:.3f} ms in {bm[1]:g} kernels (against [17]'s p50 "
          f"{1 - bm[0] / mega_mlp_p50:.3f}); torch kernels a tick with "
          f"the subnormal flush: [5] {b1[1]:g} (before it: 1199), [17] "
          f"config 5 under mlp {c5[1]:g} in {c5[0]:.3f} ms (before it: not "
          f"read; its "
          f"megaspace tick under mlp 4163.95), [20] {SPACES} Spaces under "
          f"mlp {b8m[1]:g} in {b8m[0]:.3f} ms; profiled reads taken again"
          f" for lost events: {kernels.PROFILE_REREADS}; kernel times "
          f"on the next line {tag}", flush=True)
    phase_done("[12]")
    print(f"[walls] phase seconds {walls}, total "
          f"{sum(walls.values()):.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mh-step"]:
        sys.exit(mh_step_child(sys.argv[2:]))
    sys.exit(main())
