"""Public facade (mirrors the reference's root package ``goworld.go:34-256``).

The reference's user-facing flow::

    goworld.RegisterSpace(...)
    goworld.RegisterEntity(...)
    goworld.RegisterService(...)
    goworld.Run()

is preserved verbatim: a game server script registers its types at import
time and calls :func:`run`, which performs the boot sequence of
``components/game/game.go:65-135`` — config, storage, kvdb, world (or
freeze-file restore), dispatcher connections, signal handlers, serve loop.

Everything exported here is part of the stable user-facing API.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
from typing import Callable

from goworld_tpu_torch import config as config_mod
from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.utils import consts, log

logger = log.get("api")

__all__ = [
    "Entity", "Space", "GameClient",
    "register_entity", "register_space", "register_service",
    "on_deployment_ready", "on_boot",
    "run", "world", "game_server", "checkpoint_async",
    "create_space", "create_entity", "create_entity_anywhere",
    "create_space_anywhere", "create_entity_on_game",
    "create_space_on_game",
    "load_entity_anywhere", "load_entity_on_game",
    "get_entity", "get_space", "entities", "get_game_id",
    "get_nil_space", "get_online_games", "exists",
    "call", "call_service", "call_nil_spaces",
    "call_filtered_clients",
    "kvdb_get", "kvdb_put", "kvdb_get_or_put", "kvdb_get_range",
    "add_callback", "add_timer", "cancel_timer", "post",
    "register_crontab", "kvreg_register", "kvreg_get", "kvreg_watch",
    "kvreg_traverse",
]

# registrations made before run() builds the World (the reference's
# RegisterEntity also runs before Run(), goworld.go:42-50)
_registrations: list[tuple[str, str, type, dict]] = []
_ready_callbacks: list[Callable[[], None]] = []
_boot_callbacks: list = []
_rt: "_Runtime | None" = None


class _Runtime:
    """Everything one game process owns (world + cluster + IO backends)."""

    def __init__(self, world: World, server, storage, kvdb, workers):
        self.world = world
        self.server = server
        self.storage = storage
        self.kvdb = kvdb
        self.workers = workers


def _require_rt() -> _Runtime:
    if _rt is None:
        raise RuntimeError("goworld_tpu_torch.run() has not been called")
    return _rt


# =======================================================================
# registration
# =======================================================================
def register_entity(name: str, cls: type | None = None, **kw):
    """Register an entity type (reference ``RegisterEntity``). Usable as a
    decorator: ``@register_entity("Avatar")``."""

    def _reg(c: type):
        _registrations.append(("entity", name, c, kw))
        return c

    return _reg if cls is None else _reg(cls)


def register_space(name: str, cls: type | None = None, **kw):
    """Reference ``RegisterSpace`` (``goworld.go:42``)."""

    def _reg(c: type):
        _registrations.append(("space", name, c, kw))
        return c

    return _reg if cls is None else _reg(cls)


def on_boot(cb):
    """Run ``cb(world)`` right after the World is built — BEFORE the
    network connects or any tick runs. This is the SPMD-SAFE place to
    create spaces and populate entities on a MULTI-CONTROLLER game
    (``mesh_processes > 1``): ``on_deployment_ready`` fires at a
    different wall instant on each controller, so world mutations there
    would fork SPMD state, while pre-network creation completes before
    the first staging flush on every controller identically.
    Single-controller games may use either hook."""
    _boot_callbacks.append(cb)
    return cb


def on_deployment_ready(cb: Callable[[], None]):
    """Run ``cb`` once the whole deployment is up (the reference's
    ``OnGameReady`` on the nil space, ``GameService.go:344-393``). Usable
    as a decorator."""
    _ready_callbacks.append(cb)
    return cb


def register_service(name: str, cls: type | None = None,
                     shard_count: int = 1, **kw):
    """Reference ``RegisterService`` (``goworld.go:142``,
    ``service.go:65``): a sharded, auto-placed singleton entity."""

    def _reg(c: type):
        kw["shard_count"] = shard_count
        _registrations.append(("service", name, c, kw))
        return c

    return _reg if cls is None else _reg(cls)


# =======================================================================
# boot (reference goworld.Run -> game.Run, game.go:65-135)
# =======================================================================
def _parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(description="goworld_tpu game process")
    ap.add_argument("-gid", type=int, default=1)
    ap.add_argument("-configfile", default=None)
    ap.add_argument("-restore", action="store_true")
    ap.add_argument("-d", dest="daemon", action="store_true",
                    help="daemonize (reference binutil -d, game.go:50-59)")
    ap.add_argument("-logfile", default="")
    ap.add_argument("-loglevel", default="")
    return ap.parse_args(argv)


def _grid_caps(gc: config_mod.GameConfig) -> dict:
    """ini AOI capacity overrides (0 = keep the GridSpec default);
    re-provisioning target of the aoi_over_* overflow gauges."""
    caps = {}
    if gc.aoi_k > 0:
        caps["k"] = gc.aoi_k
    if gc.aoi_cell_cap > 0:
        caps["cell_cap"] = gc.aoi_cell_cap
    return caps


def _refuse(what: str, item: str = "8") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md Queue A item {item}")


def _governor_eligible(gc: config_mod.GameConfig, gid: int) -> bool:
    """[gameN] governor = true, gated to the shapes the swap machinery
    serves (single-shard, non-mesh, non-megaspace, telemetry on) — an
    ineligible config warns loudly and boots static, never crashes. The governor_table override
    is validated HERE, at boot, so a typo fails before the process
    serves (the GridSpec convention)."""
    if not gc.governor:
        return False
    why = None
    if gc.megaspace:
        why = "megaspace games keep their static tile config"
    elif gc.mesh_devices > 1:
        why = "mesh games keep their static config"
    elif gc.n_spaces > 1:
        why = ("the batched n_spaces > 1 step carries no skin "
               "branches to swap")
    elif not gc.telemetry_live:
        why = "telemetry_live = false leaves it no signature input"
    if why is not None:
        logger.warning("game%d: governor = true ignored (%s)", gid, why)
        return False
    if gc.governor_table:
        from goworld_tpu_torch.autotune import parse_table

        parse_table(gc.governor_table)  # raises loudly on typos
    return True


def _check_ported(gc: config_mod.GameConfig, cfg) -> None:
    """Every ini setting this port does not run raises here, before
    anything is built."""
    if gc.small_tier_rows:
        raise _refuse("small_tier_rows (the two-tier extraction)", "4")
    if gc.http_port:
        raise _refuse("http_port (utils/debug_http.py)")
    if gc.standby_of:
        raise _refuse("standby_of (replication/)")
    if cfg.rebalance:
        raise _refuse("[deployment] rebalance (rebalance/)")


def _build_world(gc: config_mod.GameConfig, gid: int,
                 device="cuda") -> World:
    """The game's World from its ini section. ``mesh_devices > 1``
    builds the World on a mesh of that many shards, and ``megaspace``
    one Space over them as tiles (the tile grid derived from the
    world extents and ``mega_shape``); every shard lives on the one
    card ``device`` names (:func:`goworld_tpu_torch.parallel.mesh.
    make_mesh`), so the JAX package's warning and single-device path
    for a host with too few devices has no counterpart here. The
    pipelined decode is forced off for both shapes, as in the JAX
    package."""
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.ops.aoi import GridSpec

    aoi_skin = gc.aoi_skin
    if gc.megaspace and aoi_skin > 0:
        # the megaspace step queries ghost rows through the stateless
        # sweep; there is no carried cache to reuse there
        logger.warning("aoi_skin ignored for megaspace games")
        aoi_skin = 0.0
    if aoi_skin > 0 and gc.capacity >= (1 << consts.AOI_ID_BITS):
        # the Verlet reuse path rides the packed-id fast path
        logger.warning(
            "aoi_skin ignored: capacity %d >= 2^%d (packed-id bound)",
            gc.capacity, consts.AOI_ID_BITS,
        )
        aoi_skin = 0.0
    precision = gc.precision
    if gc.megaspace and precision != "off":
        # the tile grids keep float32, as in the JAX package: say so
        # rather than silently change the tiles' layout
        logger.warning("precision=%s ignored for megaspace games "
                       "(quantized halo packing staged)", precision)
        precision = "off"
    kernel_kw = dict(
        sort_impl=gc.aoi_sort_impl,
        skin=aoi_skin,
        verlet_cap=gc.aoi_verlet_cap,
        rebuild_every_max=gc.aoi_rebuild_every_max,
        precision=precision,
    )
    mega_shape = None
    if gc.megaspace:
        # user config speaks WORLD extents; the megaspace grid is the
        # TILE grid in tile-shifted coordinates (extent = tile + 2R on
        # each tiled axis — parallel/megaspace.py MegaConfig contract)
        if gc.mesh_devices < 2:
            raise ValueError(
                "megaspace = true requires mesh_devices > 1 "
                f"(got {gc.mesh_devices})"
            )
        n_dev = gc.mesh_devices
        if gc.mega_shape:
            try:
                parts = [int(v) for v in
                         gc.mega_shape.lower().split("x") if v != ""]
                if len(parts) == 1:      # "8" = 1D x-strips
                    tx, tz = parts[0], 1
                elif len(parts) == 2:
                    tx, tz = parts
                else:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"mega_shape {gc.mega_shape!r} must be \"N\" (1D "
                    "x-strips) or \"TXxTZ\" (2D tiles), e.g. 8 or 4x2"
                ) from None
        else:
            tx, tz = n_dev, 1
        if tx * tz != n_dev:
            raise ValueError(
                f"mega_shape {gc.mega_shape!r} needs {tx * tz} devices "
                f"but mesh_devices = {n_dev}"
            )
        tile_w = gc.extent_x / tx
        grid = GridSpec(
            radius=gc.aoi_radius,
            extent_x=tile_w + 2 * gc.aoi_radius,
            extent_z=(gc.extent_z / tz + 2 * gc.aoi_radius) if tz > 1
            else gc.extent_z,
            sweep_impl=gc.aoi_sweep_impl,
            topk_impl=gc.aoi_topk_impl,
            **kernel_kw,
            **_grid_caps(gc),
        )
        mega_shape = (tx, tz)
    else:
        grid = GridSpec(radius=gc.aoi_radius, extent_x=gc.extent_x,
                        extent_z=gc.extent_z,
                        sweep_impl=gc.aoi_sweep_impl,
                        topk_impl=gc.aoi_topk_impl,
                        **kernel_kw,
                        **_grid_caps(gc))
    scenario = None
    if gc.scenario:
        from goworld_tpu_torch.scenarios.spec import get_scenario

        scenario = get_scenario(gc.scenario)  # KeyError lists names
    wc = WorldConfig(
        capacity=gc.capacity,
        grid=grid,
        npc_speed=gc.npc_speed,
        behavior=gc.behavior,
        scenario=scenario,
    )
    mesh = None
    if gc.mesh_devices > 1:
        from goworld_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(gc.mesh_devices, device=device)
    w = World(
        wc, n_spaces=max(gc.n_spaces, 1)
        if not gc.megaspace else gc.mesh_devices,
        mesh=mesh, game_id=gid,
        megaspace=gc.megaspace, mega_shape=mega_shape,
        halo_cap=gc.halo_cap, migrate_cap=gc.migrate_cap,
        halo_impl=gc.halo_impl,
        pipeline_decode=gc.pipeline_decode and mesh is None
        and not gc.megaspace,
        resident=gc.resident,
        telemetry_live=gc.telemetry_live,
        snapshot_keyframe_every=gc.snapshot_keyframe_every,
        residency=gc.residency,
        residency_sample_every=gc.residency_sample_every,
        audit=gc.audit,
        audit_sample_every=gc.audit_sample_every,
        audit_cohort=gc.audit_cohort,
        device=device,
    )
    # periodic persistence cadence (reference [gameN] save_interval,
    # goworld.ini.sample:45; Entity.go:164-177)
    w.save_interval = gc.save_interval
    return w


def run(argv: list[str] | None = None, *, block: bool = True,
        device="cuda") -> _Runtime:
    """Boot this game process (reference ``goworld.Run``).

    ``device`` places the World: the card unless the caller asks for
    the CPU (the tests pass ``"cpu"``); without a card it raises, as
    the World does. It is an argument of this call, not an ini key."""
    global _rt
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if args.daemon:
        raise _refuse("-d (utils/daemon.py)")
    if args.logfile or args.loglevel:
        log.setup(f"game{args.gid}", level=args.loglevel or "info",
                  logfile=args.logfile or None)
    cfg = config_mod.load(args.configfile)
    gid = args.gid
    gc = cfg.games.get(gid) or config_mod.GameConfig()
    _check_ported(gc, cfg)

    if int(os.environ.get("GOWORLD_MH_PROCS", "1")) > 1:
        raise _refuse("a multi-controller game (GOWORLD_MH_PROCS, "
                      "parallel/multihost.py)", "6")
    # deterministic fault injection (ini [deployment] faults/faults_seed,
    # env GOWORLD_FAULTS/GOWORLD_FAULTS_SEED override; utils/faults.py).
    # Installed before the world build so timed kill rules cover boot;
    # multihost ranks get per-rank labels so a kill can target one rank.
    from goworld_tpu_torch.utils import faults as faults_mod

    faults_mod.install(
        f"game{gid}",
        spec=getattr(cfg, "faults", ""),
        seed=getattr(cfg, "faults_seed", 0),
    )
    # storage + kvdb (reference game.go:99-103)
    from goworld_tpu_torch.kvdb import KVDB, open_kvdb_backend
    from goworld_tpu_torch.storage import Storage, open_backend
    from goworld_tpu_torch.utils.asyncwork import AsyncWorkers

    world = _build_world(gc, gid, device)
    workers = AsyncWorkers(world.post_q.post)
    storage = Storage(
        open_backend(cfg.storage.kind, cfg.storage.directory),
        world.post_q.post,
    )
    kvdb = KVDB(open_kvdb_backend(cfg.kvdb.kind, cfg.kvdb.path), workers)
    world.storage = storage

    _apply_registrations(world)

    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.net.game import GameServer

    # a crash-recovery checkpoint counts as a snapshot too (a watchdog
    # restart passes -restore after a crash with no fresh freeze file)
    def _mk_server(restore: bool) -> "GameServer":
        return GameServer(
            gid, world, cfg.dispatcher_addrs(),
            boot_entity=gc.boot_entity,
            ban_boot=gc.ban_boot_entity,
            restore=restore,
            checkpoint_interval=gc.checkpoint_interval,
            tick_interval=1.0 / max(1e-3, gc.tick_hz),
            gc_freeze_on_boot=gc.gc_freeze,
            pend_max_packets=gc.pend_max_packets,
            pend_max_bytes=gc.pend_max_bytes,
            overload_enabled=gc.overload,
            overload_up_ticks=gc.overload_up_ticks,
            overload_down_ticks=gc.overload_down_ticks,
            overload_latency_ratio=gc.overload_latency_ratio,
            degraded_sync_stride=gc.degraded_sync_stride,
            degraded_event_coalesce=gc.degraded_event_coalesce,
            flightrec_ring=gc.flightrec_ring,
            flightrec_cooldown_secs=gc.flightrec_cooldown_secs,
            sync_delta=gc.sync_delta,
            sync_keyframe_every=gc.sync_keyframe_every,
            sync_age=gc.sync_age,
            audit_scrub_every=gc.audit_scrub_every,
            # online kernel governor (autotune/): eligible shapes only
            governor_enabled=_governor_eligible(gc, gid),
            governor_window_ticks=gc.governor_window_ticks,
            governor_up_windows=gc.governor_up_windows,
            governor_down_windows=gc.governor_down_windows,
            governor_cooldown_windows=gc.governor_cooldown_windows,
            governor_regret_pct=gc.governor_regret_pct,
            governor_table=gc.governor_table,
        )

    restoring = args.restore and \
        bool(freeze_mod.snapshot_candidates(gid))
    server = None
    if restoring:
        try:
            server = _mk_server(True)
        except freeze_mod.CorruptSnapshotError:
            # every candidate rejected (restore_from_file reads fully
            # BEFORE applying, so the world is untouched): degrade to a
            # loud cold boot instead of a supervisor crash loop
            logger.exception(
                "game%d: no snapshot survived corruption checks; "
                "COLD-BOOTING without restore", gid,
            )
            restoring = False
    if not restoring:
        world.create_nil_space()
        for cb in _boot_callbacks:
            try:
                cb(world)
            except Exception:
                logger.exception("on_boot callback failed")
        server = _mk_server(False)
    svc = server.setup_services()
    _apply_registrations(world, svc=svc, services_only=True)

    _rt = _Runtime(world, server, storage, kvdb, workers)

    def _fire_ready() -> None:
        for cb in _ready_callbacks:
            try:
                cb()
            except Exception:
                logger.exception("on_deployment_ready callback failed")

    server.on_deployment_ready = _fire_ready

    if getattr(gc, "trace_sample_rate", 0.0) > 0:
        # self-rooted traces (outbound migrations); inbound traced
        # packets are recorded regardless of the local rate
        from goworld_tpu_torch.utils import tracing

        tracing.set_sample_rate(gc.trace_sample_rate)

    # signal handling (reference game.go:137-196): TERM = clean stop,
    # HUP = freeze for hot reload
    if block:
        signal.signal(signal.SIGTERM, lambda *_: server.stop())
        signal.signal(signal.SIGINT, lambda *_: server.stop())
        signal.signal(signal.SIGHUP, lambda *_: server.request_freeze())

    server.start_network()
    # registration barrier: pump until every dispatcher acked SET_GAME_ID
    # so the STARTED tag (consumed by the CLI's readiness wait) means
    # "routable" — a gate started next can immediately place boot entities
    import time as _time

    deadline = _time.monotonic() + 60.0
    n_disp = len(server.cluster.conns)
    while len(server.handshake_acks) < n_disp \
            and _time.monotonic() < deadline:
        server.pump()
        _time.sleep(0.02)
    if len(server.handshake_acks) < n_disp:
        logger.warning(
            "only %d/%d dispatchers acked within 60s",
            len(server.handshake_acks), n_disp,
        )
    # supervisor tag consumed by the CLI's readiness wait
    # (reference consts.go:108-112 + start.go:98-114)
    print(consts.SUPERVISOR_STARTED_TAG, flush=True)
    logger.info("game%d started (restore=%s)", gid, restoring)
    if block:
        try:
            server.serve_forever()
        finally:
            storage.shutdown()
            workers.wait_clear()
            server.stop()
        # hard exit: state is safely on disk by now — a server process
        # must terminate when told to
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(
            consts.FREEZE_EXIT_CODE if server.run_state == "frozen" else 0
        )
    return _rt


# =======================================================================
# world accessors
# =======================================================================
def world() -> World:
    return _require_rt().world


def game_server():
    return _require_rt().server


def checkpoint_async(directory: str = "."):
    """Crash-recovery snapshot of the running world without stalling the
    tick loop (beyond reference parity — the reference only has
    stop-the-world freeze; see freeze.checkpoint_async). Returns a
    handle; call ``.join()`` to wait."""
    from goworld_tpu_torch import freeze as freeze_mod

    return freeze_mod.checkpoint_async(_require_rt().world, directory)


# =======================================================================
# entity / space ops (reference goworld.go:52-140)
# =======================================================================
def create_space(type_name: str, **attrs) -> Space:
    return _require_rt().world.create_space(type_name, **attrs)


def create_entity(type_name: str, **kw) -> Entity:
    return _require_rt().world.create_entity(type_name, **kw)


def get_entity(eid: str) -> Entity | None:
    """Reference ``GetEntity`` (``goworld.go:112``)."""
    e = _require_rt().world.entities.get(eid)
    return None if e is None or e.destroyed or e.is_space else e


def get_space(eid: str) -> Space | None:
    """Reference ``GetSpace`` (``goworld.go:117``)."""
    return _require_rt().world.spaces.get(eid)


def entities() -> dict:
    """Reference ``Entities`` (``goworld.go:147``) — the live entity map
    of this game (read-only by convention)."""
    return _require_rt().world.entities


def get_game_id() -> int:
    """Reference ``GetGameID`` (``goworld.go:125``)."""
    return _require_rt().world.game_id


def get_nil_space() -> Space | None:
    """Reference ``GetNilSpace`` (``goworld.go:206``)."""
    return _require_rt().world.nil_space


def get_online_games() -> set[int]:
    """Reference ``GetOnlineGames`` (``goworld.go:226``): game ids
    currently connected to the cluster (seeded by the handshake ack,
    maintained by NOTIFY_GAME_CONNECTED/DISCONNECTED)."""
    rt = _require_rt()
    if rt.server is not None:
        return set(rt.server.online_games)
    return {rt.world.game_id}


def exists(type_name: str, eid: str, cb: Callable) -> None:
    """Reference ``Exists`` (``goworld.go:107``): async existence check
    against entity storage."""
    rt = _require_rt()
    if rt.storage is None:
        raise RuntimeError("storage is not initialized")
    rt.storage.exists(type_name, eid, cb)


def create_entity_anywhere(type_name: str, attrs: dict | None = None) -> None:
    _require_rt().server.create_entity_anywhere(type_name, attrs)


def create_space_anywhere(type_name: str, attrs: dict | None = None) -> None:
    """Reference ``CreateSpaceAnywhere`` (``goworld.go``): the dispatcher's
    load heap picks the hosting game."""
    rt = _require_rt()
    if not rt.world.registry.get(type_name).is_space:
        raise TypeError(f"{type_name} is not a space type")
    rt.server.create_entity_anywhere(type_name, attrs)


def create_entity_on_game(gameid: int, type_name: str,
                          attrs: dict | None = None) -> None:
    """Reference ``CreateEntityOnGame`` (``goworld.go:83``)."""
    _require_rt().server.create_entity_anywhere(type_name, attrs,
                                                gameid=gameid)


def create_space_on_game(gameid: int, type_name: str,
                         attrs: dict | None = None) -> None:
    """Reference ``CreateSpaceOnGame`` (``goworld.go:67``) — space types
    ride the same placement message (net/game.py routes them to
    ``create_space``)."""
    rt = _require_rt()
    if not rt.world.registry.get(type_name).is_space:
        raise TypeError(f"{type_name} is not a space type")
    rt.server.create_entity_anywhere(type_name, attrs, gameid=gameid)


def load_entity_on_game(type_name: str, eid: str, gameid: int) -> None:
    """Reference ``LoadEntityOnGame`` (``goworld.go:94``)."""
    _require_rt().server.load_entity_anywhere(type_name, eid,
                                              gameid=gameid)


def load_entity_anywhere(type_name: str, eid: str) -> None:
    _require_rt().server.load_entity_anywhere(type_name, eid)


def call(eid: str, method: str, *args) -> None:
    _require_rt().world.call(eid, method, *args)


def call_service(name: str, method: str, *args,
                 shard_key: str | None = None,
                 shard_index: int | None = None,
                 all_shards: bool = False) -> None:
    """Reference ``CallServiceAny/All/ShardIndex/ShardKey``
    (``goworld.go:157-172``) — default Any; pick one keyword."""
    _require_rt().world.call_service(
        name, method, *args, shard_key=shard_key,
        shard_index=shard_index, all_shards=all_shards,
    )


def call_nil_spaces(method: str, *args) -> None:
    _require_rt().server.call_nil_spaces(method, *args)


def call_filtered_clients(key: str, op: str, val: str, method: str,
                          *args) -> None:
    _require_rt().world.call_filtered_clients(key, op, val, method, args)


# =======================================================================
# kvdb (reference goworld.go:214-256)
# =======================================================================
def kvdb_get(key: str, cb: Callable) -> None:
    _require_rt().kvdb.get(key, cb)


def kvdb_put(key: str, val: str, cb: Callable) -> None:
    _require_rt().kvdb.put(key, val, cb)


def kvdb_get_or_put(key: str, val: str, cb: Callable) -> None:
    _require_rt().kvdb.get_or_put(key, val, cb)


def kvdb_get_range(begin: str, end: str, cb: Callable) -> None:
    _require_rt().kvdb.get_range(begin, end, cb)


# =======================================================================
# kvreg (cluster registry; reference kvreg.go)
# =======================================================================
def kvreg_register(key: str, val: str, force: bool = False) -> None:
    _require_rt().server.kvreg_register(key, val, force)


def kvreg_get(key: str) -> str | None:
    return _require_rt().server.kvreg.get(key)


def kvreg_traverse(prefix: str,
                   cb: Callable[[str, str], None]) -> None:
    """Walk the local kvreg mirror by key prefix (reference
    ``kvreg.TraverseByPrefix``, ``kvreg.go:23``)."""
    _require_rt().server.kvreg_traverse(prefix, cb)


def kvreg_watch(cb: Callable[[str, str], None]) -> None:
    _require_rt().server.kvreg_watchers.append(cb)


# =======================================================================
# timers / post / crontab (reference goworld.go:190-212)
# =======================================================================
def add_callback(delay: float, cb: Callable[[], None]) -> int:
    return _require_rt().world.timers.add(delay, cb=cb)


def add_timer(interval: float, cb: Callable[[], None]) -> int:
    return _require_rt().world.timers.add(interval, interval=interval, cb=cb)


def cancel_timer(tid: int) -> None:
    _require_rt().world.timers.cancel(tid)


def post(cb: Callable[[], None]) -> None:
    _require_rt().world.post_q.post(cb)


def register_crontab(minute: int, hour: int, day: int, month: int,
                     dow: int, cb: Callable[[], None]) -> None:
    _require_rt().world.crontab.register(minute, hour, day, month, dow, cb)


def _apply_registrations(world: World, svc=None,
                         services_only: bool = False) -> None:
    """Install the module-level registrations into a World (used by run()
    and by tests that host example games in-process)."""
    for kind, name, c, kw in _registrations:
        if kind == "entity" and not services_only:
            world.register_entity(name, c, **kw)
        elif kind == "space" and not services_only:
            world.register_space(name, c, **kw)
        elif kind == "service" and svc is not None:
            kw = dict(kw)
            shards = kw.pop("shard_count", 1)
            svc.register(name, c, shard_count=shards, **kw)
    if svc is None and not services_only:
        # pre-register service ENTITY TYPES (second loop, so a
        # same-name entity/space registration wins regardless of
        # declaration order — exactly what ServiceManager.register's
        # name-in-registry skip used to give): a -restore replays the
        # snapshot during GameServer construction — BEFORE the
        # kvreg-backed ServiceManager exists — and the snapshot
        # contains service entities (services are ordinary entities,
        # reference service.go:65).
        for kind, name, c, kw in _registrations:
            if kind == "service" and name not in world.registry:
                world.register_entity(
                    name, c,
                    **{k: v for k, v in kw.items()
                       if k != "shard_count"})


def _reset_for_tests() -> None:
    """Clear module state between tests (not public API)."""
    global _rt
    _rt = None
    _registrations.clear()
    _ready_callbacks.clear()
