"""The port's steps over two controller processes against the JAX
package's one-process 8-device steps, on the CPU.

Two OS processes join a ``torch.distributed`` group over gloo on the
loopback (:mod:`goworld_tpu_torch.parallel.multihost`), each holding 4
of the 8 shards of one global mesh; the JAX package runs the same
seeded state and inputs through ``make_mega_tick`` and
``make_multi_tick`` over conftest's 8 CPU devices in this process. The
two controllers' per-tick state and outputs, stacked in rank order,
must equal the JAX step's bit for bit, floats included, every tick:

* the 4x2 megaspace under the ``async`` halo (the phase kernel's plain
  version, the legs across the process boundary through its remote
  block) and under the plain ``ppermute`` composition: rank 0 holds tile
  columns 0-1 and rank 1 columns 2-3, so the x phase crosses processes
  and the z phase does not. Walkers cross the column 1-2 border (a
  migration from rank 0 to rank 1, the facts of
  ``tests/test_multihost.py``) and a tile of rank 1 sees a ghost of
  rank 0 enter its AOI;
* ``make_multi_tick`` over 8 shards with tagged migration requests
  between shards of both ranks (the JAX side's shard body under
  ``shard_map_norep``, as ``tests/test_torch_multi_tick.py`` runs it).

The workers are this file run as a script (``_worker``); each kills
itself on its own alarm, the group has a finite timeout, and the test
kills both on its wall limit, as ``tests/test_multihost.py`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import torch

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL = 150          # the test's limit on its workers, seconds
GROUP_TIMEOUT = 60  # the process group's, seconds

# the JAX multihost workers' sizes
CAP, TILE, RADIUS, K = 64, 60.0, 12.0, 16
HALO_CAP, MIGRATE_CAP = 16, 8
TX, TZ = 4, 2
N_DEV = TX * TZ
TICKS = 8
ALIVE = 40


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drain(procs, timeout):
    """``communicate()`` every worker, killing all of them on a timeout
    (a leaked pair would keep its group's rendezvous open)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.communicate()
        raise
    return outs


def spawn_rank(mode: str, rank: int, size: int, port: int, workdir: str,
               extra=()) -> subprocess.Popen:
    """Rank ``rank`` of a group of ``size`` on loopback ``port``: this
    file's ``_worker`` in ``mode``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(size), str(port), workdir, *extra],
        cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def spawn_workers(mode: str, workdir: str, n: int = 2, extra=()):
    """``n`` controller processes of this file's ``_worker`` in
    ``mode``, one group on a free loopback port."""
    port = free_port()
    return [spawn_rank(mode, rank, n, port, workdir, extra)
            for rank in range(n)]


def finish(procs, timeout=WALL):
    """Wait for the workers; every one must exit 0."""
    for p, (out, err) in zip(procs, drain(procs, timeout)):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n" \
            f"{err[-4000:]}"


# ------------------------------------------------------------- configs


def mega_kw(impl: str) -> tuple[dict, dict, dict]:
    grid = dict(radius=RADIUS, extent_x=TILE + 2 * RADIUS,
                extent_z=TILE + 2 * RADIUS, k=K, cell_cap=12, row_block=64,
                sweep_impl="fused", sort_impl="pallas", topk_impl="sort",
                skin=0.0, precision="off")
    world = dict(capacity=CAP, npc_speed=30.0, turn_prob=0.2,
                 enter_cap=2048, leave_cap=2048, sync_cap=2048,
                 attr_sync_cap=256, input_cap=32)
    mega = dict(n_dev=N_DEV, tile_w=TILE, halo_cap=HALO_CAP,
                migrate_cap=MIGRATE_CAP, mesh_shape=(TX, TZ), tile_d=TILE,
                halo_impl=impl)
    return grid, world, mega


def multi_kw() -> tuple[dict, dict]:
    extent = 240.0
    grid = dict(radius=RADIUS, extent_x=extent, extent_z=extent, k=K,
                cell_cap=12, row_block=64, topk_impl="sort", skin=0.0,
                precision="off")
    world = dict(capacity=CAP, npc_speed=5.0, enter_cap=1024,
                 leave_cap=1024, sync_cap=2048, attr_sync_cap=256,
                 input_cap=32, delta_rows_cap=CAP)
    return grid, world


def port_mega_config(impl: str):
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.ops.aoi import GridSpec
    from goworld_tpu_torch.parallel.megaspace import MegaConfig

    grid, world, mega = mega_kw(impl)
    return MegaConfig(cfg=WorldConfig(grid=GridSpec(**grid), **world),
                      **mega)


def port_multi_config():
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.ops.aoi import GridSpec

    grid, world = multi_kw()
    return WorldConfig(grid=GridSpec(sweep_impl="fused", sort_impl="pallas",
                                     **grid), **world)


def mega_world(seed: int = 0):
    """The 4x2 world: ALIVE movers a tile uniform inside it, 10% with a
    client, a few dirty hot attrs; walkers just west of the column 1-2
    border (rank 0's side) heading east, and a watcher on each rank-1
    tile of column 2; per tile 8 tile-local syncs and 2 syncs that hop
    an entity anywhere (migrations every tick)."""
    from goworld_tpu_torch import interop
    from goworld_tpu_torch.parallel.megaspace import create_mega_state

    mc = port_mega_config("async")
    rng = np.random.default_rng(seed)
    lanes = interop.state_to_numpy(create_mega_state(mc, seed=seed + 2,
                                                     device="cpu"))
    ix = (np.arange(N_DEV) // TZ)[:, None]
    iz = (np.arange(N_DEV) % TZ)[:, None]
    pos = lanes["pos"]
    pos[..., 0] = ix * TILE + rng.uniform(0, TILE, (N_DEV, CAP))
    pos[..., 2] = iz * TILE + rng.uniform(0, TILE, (N_DEV, CAP))
    alive = np.broadcast_to(np.arange(CAP) < ALIVE, (N_DEV, CAP)).copy()
    for d in (2, 3):                 # column 1: walkers at its east edge
        pos[d, :6, 0] = 2 * TILE - rng.uniform(0.5, 3.0, 6)
        lanes["yaw"][d, :6] = np.float32(np.pi / 2)
    for d in (4, 5):                 # column 2: watchers at its west edge
        pos[d, 0, 0] = 2 * TILE + 2.0
    lanes["alive"] = alive
    lanes["npc_moving"] = alive.copy()
    lanes["has_client"] = (rng.random((N_DEV, CAP)) < 0.1) & alive
    lanes["has_client"][4:6, 0] = True
    lanes["npc_moving"][4:6, 0] = False
    lanes["client_gate"][:] = 0
    lanes["hot_attrs"] = rng.random(lanes["hot_attrs"].shape).astype(
        np.float32)
    lanes["attr_dirty"][rng.random((N_DEV, CAP)) < 0.05] = 0x80000003
    ic = mc.cfg.input_cap
    idx = np.zeros((N_DEV, ic), np.int32)
    vals = np.zeros((N_DEV, ic, 4), np.float32)
    n_sync, n_hop = 8, 2
    for d in range(N_DEV):
        idx[d, :n_sync + n_hop] = rng.choice(np.arange(8, ALIVE),
                                             n_sync + n_hop, replace=False)
        vals[d, :n_sync, 0] = ix[d, 0] * TILE + rng.uniform(0, TILE, n_sync)
        vals[d, :n_sync, 2] = iz[d, 0] * TILE + rng.uniform(0, TILE, n_sync)
        vals[d, n_sync:n_sync + n_hop, 0] = rng.uniform(0, TX * TILE, n_hop)
        vals[d, n_sync:n_sync + n_hop, 2] = rng.uniform(0, TZ * TILE, n_hop)
        vals[d, :n_sync + n_hop, 3] = rng.uniform(-3, 3, n_sync + n_hop)
    inputs = dict(
        base=dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.full(N_DEV, n_sync + n_hop, np.int32)),
        migrate_target=np.full((N_DEV, CAP), -1, np.int32),
        migrate_tag=np.full((N_DEV, CAP), -1, np.int32),
    )
    return lanes, inputs


def multi_world(seed: int = 0):
    """8 shards of about 3/4 alive movers, 8 syncs a shard, and a fixed
    set of tagged migration requests, several across the ranks."""
    from goworld_tpu_torch import interop
    from goworld_tpu_torch.parallel.mesh import create_multi_state

    cfg = port_multi_config()
    rng = np.random.default_rng(seed)
    lanes = interop.state_to_numpy(create_multi_state(cfg, N_DEV, seed=seed,
                                                      device="cpu"))
    g = cfg.grid
    alive = rng.random((N_DEV, CAP)) < 0.75
    lanes["pos"][..., 0] = rng.uniform(0, g.extent_x, (N_DEV, CAP))
    lanes["pos"][..., 2] = rng.uniform(0, g.extent_z, (N_DEV, CAP))
    lanes["alive"] = alive
    lanes["npc_moving"] = alive.copy()
    lanes["has_client"] = alive & (rng.random((N_DEV, CAP)) < 0.05)
    lanes["hot_attrs"] = rng.random(lanes["hot_attrs"].shape).astype(
        np.float32)
    ic = cfg.input_cap
    idx = np.zeros((N_DEV, ic), np.int32)
    vals = np.zeros((N_DEV, ic, 4), np.float32)
    tgt = np.full((N_DEV, CAP), -1, np.int32)
    tag = np.full((N_DEV, CAP), -1, np.int32)
    t = 0
    for d in range(N_DEV):
        idx[d, :8] = rng.choice(np.flatnonzero(alive[d]), 8, replace=False)
        vals[d, :8, 0] = rng.uniform(0, g.extent_x, 8)
        vals[d, :8, 2] = rng.uniform(0, g.extent_z, 8)
        vals[d, :8, 3] = rng.uniform(-3, 3, 8)
        for sl in rng.choice(CAP, 6, replace=False):
            dst = int((d + 1 + rng.integers(0, N_DEV - 1)) % N_DEV)
            tgt[d, sl] = dst
            tag[d, sl] = t
            t += 1
    inputs = dict(
        base=dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.full(N_DEV, 8, np.int32)),
        migrate_target=tgt, migrate_tag=tag)
    return lanes, inputs


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_tree(path: str, tree: dict) -> None:
    np.savez(path, **_flatten(tree))


def load_tree(path: str) -> dict:
    with np.load(path) as z:
        return _nest({k: z[k] for k in z.files})


# -------------------------------------------------------------- workers


def _tick_worker(rank: int, size: int, port: int, workdir: str,
                 kind: str) -> None:
    """Run TICKS ticks of the step on this rank's shards and save every
    tick's local state and outputs."""
    from goworld_tpu_torch import interop
    from goworld_tpu_torch.parallel import multihost
    from goworld_tpu_torch.parallel.mesh import shard_state

    multihost.init_distributed(f"127.0.0.1:{port}", size, rank,
                               timeout=GROUP_TIMEOUT)
    world = load_tree(os.path.join(workdir, "world.npz"))
    mesh = multihost.global_mesh(N_DEV, device="cpu")
    loc = mesh.local_shards
    state = shard_state(interop.state_from_numpy(
        interop.local_shards(world["state"], loc), device="cpu"), mesh)
    inputs = interop.multi_inputs_from_numpy(
        interop.local_shards(world["inputs"], loc), device="cpu")
    if kind == "multi":
        from goworld_tpu_torch.parallel.step import make_multi_tick

        step = make_multi_tick(port_multi_config(), mesh,
                               migrate_cap=MIGRATE_CAP)
        dump = interop.mega_outputs_to_numpy
    else:
        from goworld_tpu_torch.parallel.megaspace import make_mega_tick

        step = make_mega_tick(port_mega_config(kind), mesh=mesh)
        dump = interop.mega_outputs_to_numpy
    got = {}
    for t in range(TICKS):
        state, out = step(state, inputs)
        got[f"t{t}"] = {"state": interop.state_to_numpy(state),
                        "out": dump(out)}
    got["stats"] = {k: np.asarray(v) for k, v in multihost.STATS.items()}
    # the JAX module's host reads: this rank's shards and their outputs
    idxs, per = multihost.local_shard_outputs(out, mesh)
    assert idxs == multihost.local_shard_indices(mesh) == list(loc)
    assert [int(o.arr_n) for o in per] == out.arr_n.tolist()
    save_tree(os.path.join(workdir, f"rank{rank}.npz"), got)
    multihost.shutdown()


def _world_worker(rank: int, size: int, port: int, workdir: str) -> None:
    """``tests/_mh_world_worker.py`` on the port: a megaspace World run
    SPMD on two controllers, a walker driven east across the process
    boundary (tile 3 of rank 0 to tile 4 of rank 1 in 1D strips) and a
    watcher on tile 4, plus two entities with auto ids."""
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity.entity import Entity, GameClient
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.ops.aoi import GridSpec
    from goworld_tpu_torch.parallel import multihost

    multihost.init_distributed(f"127.0.0.1:{port}", size, rank,
                               timeout=GROUP_TIMEOUT)
    tile_w, radius = 100.0, 10.0
    cfg = WorldConfig(
        capacity=16,
        grid=GridSpec(radius=radius, extent_x=tile_w + 2 * radius,
                      extent_z=100.0, k=8, cell_cap=16, row_block=16),
        npc_speed=0.0, enter_cap=256, leave_cap=256, sync_cap=256)
    mesh = multihost.global_mesh(N_DEV, device="cpu")
    w = World(cfg, n_spaces=N_DEV, mesh=mesh, megaspace=True, halo_cap=8,
              migrate_cap=4, device="cpu")

    class Mega(Space):
        pass

    class Npc(Entity):
        pass

    w.registry.register("Mega", Mega, is_space=True, megaspace=True)
    w.registry.register("Npc", Npc)
    sp = w.create_space("Mega")
    walker = w.create_entity("Npc", space=sp, pos=(398.5, 0.0, 50.0),
                             eid="walker_walker_00")
    watcher = w.create_entity("Npc", space=sp, pos=(403.0, 0.0, 50.0),
                              eid="watcher_watcher0")
    autos = [w.create_entity("Npc", space=sp, pos=(50.0 + 100 * i, 0.0,
                                                   20.0)).id
             for i in range(2)]
    # the walker is a player: its client's messages are captured by the
    # World's default sink, on whichever controller emits them
    w.set_entity_client(walker, GameClient(1, "walkerclient0000", w))
    events = []
    for e, tag in ((walker, "walker_sees"), (watcher, "watcher_sees")):
        orig = e.OnEnterAOI

        def hook(other, _tag=tag, _orig=orig):
            events.append((_tag, other.id))
            return _orig(other)
        e.OnEnterAOI = hook
    x = 398.5
    for t in range(6):
        if t < 3:
            x += 1.0
            walker.set_position((x, 0.0, 50.0))
        w.tick()
    out = {
        "process": rank,
        "local_shards": w.local_shards,
        "walker_shard": walker.shard,
        "walker_slot": walker.slot,
        "watcher_shard": watcher.shard,
        "walker_alive": not walker.destroyed and walker.slot is not None,
        "events": events,
        "watcher_interested_in": sorted(watcher.interested_in),
        "walker_pos_x": float(walker.position[0]),
        "walker_sees": sorted(walker.interested_in),
        "walker_client": [(m["type"], m.get("eid"))
                          for _, cid, m in w.client_messages
                          if cid == "walkerclient0000"],
        "slot_owner": [sorted(d.items()) for d in w._slot_owner],
        "space_id": sp.id,
        "autos": autos,
        "emit": [w.client_emit_ok(walker), w.client_emit_ok(None)],
        "guard": [w.op_stats["spmd_guard_checks"],
                  w.op_stats["spmd_guard_divergences"]],
    }
    with open(os.path.join(workdir, f"world{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def _api_worker(rank: int, size: int, port: int, workdir: str, ini: str,
                ticks: str) -> None:
    """One controller of a game booted by ``gw.run`` from ``ini`` (the
    group's environment as the CLI sets it), ticked ``ticks`` times;
    what it served is saved for the test."""
    os.environ.update(GOWORLD_MH_PROCS=str(size), GOWORLD_MH_PROC_ID=str(rank),
                      GOWORLD_MH_COORD=f"127.0.0.1:{port}")
    import goworld_tpu_torch as gw
    from goworld_tpu_torch.parallel import multihost

    rt = gw.run(["-gid", "1", "-configfile", ini], block=False,
                device="cpu")
    try:
        for _ in range(int(ticks)):
            rt.server.pump()
            rt.server.tick()
        with open(os.path.join(workdir, f"api{rank}.json"), "w") as f:
            json.dump(controller_facts(rt), f)
    finally:
        rt.server.stop()
        rt.storage.shutdown()
        multihost.shutdown()


def controller_facts(rt) -> dict:
    """What a controller of a game booted by ``gw.run`` serves."""
    w = rt.world
    return {"game_id": rt.server.game_id, "multihost": w._multihost,
            "local_shards": w.local_shards, "rank": w.mh_rank,
            "ticks": w.tick_count, "ban_boot": rt.server.ban_boot,
            "global_alive": w.last_outputs.global_alive.tolist()}


def _small_mega_world(device="cpu"):
    """The JAX multihost workers' megaspace World (8 x-strip tiles of
    capacity 16) over this process's group, with a megaspace type and an
    entity type registered and its nil space made."""
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.entity.space import Space
    from goworld_tpu_torch.ops.aoi import GridSpec
    from goworld_tpu_torch.parallel import multihost

    class Mega(Space):
        pass

    class Npc(Entity):
        ATTRS = {"hp": "client"}

    cfg = WorldConfig(
        capacity=16,
        grid=GridSpec(radius=10.0, extent_x=120.0, extent_z=100.0, k=8,
                      cell_cap=16, row_block=16),
        npc_speed=0.0, enter_cap=256, leave_cap=256, sync_cap=256)
    w = World(cfg, n_spaces=N_DEV, mesh=multihost.global_mesh(N_DEV, device),
              megaspace=True, halo_cap=8, migrate_cap=4, device=device)
    w.registry.register("Mega", Mega, is_space=True, megaspace=True)
    w.register_entity("Npc", Npc)
    w.create_nil_space()
    return w


def _freeze_worker(rank: int, size: int, port: int, workdir: str) -> None:
    """``tests/_mh_freeze_worker.py`` on the port, through the file: a
    walker driven across the process boundary, the group frozen (every
    rank packs the same global snapshot), the leader alone writes it,
    and every rank restores a fresh World from the leader's file."""
    from goworld_tpu_torch.freeze import (checkpoint_async, freeze_world,
                                          read_freeze_file, restore_world,
                                          write_freeze_file)
    from goworld_tpu_torch.parallel import multihost
    from goworld_tpu_torch.utils import mpack

    from goworld_tpu_torch.entity.entity import Entity

    class Hero(Entity):
        ATTRS = {"gold": "persistent"}

    docs = {}

    class Docs:
        """The storage's saves, by entity id."""

        def save(self, type_name, eid, data):
            docs[eid] = dict(data)

    def served(world):
        world.register_entity("Hero", Hero, persistent=True)
        world.storage = Docs()
        return world

    group = multihost.init_distributed(f"127.0.0.1:{port}", size, rank,
                                       timeout=GROUP_TIMEOUT)
    w = served(_small_mega_world())
    sp = w.create_space("Mega")
    # a persistent entity saved and destroyed before the freeze
    hero = w.create_entity("Hero")
    hero.attrs["gold"] = 1
    w.save_entity(hero)
    w.destroy_entity(hero)
    walker = w.create_entity("Npc", space=sp, pos=(398.5, 0.0, 50.0),
                             eid="walker_walker_00")
    watcher = w.create_entity("Npc", space=sp, pos=(406.0, 0.0, 50.0),
                              eid="watcher_watcher0")
    walker.attrs["hp"] = 7
    x = 398.5
    for _ in range(5):
        x += 1.5
        walker.set_position((x, 0.0, 50.0))
        w.tick()
    pre = {"walker_shard": walker.shard,
           "walker_x": float(walker.position[0]),
           "watcher_sees": sorted(watcher.interested_in)}
    snap = freeze_world(w)
    try:        # its background fetch would be a one-sided collective
        checkpoint_async(w, workdir)
        refused = False
    except RuntimeError:
        refused = True
    path = os.path.join(workdir, "game1_freezed.dat")
    if rank == 0:
        write_freeze_file(path, snap)
    group.all_gather(torch.zeros(1))        # the leader's file is down
    w2 = served(_small_mega_world())
    restore_world(w2, read_freeze_file(path))
    # after the restore, and in a fresh boot with and without its nonce
    hero2 = w2.create_entity("Hero")
    hero2.attrs["gold"] = 2
    w2.save_entity(hero2)
    w3 = served(_small_mega_world())
    w3.mh_draw_id_nonce()
    w3.create_space("Mega")
    fresh = w3.create_entity("Hero").id
    w4 = served(_small_mega_world())
    w4.create_space("Mega")
    unseeded = w4.create_entity("Hero").id
    walker2 = w2.entities["walker_walker_00"]
    watcher2 = w2.entities["watcher_watcher0"]
    for _ in range(3):
        w2.tick()
    import hashlib

    out = {
        "process": rank, "pre": pre,
        "snapshot": hashlib.sha256(mpack.packb(snap)).hexdigest(),
        "written": os.path.exists(path) if rank == 0 else None,
        "async_refused": refused,
        "restored_walker_shard": walker2.shard,
        "restored_walker_x": float(walker2.position[0]),
        "restored_hp": walker2.attrs.get("hp"),
        "restored_watcher_sees": sorted(watcher2.interested_in),
        "restored_alive": int(w2.last_outputs.global_alive[0]),
        "hero_ids": [hero.id, hero2.id, fresh, unseeded],
        "hero_doc": docs.get(hero.id),
    }
    with open(os.path.join(workdir, f"freeze{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def _services_worker(rank: int, size: int, port: int, workdir: str,
                     disp_port: str) -> None:
    """``tests/_mh_service_worker.py`` on the port: sharded singleton
    services on a two-controller World against the port's dispatcher
    (rank 0 serves it): both ranks claim as one group, create the same
    service entities with the same ids, and run an SPMD service call
    once each."""
    import asyncio
    import threading
    import time

    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.net.dispatcher import DispatcherService
    from goworld_tpu_torch.net.game import GameServer
    from goworld_tpu_torch.parallel import multihost

    multihost.init_distributed(f"127.0.0.1:{port}", size, rank,
                               timeout=GROUP_TIMEOUT)
    disp_port = int(disp_port)
    w = _small_mega_world()
    w.create_space("Mega")

    class Counter(Entity):
        calls: list = []

        def Incr(self, amount):
            Counter.calls.append(int(amount))

    ready = threading.Event()

    def services_thread() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def boot():
            if rank == 0:
                d = DispatcherService(1, "127.0.0.1", disp_port,
                                      desired_games=2, desired_gates=0)
                asyncio.ensure_future(d.serve())
                await d.started.wait()

        loop.run_until_complete(boot())
        ready.set()
        loop.run_forever()

    threading.Thread(target=services_thread, daemon=True).start()
    assert ready.wait(30)
    if rank == 1:
        time.sleep(1.0)  # let the dispatcher bind first
    gs = GameServer(rank + 1, w, [("127.0.0.1", disp_port)])
    svc = gs.setup_services()
    svc.register("Counter", Counter, shard_count=2)
    gs.start_network()
    called_at = None
    for t in range(SERVICE_TICKS):
        gs.pump()
        if called_at is None \
                and svc.entity_id_of("Counter", 0) is not None \
                and svc.entity_id_of("Counter", 1) is not None:
            svc.call("Counter", "Incr", (5,), shard_index=0)
            called_at = t
        gs.tick()
        time.sleep(0.02)
    out = {
        "process": rank,
        "service_eids": [svc.entity_id_of("Counter", i) for i in (0, 1)],
        "local_entities": sorted(
            e.id for e in w.entities.values()
            if e.type_name == "Counter" and not e.destroyed),
        "incr_calls": Counter.calls,
        "claim": svc._claim,
        "called": called_at is not None,
    }
    with open(os.path.join(workdir, f"services{rank}.json"), "w") as f:
        json.dump(out, f)
    gs.stop()
    multihost.shutdown()


SERVICE_TICKS = 260

WORKERS = {"tick": _tick_worker, "world": _world_worker,
           "api": _api_worker, "freeze": _freeze_worker,
           "services": _services_worker}


def _worker(argv) -> int:
    mode, rank, size, port, workdir, *extra = argv
    signal.alarm(WALL)          # a hang ends the worker, never the suite
    torch.set_num_threads(1)
    WORKERS[mode](int(rank), int(size), int(port), workdir, *extra)
    return 0


# ---------------------------------------------------------------- tests


def _stacked(workdir: str, size: int = 2) -> dict:
    """The ranks' saved trees, every lane stacked in rank order."""
    parts = [_flatten(load_tree(os.path.join(workdir, f"rank{r}.npz")))
             for r in range(size)]
    out = {}
    for k in parts[0]:
        if k.startswith("stats/"):
            out[k] = [p[k] for p in parts]
        else:
            out[k] = np.concatenate([p[k] for p in parts])
    return _nest(out)


def _bits_equal(got: dict, ref: dict, what):
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for name, g in got.items():
        r = ref[name]
        if isinstance(r, dict):
            _bits_equal(g, r, f"{what} {name}")
            continue
        assert g.shape == r.shape and g.dtype == r.dtype, (
            what, name, g.shape, r.shape, g.dtype, r.dtype)
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(r).view(np.uint8)), (
            what, name, int((g != r).sum()))


def _jax_lanes(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out[f.name] = _jax_lanes(v) if dataclasses.is_dataclass(v) \
            else np.array(v)
    return out


def _jax_mega(impl, lanes, inputs):
    import jax.numpy as jnp

    from goworld_tpu.core import state as jstate
    from goworld_tpu.core.step import TickInputs as JInputs
    from goworld_tpu.ops.aoi import GridSpec as JGrid
    from goworld_tpu.parallel.megaspace import MegaConfig as JMega
    from goworld_tpu.parallel.megaspace import create_mega_state as jcreate
    from goworld_tpu.parallel.megaspace import make_mega_tick as jmake
    from goworld_tpu.parallel.mesh import make_mesh
    from goworld_tpu.parallel.step import MultiTickInputs as JMulti

    grid, world, mega = mega_kw(impl)
    jmc = JMega(cfg=jstate.WorldConfig(grid=JGrid(**grid), **world), **mega)
    js = jstate.SpaceState(
        **{k: jnp.asarray(v) for k, v in lanes.items()},
        aoi_cache=jcreate(jmc, seed=0).aoi_cache)
    ji = JMulti(base=JInputs(**{k: jnp.asarray(v)
                                for k, v in inputs["base"].items()}),
                migrate_target=jnp.asarray(inputs["migrate_target"]),
                migrate_tag=jnp.asarray(inputs["migrate_tag"]))
    tick = jmake(jmc, make_mesh(N_DEV))
    ref = []
    for _ in range(TICKS):
        js, jo = tick(js, ji, None)
        out = _jax_lanes(jo)
        out["base"] = _jax_lanes(jo.base)
        ref.append((_jax_lanes(js), out))
    return ref


def _jax_multi(lanes, inputs):
    import jax.numpy as jnp

    from goworld_tpu.core import state as jstate
    from goworld_tpu.core.step import TickInputs as JInputs
    from goworld_tpu.ops.aoi import GridSpec as JGrid
    from goworld_tpu.parallel.mesh import make_mesh as jmake_mesh
    from goworld_tpu.parallel.step import MultiTickInputs as JMulti
    from goworld_tpu.parallel.step import make_multi_tick as jmake_multi

    grid, world = multi_kw()
    jcfg = jstate.WorldConfig(
        grid=JGrid(sweep_impl="ranges", sort_impl="argsort", **grid),
        **world)
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()},
                           aoi_cache=None)
    ji = JMulti(base=JInputs(**{k: jnp.asarray(v)
                                for k, v in inputs["base"].items()}),
                migrate_target=jnp.asarray(inputs["migrate_target"]),
                migrate_tag=jnp.asarray(inputs["migrate_tag"]))
    step = jmake_multi(jcfg, jmake_mesh(N_DEV), migrate_cap=MIGRATE_CAP)
    ref = []
    for _ in range(TICKS):
        js, jo = step(js, ji, None)
        out = {f.name: np.array(getattr(jo, f.name))
               for f in dataclasses.fields(jo) if f.name != "base"}
        out["base"] = _jax_lanes(jo.base)
        ref.append((_jax_lanes(js), out))
    return ref


def _run_ticks(tmp_path, kind: str):
    lanes, inputs = multi_world() if kind == "multi" else mega_world()
    save_tree(str(tmp_path / "world.npz"),
              {"state": lanes, "inputs": inputs})
    procs = spawn_workers("tick", str(tmp_path), extra=(kind,))
    try:
        ref = _jax_multi(lanes, inputs) if kind == "multi" \
            else _jax_mega(kind, lanes, inputs)
    finally:
        finish(procs)
    got = _stacked(str(tmp_path))
    for t, (rs, ro) in enumerate(ref):
        _bits_equal(got[f"t{t}"]["state"], rs, f"state {t}")
        _bits_equal(got[f"t{t}"]["out"], ro, f"outputs {t}")
    return got, ref


def test_two_controller_megaspace_async_matches_jax(tmp_path):
    got, _ = _run_ticks(tmp_path, "async")
    _mega_facts(got)


def test_two_controller_megaspace_ppermute_matches_jax(tmp_path):
    got, _ = _run_ticks(tmp_path, "ppermute")
    _mega_facts(got)


def _mega_facts(got):
    """The walk across the process boundary and the ghost enter across
    it, read off the gathered outputs."""
    half = N_DEV // 2
    crossed = ghost = 0
    for t in range(TICKS):
        o = got[f"t{t}"]["out"]
        for d in range(half, N_DEV):
            n = int(o["arr_n"][d])
            src = o["arr_tag"][d, :n] // CAP
            crossed += int((src < half).sum())
            en = min(int(o["base"]["enter_n"][d]), o["base"]["enter_j"].shape[1])
            j = o["base"]["enter_j"][d, :en]
            ghost += int(((j // CAP) < half).sum())
        assert int(o["global_alive"][0]) == N_DEV * ALIVE
        assert (o["global_alive"] == o["global_alive"][0]).all()
    assert crossed > 0, "no entity crossed from rank 0's tiles to rank 1's"
    assert ghost > 0, "no rank-1 tile saw a ghost of rank 0 enter its AOI"
    # the cross legs went through the group: host syncs only on a card
    assert all(int(c) > 0 for c in got["stats"]["collectives"])


def test_two_controller_multi_tick_matches_jax(tmp_path):
    got, _ = _run_ticks(tmp_path, "multi")
    half = N_DEV // 2
    crossed = 0
    for t in range(TICKS):
        o = got[f"t{t}"]["out"]
        crossed += int(o["migrate_demand"][:half, half:].sum())
        assert (o["global_alive"] == o["global_alive"][0]).all()
    assert crossed > 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
