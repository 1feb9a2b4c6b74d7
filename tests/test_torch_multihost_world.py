"""The multi-controller World and its game server on the CPU: two
controller processes over gloo on the loopback, as
``tests/test_multihost.py`` runs the JAX package's (its cases are
marked slow there; these run in tier-1).

* the World API SPMD on two controllers: bookkeeping identical on both
  ranks, AOI fan-out owner-local, the same committed position read on
  both, the JAX World's deterministic auto ids, the staging tripwire;
* checkpoint and restore through the leader's file;
* sharded services claimed by the group as one;
* the mutation log's drain and backlog alarm against the JAX game
  server's (no process pair needed), and the dispatcher's follower
  wire ids against the JAX dispatcher's.

The workers live in ``tests/test_torch_multihost.py`` (``_worker``);
each has its own alarm and the test its wall limit.
"""

from __future__ import annotations

import json
import logging
import sys

import torch

from tests.test_torch_multihost import finish, free_port, spawn_workers

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)


def test_world_api_multihost(tmp_path):
    """The World (entity API, megaspace Space, host bookkeeping) SPMD on
    two controllers, ``tests/test_multihost.py::test_world_api_multihost``
    on the port: bookkeeping identical on both ranks, AOI event fan-out
    on the owner's controller only, the same committed position read on
    both, and the auto ids of the JAX World's deterministic sequence."""
    from goworld_tpu.utils import ids as jids

    finish(spawn_workers("world", str(tmp_path)))
    r0, r1 = (json.load(open(tmp_path / f"world{r}.json")) for r in (0, 1))
    assert r0["local_shards"] == [0, 1, 2, 3]
    assert r1["local_shards"] == [4, 5, 6, 7]
    # slot/shard bookkeeping is SPMD-identical on both controllers
    assert r0["slot_owner"] == r1["slot_owner"]
    assert r0["walker_shard"] == r1["walker_shard"] == 4, (r0, r1)
    assert r0["watcher_shard"] == r1["watcher_shard"] == 4
    assert r0["walker_alive"] and r1["walker_alive"]
    # both controllers read the same committed device position
    assert r0["walker_pos_x"] == r1["walker_pos_x"] > 400.0
    # event fan-out is owner-local: tile 4 belongs to rank 1
    assert "walker_walker_00" in r1["watcher_interested_in"]
    assert ["watcher_sees", "walker_walker_00"] in r1["events"]
    assert "walker_walker_00" not in r0["watcher_interested_in"]
    # the walker, on rank 0's tile 3 before it crossed, saw the watcher
    # as a ghost there; the watcher's hooks never ran on rank 0
    assert ["walker_sees", "watcher_watcher0"] in r0["events"]
    assert all(tag == "walker_sees" for tag, _ in r0["events"])
    # the shard's owner emits; slotless entities belong to the leader
    assert r0["emit"] == [False, True] and r1["emit"] == [True, False]
    # ROADMAP C18: the walker's hop from rank 0's tile to rank 1's keeps
    # the watcher it sees from both rows: one create of it, sent by rank
    # 0 when it first came into view, and neither a destroy from rank 0
    # nor a second create from rank 1 at the hop (which the client could
    # read in the other order, over two dispatcher connections)
    seen = [m for r in (r0, r1) for m in r["walker_client"]
            if m[1] == "watcher_watcher0" and m[0] != "sync"]
    assert seen == [["create_entity", "watcher_watcher0"]], (
        r0["walker_client"], r1["walker_client"])
    assert r1["walker_sees"] == ["watcher_watcher0"]
    # the auto ids: the JAX World's sequence, the same on both ranks
    want = [jids.gen_fixed_id(f"goworld_tpu.mh.1.{n}") for n in (1, 2, 3)]
    assert r0["space_id"] == r1["space_id"] == want[0]
    assert r0["autos"] == r1["autos"] == want[1:]
    # the staging tripwire ran (tick 0) and saw no divergence
    assert r0["guard"] == r1["guard"] and r0["guard"][0] >= 1
    assert r0["guard"][1] == 0


def _results(tmp_path, name):
    return [json.load(open(tmp_path / f"{name}{r}.json")) for r in (0, 1)]


def test_multihost_checkpoint_restore(tmp_path):
    """``tests/test_multihost.py::test_multihost_checkpoint_restore`` on
    the port, through the leader's file: both ranks pack the same
    snapshot, only the leader writes it, and both restore the walker on
    rank 1's tile with its position and attrs, the interest re-formed
    there (fan-out owner-local); ``checkpoint_async`` refuses the
    multi-controller World, as in the JAX package."""
    finish(spawn_workers("freeze", str(tmp_path)))
    r0, r1 = _results(tmp_path, "freeze")
    assert r0["snapshot"] == r1["snapshot"]
    assert r0["written"] is True
    assert r0["async_refused"] and r1["async_refused"]
    assert r0["pre"]["walker_shard"] == 4
    assert r0["restored_walker_shard"] == r1["restored_walker_shard"] == 4
    for r in (r0, r1):
        assert r["restored_walker_x"] == r0["pre"]["walker_x"]
        assert r["restored_hp"] == 7
        assert r["restored_alive"] == 2
    assert r1["restored_watcher_sees"] == r1["pre"]["watcher_sees"] \
        == ["walker_walker_00"]
    assert r0["restored_watcher_sees"] == []
    # ROADMAP C17: a persistent entity saved and destroyed before the
    # freeze keeps its id and its document; the restored World's auto
    # ids go on from the snapshot's sequence, and a fresh boot's nonce
    # (the same on both ranks) keeps it off the ids of an earlier boot,
    # which the sequence alone re-mints
    old, restored, fresh, unseeded = r0["hero_ids"]
    assert r1["hero_ids"] == r0["hero_ids"]
    assert len({old, restored, fresh}) == 3
    assert unseeded == old
    assert r0["hero_doc"] == r1["hero_doc"] == {"gold": 1}


def test_multihost_services(tmp_path):
    """``tests/test_multihost.py::test_multihost_services`` on the port:
    kvreg updates replicate through the mutation log, the group claims
    shards under one token, both ranks create the same service entities
    with the same deterministic ids, and the SPMD service call runs once
    on each."""
    finish(spawn_workers("services", str(tmp_path),
                         extra=(str(free_port()),)))
    r0, r1 = _results(tmp_path, "services")
    assert r0["claim"] == r1["claim"] == "mh:1"
    assert all(r0["service_eids"]), r0
    assert r0["service_eids"] == r1["service_eids"]
    assert r0["local_entities"] == r1["local_entities"] \
        == sorted(r0["service_eids"])
    assert r0["called"] and r1["called"]
    assert r0["incr_calls"] == r1["incr_calls"] == [5]


# ------------------------------------------------ the mutation log


class _Drain:
    """The drain's state on a stub (it touches nothing but the queue and
    its counters), for either package's ``GameServer``."""

    def __init__(self, server_cls, overload_mod):
        self.MH_LOG_BYTES_PER_TICK = server_cls.MH_LOG_BYTES_PER_TICK
        self._drain = server_cls._mh_drain_pending
        self.game_id = 1
        self._mh_pending = []
        self._mh_backlog_ticks = 0
        self.world = type("W", (), {"op_stats": {}})()
        self.overload = overload_mod.OverloadGovernor("stub-mh")
        self._shed_at_alarm = {}

    def drain(self):
        return self._drain(self)


def _drains():
    from goworld_tpu.net.game import GameServer as JServer
    from goworld_tpu.utils import overload as joverload
    from goworld_tpu_torch.net.game import GameServer as TServer
    from goworld_tpu_torch.utils import overload as toverload

    return _Drain(JServer, joverload), _Drain(TServer, toverload)


def test_mutation_log_drain_matches_jax():
    """The drain ships at most ``MH_LOG_BYTES_PER_TICK`` a tick, keeps
    the surplus queued in order, ships an oversized packet alone, and
    reports the backlog on its gauges: byte for byte the JAX game
    server's, tick by tick."""
    from goworld_tpu_torch.utils import opmon

    jd, td = _drains()
    assert td.MH_LOG_BYTES_PER_TICK == jd.MH_LOG_BYTES_PER_TICK == 1 << 20
    queue = [(100 + i, bytes([i]) * 400_000) for i in range(5)] \
        + [(7, bytes(2 << 20)), (8, b"small")]
    jd._mh_pending, td._mh_pending = list(queue), list(queue)
    sizes = []
    while td._mh_pending or jd._mh_pending:
        jb, tb = jd.drain(), td.drain()
        assert tb == jb
        assert td._mh_pending == jd._mh_pending
        assert td._mh_backlog_ticks == jd._mh_backlog_ticks
        assert td.world.op_stats == jd.world.op_stats
        assert opmon.vars()["mh_mutation_backlog_bytes"] == \
            td.world.op_stats["mh_mutation_backlog_bytes"]
        sizes.append(len(tb))
    assert sizes == [2 * 400_006, 2 * 400_006, 400_006, 6 + (2 << 20),
                     6 + 5]
    assert opmon.vars()["mh_mutation_backlog_packets"] == 0


def test_sustained_backlog_alarm(caplog):
    """Eight consecutive carry-over ticks raise the backlog alarm, as
    the JAX game server does."""
    _, td = _drains()
    big = b"x" * (600 << 10)
    with caplog.at_level(logging.WARNING, logger="goworld_tpu_torch.game"):
        for _ in range(8):  # the producer outruns the cap every tick
            td._mh_pending.extend([(10, big), (11, big)])
            td.drain()
    assert td._mh_backlog_ticks == 8
    assert any("backlog sustained" in r.message for r in caplog.records)


def test_dispatcher_follower_wire_ids_match_jax():
    """A follower controller connects under ``MH_FOLLOWER_GAME_ID_BASE +
    gid * 64 + rank`` and is not counted toward the deployment's games:
    the port's dispatcher reaches readiness on the same connections as
    the JAX dispatcher's."""
    from goworld_tpu.net.dispatcher import DispatcherService as JDisp
    from goworld_tpu.utils import consts as jconsts
    from goworld_tpu_torch.net.dispatcher import DispatcherService as TDisp
    from goworld_tpu_torch.utils import consts as tconsts

    assert tconsts.MH_FOLLOWER_GAME_ID_BASE == \
        jconsts.MH_FOLLOWER_GAME_ID_BASE == 30000

    class Conn:
        def send(self, p, release=True):
            pass

    def readiness(cls):
        game_info = sys.modules[cls.__module__]._GameInfo
        d = cls(1, "127.0.0.1", 0, desired_games=1, desired_gates=0)
        got = []
        for gid in (30000 + 64 + 1, 1):   # game 1's rank 1, then rank 0
            d.games[gid] = game_info(gid)
            d.games[gid].conn = Conn()
            d._check_deployment_ready()
            got.append(d.deployment_ready)
        return got

    assert readiness(TDisp) == readiness(JDisp) == [False, True]


def test_restored_world_skips_the_ids_it_holds():
    """ROADMAP C17: a multi-controller World restored from a snapshot
    starts its auto-id sequence from 1 again (the sequence is not in the
    snapshot), so the JAX World's first auto id after a reload is the id
    of an entity it restored (its boot-time megaspace): a login after a
    reload raises "entity id collision" there. The port's World skips
    the ids it holds, on every controller alike."""
    from goworld_tpu.core.state import WorldConfig as JConfig
    from goworld_tpu.entity.entity import Entity as JEntity
    from goworld_tpu.entity.manager import World as JWorld
    from goworld_tpu.ops.aoi import GridSpec as JGrid
    from goworld_tpu.utils import ids as jids
    from goworld_tpu_torch.core.state import WorldConfig
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.ops.aoi import GridSpec

    first, second = (jids.gen_fixed_id(f"goworld_tpu.mh.1.{n}")
                     for n in (1, 2))
    jw = JWorld(JConfig(capacity=16, grid=JGrid(radius=10.0)))
    tw = World(WorldConfig(capacity=16, grid=GridSpec(radius=10.0)),
               device="cpu")
    got = []
    for w, base in ((jw, JEntity), (tw, Entity)):
        w.register_entity("Npc", type("Npc", (base,), {}))
        w._multihost = True          # the restored controller's state
        w.create_entity("Npc", eid=first)
        got.append(w._gen_eid())
    assert got == [first, second]
