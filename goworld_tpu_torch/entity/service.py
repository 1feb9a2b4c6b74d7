"""Sharded singleton services — auto-placed service entities; the port's
copy of ``goworld_tpu/entity/service.py``.

Reference being rebuilt: ``engine/service/service.go``:
``RegisterService(name, ptr, shardCount)`` (``:65``) declares a service;
every game periodically reconciles (``checkServices`` ``:106-238``): for each
shard ``Service/<Name>#<idx>`` it races a kvreg write (first-writer-wins at
the dispatcher); the winning game creates the service entity locally and
publishes its EntityID back through kvreg. Calls resolve the EntityID from
the registry mirror and go through normal entity RPC:
``CallServiceAny/All/ShardIndex/ShardKey`` (``:258-324``); shard-by-key is
``HashString(key) % shards`` (``:326``).

The kvreg substrate is the dispatcher's first-writer-wins map
(the JAX package's ``net/dispatcher.py`` ``MT_KVREG_REGISTER``; not
ported yet); in single-process worlds a local dict stands in, so services
work without a cluster.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from goworld_tpu_torch.utils import log

if TYPE_CHECKING:
    from goworld_tpu_torch.entity.manager import World

logger = log.get("service")

_SERVICE_KEY = "Service/{name}#{idx}"       # -> game id that owns the shard
_ENTITY_KEY = "ServiceEntity/{name}#{idx}"  # -> EntityID of the shard

CHECK_INTERVAL = 5.0


def hash_string(s: str) -> int:
    """Deterministic string hash (reference ``common.HashString``,
    ``hash.go:13-57`` — any stable hash works as long as every process
    agrees; Python's builtin hash is salted, so roll our own)."""
    h = 0
    for ch in s.encode("utf-8"):
        h = (h * 31 + ch) & 0x7FFFFFFF
    return h


class ServiceManager:
    """Per-game service registry + reconciler.

    Wire-up: ``World.service_mgr = ServiceManager(world, ...)``. With a
    GameServer, ``kv_write``/``kv_get`` ride the dispatcher kvreg and the
    reconcile timer starts on deployment-ready; standalone they hit a local
    dict immediately.
    """

    #: multihost reconcile cadence in TICKS (driven by World.tick —
    #: wall timers fire at different instants per controller and would
    #: desync the deterministic eid sequence)
    MH_CHECK_TICKS = 25

    def __init__(
        self,
        world: "World",
        game_id: int = 1,
        kv_write: Callable[[str, str], None] | None = None,
        kv_get: Callable[[str], str | None] | None = None,
        claim_token: Callable[[], str] | None = None,
    ):
        self.world = world
        self.game_id = game_id
        # Multi-controller worlds claim shards as ONE group: the token
        # must be identical on every controller AND unique per group —
        # the GameServer supplies the allgathered leader game id; the
        # local-dict fallback (no cluster) uses World.game_id.
        self._claim_token = claim_token
        self._local_kv: dict[str, str] = {}
        self._kv_write = kv_write or self._local_write
        self._kv_get = kv_get or self._local_kv.get
        # name -> (cls registered under this type name, shard_count)
        self._services: dict[str, int] = {}
        self._local_shards: dict[tuple[str, int], str] = {}  # -> eid
        world.service_mgr = self

    @property
    def _claim(self) -> str:
        if self._claim_token is not None:
            return self._claim_token()
        if getattr(self.world, "_multihost", False):
            return f"mh:{self.world.game_id}"   # local-dict SPMD group
        return str(self.game_id)

    # -- local fallback kv ------------------------------------------------
    def _local_write(self, key: str, val: str) -> None:
        self._local_kv.setdefault(key, val)

    # -- registration -----------------------------------------------------
    def register(self, name: str, cls, shard_count: int = 1, **kw) -> None:
        """Reference ``RegisterService`` (``service.go:65``). ``cls`` is
        registered as entity type ``name`` (services are entities)."""
        if name not in self.world.registry:
            self.world.register_entity(name, cls, **kw)
        self._services[name] = shard_count

    def start(self) -> None:
        """Begin reconciling (call on deployment ready; reference
        ``OnDeploymentReady -> checkServices``). Multi-controller worlds
        do NOT reconcile from here: readiness flips at different wall
        instants per controller, and a reconcile that creates an entity
        on one controller before another desyncs the deterministic eid
        sequence — World.tick drives check_services every
        ``MH_CHECK_TICKS`` ticks instead (gated on the allgathered
        group readiness when a GameServer is attached)."""
        if getattr(self.world, "_multihost", False):
            return
        self.check_services()
        self.world.timers.add(
            CHECK_INTERVAL, interval=CHECK_INTERVAL, cb=self.check_services
        )

    # -- reconcile --------------------------------------------------------
    def check_services(self) -> None:
        """Claim unowned shards, create entities for shards we won, and
        publish their ids (reference ``checkServices`` ``service.go:106-238``)."""
        for name, shards in self._services.items():
            for idx in range(shards):
                skey = _SERVICE_KEY.format(name=name, idx=idx)
                owner = self._kv_get(skey)
                if owner is None:
                    # race for it; the dispatcher (or local dict) keeps the
                    # first writer — we may or may not win
                    self._kv_write(skey, self._claim)
                    owner = self._kv_get(skey)
                if owner != self._claim:
                    continue
                if (name, idx) in self._local_shards:
                    continue
                # ADOPT before creating: after a hot reload the
                # -restore snapshot already recreated this shard's
                # entity and the kvreg (dispatcher survives the game
                # restart; local worlds restore the mirror) still maps
                # the shard to its eid — creating a fresh entity here
                # would orphan-duplicate every service shard per
                # reload (reference checkServices re-links the
                # registered eid the same way, service.go:106-238)
                eid = self._kv_get(_ENTITY_KEY.format(name=name, idx=idx))
                if eid is not None:
                    e = self.world.entities.get(eid)
                    if e is not None and not e.destroyed:
                        e.service_name = name
                        e.shard_index = idx
                        self._local_shards[(name, idx)] = eid
                        logger.info(
                            "adopted restored service shard %s#%d -> %s",
                            name, idx, eid)
                        continue
                e = self.world.create_entity(name)
                e.service_name = name
                e.shard_index = idx
                self._local_shards[(name, idx)] = e.id
                self._kv_write(
                    _ENTITY_KEY.format(name=name, idx=idx), e.id
                )
                logger.info("created service shard %s#%d -> %s",
                            name, idx, e.id)

    # -- resolution / calls ----------------------------------------------
    def shard_count(self, name: str) -> int:
        if name in self._services:
            return self._services[name]
        # not registered locally: probe the registry mirror
        n = 0
        while self._kv_get(_SERVICE_KEY.format(name=name, idx=n)) is not None:
            n += 1
        return n

    def entity_id_of(self, name: str, idx: int) -> str | None:
        return self._kv_get(_ENTITY_KEY.format(name=name, idx=idx))

    def shard_by_key(self, name: str, key: str) -> int:
        shards = self.shard_count(name)
        return hash_string(key) % shards if shards else 0

    def call(self, name: str, method: str, args: tuple, *,
             shard_key: str | None = None,
             shard_index: int | None = None) -> None:
        """CallServiceShardKey / ShardIndex / Any (reference
        ``service.go:258-324``)."""
        shards = self.shard_count(name)
        if shards == 0:
            logger.warning("service %s unknown", name)
            return
        if shard_index is None:
            if shard_key is not None:
                shard_index = hash_string(shard_key) % shards
            else:
                # "Any": spread by stable hash of the method+argcount so
                # repeated fire-and-forget calls distribute
                shard_index = hash_string(method) % shards
        eid = self.entity_id_of(name, shard_index)
        if eid is None:
            logger.warning("service %s#%d not yet placed", name, shard_index)
            return
        self.world.call(eid, method, *args)

    def call_all(self, name: str, method: str, *args) -> None:
        """CallServiceAll: every shard (reference ``:300-312``)."""
        for idx in range(self.shard_count(name)):
            eid = self.entity_id_of(name, idx)
            if eid is not None:
                self.world.call(eid, method, *args)
