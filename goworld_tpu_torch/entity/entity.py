"""Entity base class and client binding — the user programming model;
the port's copy of ``goworld_tpu/entity/entity.py``.

Reference being rebuilt: ``engine/entity/Entity.go`` (lifecycle hooks,
timers, RPC dispatch, client binding, attr->client sync, AOI interest sets,
EnterSpace/migration — ``Entity.go:44-120, 271-418, 678-765, 956-1115``) and
``engine/entity/GameClient.go`` (the (gateid, clientid) handle every
client-bound message routes through).

Execution-model inversion: an Entity here is a *host-side handle* onto a row
of the Space's device SoA (``goworld_tpu_torch.core.state.SpaceState``).
Movement, AOI and sync happen in the device tick; the Entity object carries
identity, cold attrs, timers, the client binding, and the Python-level hooks
the world loop fires from the device's event outputs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

from goworld_tpu_torch.entity.attrs import MapAttr
from goworld_tpu_torch.entity.registry import EntityTypeDesc
from goworld_tpu_torch.utils import log

if TYPE_CHECKING:
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.entity.space import Space

logger = log.get("entity")


class GameClient:
    """Handle to the (gate_id, client_id) pair owning an entity
    (reference ``GameClient.go:17-21``). Messages go through the world's
    client sink — the gateway in a full deployment, a capture list in
    tests.

    ``owner`` is the bound entity (set by ``World.set_entity_client``).
    Under a multi-controller World, host logic runs SPMD on EVERY
    controller, so each client-bound message would be emitted once per
    controller; :meth:`send` consults ``World.client_emit_ok(owner)`` so
    exactly one controller (the one owning the entity's shard) puts it on
    the wire — the device-plane analog of the reference dispatcher
    routing client packets from whichever game hosts the entity
    (``components/gate/GateService.go:258-306``)."""

    __slots__ = ("gate_id", "client_id", "_world", "owner")

    def __init__(self, gate_id: int, client_id: str, world: "World",
                 owner: "Entity | None" = None):
        self.gate_id = gate_id
        self.client_id = client_id
        self._world = world
        self.owner = owner

    def send(self, msg: dict) -> None:
        if not self._world.client_emit_ok(self.owner):
            return
        self._world.send_to_client(self.gate_id, self.client_id, msg)

    def __repr__(self) -> str:
        return f"GameClient(gate={self.gate_id}, client={self.client_id})"


class Entity:
    """Base class of every game object (reference ``Entity.go:44-70``).

    Subclass, declare ``ATTRS`` (name -> flag string like
    ``"client persistent"`` / ``"allclients"`` / ``"persistent hot:0"``),
    override hooks, register with :meth:`World.register_entity`.
    """

    ATTRS: dict[str, str] = {}
    _type_desc: EntityTypeDesc  # set by Registry.register

    def __init__(self):
        # populated by World._attach right after construction
        self.id: str = ""
        self.world: "World" = None  # type: ignore
        self.space: "Space | None" = None
        # device address = (shard, slot); for normal AOI spaces shard ==
        # space.shard, for megaspaces it is the entity's current TILE
        # (which changes as the entity crosses tile borders)
        self.shard: int | None = None
        self.slot: int | None = None  # device row in shard
        self.client: GameClient | None = None
        self.attrs: MapAttr = None  # type: ignore
        self.interested_in: set[str] = set()
        self.interested_by: set[str] = set()
        self.timer_ids: set[int] = set()
        self.destroyed = False
        self._pending_pos: tuple | None = None  # staged, not yet on device
        self._pending_yaw: float | None = None
        # (src_shard, src_slot, dst_shard) while a device migration is in
        # flight; the entity has no addressable row during this window
        self._migrating: tuple | None = None

    # ------------------------------------------------------------------
    # identity / device row
    # ------------------------------------------------------------------
    @property
    def type_name(self) -> str:
        return self._type_desc.name

    @property
    def is_space(self) -> bool:
        return self._type_desc.is_space

    @property
    def position(self) -> tuple[float, float, float]:
        """Last committed device position (one tick behind a staged set)."""
        if self._pending_pos is not None:
            return self._pending_pos
        if self.slot is None or self.shard is None:
            return (0.0, 0.0, 0.0)
        # a batched client sync staged this tick is already the entity's
        # position as far as host logic is concerned (the reference
        # applies client syncs to the entity immediately,
        # Entity.go:430-435)
        v = self.world._peek_batch_pos(self.shard, self.slot)
        if v is not None:
            return (float(v[0]), float(v[1]), float(v[2]))
        p = self.world.read_pos(self.shard, self.slot)
        return (float(p[0]), float(p[1]), float(p[2]))

    @property
    def yaw(self) -> float:
        if self._pending_yaw is not None:
            return self._pending_yaw
        if self.slot is None or self.shard is None:
            return 0.0
        v = self.world._peek_batch_pos(self.shard, self.slot)
        if v is not None:
            return float(v[3])
        return self.world.read_yaw(self.shard, self.slot)

    def set_position(self, pos) -> None:
        """Stage a teleport/position-set; applied inside the next tick via
        the pos-sync input scatter (``ops.integrate.apply_pos_inputs``)."""
        self._pending_pos = (float(pos[0]), float(pos[1]), float(pos[2]))
        self.world.stage_pos_set(self)

    def set_yaw(self, yaw: float) -> None:
        self._pending_yaw = float(yaw)
        self.world.stage_pos_set(self)

    def set_moving(self, moving: bool) -> None:
        """Toggle NPC velocity integration for this entity's row."""
        self.world.set_moving(self, moving)

    # ------------------------------------------------------------------
    # attrs
    # ------------------------------------------------------------------
    def get_persistent_data(self) -> dict:
        """Persistent attr subset (reference ``GetPersistentData``)."""
        keep = self._type_desc.persistent_attrs
        return self.attrs.to_dict_with_filter(lambda k: k in keep)

    def get_client_data(self) -> dict:
        """Attrs visible to the entity's own client."""
        keep = self._type_desc.client_attrs
        return self.attrs.to_dict_with_filter(lambda k: k in keep)

    def get_all_clients_data(self) -> dict:
        """Attrs visible to other clients watching this entity."""
        keep = self._type_desc.all_client_attrs
        return self.attrs.to_dict_with_filter(lambda k: k in keep)

    # ------------------------------------------------------------------
    # timers (reference Entity.go:271-418)
    # ------------------------------------------------------------------
    def add_callback(self, delay: float, cb_or_method, *args) -> int:
        """One-shot timer. Pass a method NAME (str) for a migration/freeze-
        safe timer, or any callable for a local-only one."""
        tid = self.world.add_entity_timer(
            self, delay, 0.0, cb_or_method, args
        )
        self.timer_ids.add(tid)
        return tid

    def add_timer(self, interval: float, cb_or_method, *args) -> int:
        """Repeating timer (first fire after one interval)."""
        tid = self.world.add_entity_timer(
            self, interval, interval, cb_or_method, args
        )
        self.timer_ids.add(tid)
        return tid

    def cancel_timer(self, tid: int) -> None:
        self.timer_ids.discard(tid)
        self.world.timers.cancel(tid)

    # ------------------------------------------------------------------
    # RPC (reference Entity.go:442-540, EntityManager.go:399-434)
    # ------------------------------------------------------------------
    def call(self, entity_id: str, method: str, *args) -> None:
        """Location-transparent entity RPC."""
        self.world.call(entity_id, method, *args)

    def call_service(self, service_name: str, method: str, *args,
                     shard_key: str | None = None) -> None:
        self.world.call_service(
            service_name, method, *args, shard_key=shard_key
        )

    # ------------------------------------------------------------------
    # client management (reference Entity.go:678-765)
    # ------------------------------------------------------------------
    def set_client(self, client: GameClient | None) -> None:
        self.world.set_entity_client(self, client)

    def give_client_to(self, other: "Entity") -> None:
        """Transfer this entity's client to ``other``
        (reference ``GiveClientTo``, e.g. Account -> Avatar on login)."""
        c = self.client
        if c is None:
            return
        self.set_client(None)
        other.set_client(GameClient(c.gate_id, c.client_id, self.world))

    def call_client(self, method: str, *args) -> None:
        if self.client is not None:
            self.client.send({
                "type": "rpc", "eid": self.id, "method": method,
                "args": list(args),
            })

    def call_all_clients(self, method: str, *args) -> None:
        """RPC on this entity on every client that can see it (own client +
        clients of watchers, reference ``CallAllClients``)."""
        self.call_client(method, *args)
        for wid in self.interested_by:
            w = self.world.entities.get(wid)
            if w is not None and w.client is not None:
                w.client.send({
                    "type": "rpc", "eid": self.id, "method": method,
                    "args": list(args),
                })

    def call_filtered_clients(self, key: str, op: str, val: str,
                              method: str, *args) -> None:
        """Filtered broadcast (reference ``CallFilteredClients``,
        ``Entity.go:1150-1170``); resolved by the gateway filter index."""
        self.world.call_filtered_clients(key, op, val, method, args)

    def set_client_filter_prop(self, key: str, val) -> None:
        """Tag this entity's client in the gate's filter index (reference
        ``SetClientFilterProp``; used with :meth:`call_filtered_clients`,
        e.g. chatroom membership)."""
        if self.client is not None:
            self.client.send({
                "type": "filter_prop", "key": key, "val": str(val),
            })

    # ------------------------------------------------------------------
    # space / migration (reference Entity.go:956-1115)
    # ------------------------------------------------------------------
    def enter_space(self, space_id: str, pos) -> None:
        self.world.enter_space(self, space_id, pos)

    def destroy(self) -> None:
        if not self.destroyed:
            self.world.destroy_entity(self)

    def save(self) -> None:
        """Request async persistence of the persistent attr subset."""
        self.world.save_entity(self)

    # ------------------------------------------------------------------
    # lifecycle hooks (reference IEntity, Entity.go:100-120) — override me
    # ------------------------------------------------------------------
    def OnInit(self): ...
    def OnAttrsReady(self): ...
    def OnCreated(self): ...
    def OnRestored(self): ...
    def OnEnterSpace(self): ...
    def OnLeaveSpace(self, space: "Space"): ...
    def OnMigrateOut(self): ...
    def OnMigrateIn(self): ...
    def OnDestroy(self): ...
    def OnClientConnected(self): ...
    def OnClientDisconnected(self): ...
    def OnGameReady(self): ...
    def OnFreeze(self): ...

    def OnEnterAOI(self, other: "Entity"): ...
    def OnLeaveAOI(self, other: "Entity"): ...

    def __repr__(self) -> str:
        return f"<{self.type_name} {self.id}>"
