"""Space — an entity subtype owning a member set and (optionally) a device
shard with AOI; the port's copy of ``goworld_tpu/entity/space.py``.

Reference being rebuilt: ``engine/entity/Space.go`` (space = entity owning
members + AOI manager; ``EnableAOI`` ``Space.go:91-106``; enter/leave/move
``:179-252``), ``SpaceManager.go``, and the per-game nil space
(``space_ops.go:33-47``) that anchors entities not in any real space.

Device mapping: an AOI-enabled Space is pinned to one shard of the stacked
device state (this port runs one shard on one card); its
members' hot state lives in that shard's SoA rows. Non-AOI spaces (the nil
space, pure service/lobby spaces) are host-only — no device rows, no AOI
sweep, zero device cost.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

from goworld_tpu_torch.entity.entity import Entity

if TYPE_CHECKING:
    pass


class Space(Entity):
    """Base space class (subclass and register with ``is_space=True``)."""

    def __init__(self):
        super().__init__()
        self.members: set[str] = set()
        self.shard: int | None = None  # device shard index; None = host-only
        # megaspace: this ONE logical space spans every shard of the mesh
        # as spatial tiles (parallel.megaspace); members' device addresses
        # are per-entity (Entity.shard = current tile), not per-space.
        # Removes the reference's one-space-per-process population ceiling
        # (SpaceService.go:14 caps spaces at 100 avatars in user code).
        self.is_mega = False
        self.is_nil_space = False

    @property
    def use_aoi(self) -> bool:
        return self.shard is not None or self.is_mega

    def count_entities(self, type_name: str | None = None) -> int:
        """Reference ``CountEntities`` (``Space.go:273-281``)."""
        if type_name is None:
            return len(self.members)
        n = 0
        for eid in self.members:
            e = self.world.entities.get(eid)
            if e is not None and e.type_name == type_name:
                n += 1
        return n

    def for_each_entity(self) -> Iterator[Entity]:
        """Reference ``ForEachEntity`` (``Space.go:283-293``)."""
        for eid in list(self.members):
            e = self.world.entities.get(eid)
            if e is not None:
                yield e

    def create_entity(self, type_name: str, pos=(0.0, 0.0, 0.0), **kw):
        """Create an entity directly into this space."""
        return self.world.create_entity(type_name, space=self, pos=pos, **kw)

    # hooks (reference ISpace.go:6-18) — override me
    def OnSpaceInit(self): ...
    def OnSpaceCreated(self): ...
    def OnSpaceDestroy(self): ...
    def OnEntityEnterSpace(self, entity: Entity): ...
    def OnEntityLeaveSpace(self, entity: Entity): ...
    def OnGameReady(self): ...
