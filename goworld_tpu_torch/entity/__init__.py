"""Host-side entity programming model, the port of
``goworld_tpu/entity/``.

The GoWorld user model — entity classes with lifecycle hooks, reactive
attrs, timers, location-transparent RPC, spaces, migration
(``engine/entity/``) — kept as Python objects that *stage* their mutations
into per-tick device batches and receive AOI/sync events back from the
device step (:mod:`goworld_tpu_torch.core.step`).
"""

from goworld_tpu_torch.entity.attrs import AttrDelta, ListAttr, MapAttr
from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.manager import World
from goworld_tpu_torch.entity.registry import EntityTypeDesc, Registry
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.timer import Crontab, PostQueue, TimerQueue

__all__ = [
    "AttrDelta",
    "ListAttr",
    "MapAttr",
    "Entity",
    "GameClient",
    "World",
    "EntityTypeDesc",
    "Registry",
    "Space",
    "Crontab",
    "PostQueue",
    "TimerQueue",
]
