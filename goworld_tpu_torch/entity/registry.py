"""Entity type registry: attr schemas, RPC descriptors, hot-attr columns;
the port's copy of ``goworld_tpu/entity/registry.py``.

Reference being rebuilt: ``engine/entity/EntityManager.go:24-101``
(``EntityTypeDesc`` with persistent flag, AOI distance, Client/AllClients/
Persistent attr-def sets) and ``engine/entity/rpc_desc.go`` (method-suffix
RPC permission flags: ``Foo`` server-only, ``Foo_Client`` callable by the
entity's own client, ``Foo_AllClients`` callable by any client).

The reference discovers methods via Go reflection at register time
(``rpcDescMap.visit``, ``rpc_desc.go:23-48``); here we walk the Python class
once at registration. Declarative additions for the device split: ``hot_attrs``
maps attr names onto SoA ``hot_attrs`` columns so device kernels can read
them (:mod:`goworld_tpu_torch.core.state`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Type

# RPC permission flags (reference rfServer/rfOwnClient/rfOtherClient,
# rpc_desc.go:8-12)
RF_SERVER = 1 << 0
RF_OWN_CLIENT = 1 << 1
RF_OTHER_CLIENT = 1 << 2

CLIENT_SUFFIX = "_Client"
ALL_CLIENTS_SUFFIX = "_AllClients"

_LIFECYCLE = frozenset(
    n for n in (
        "OnInit", "OnAttrsReady", "OnCreated", "OnDestroy", "OnEnterSpace",
        "OnLeaveSpace", "OnMigrateOut", "OnMigrateIn", "OnClientConnected",
        "OnClientDisconnected", "OnEnterAOI", "OnLeaveAOI", "OnGameReady",
        "OnRestored", "OnFreeze", "DescribeEntityType",
    )
)


@dataclasses.dataclass
class RpcDesc:
    name: str
    flags: int
    n_args: int  # positional arg count (excluding self); -1 = varargs


@dataclasses.dataclass
class EntityTypeDesc:
    """Everything the framework knows about a registered entity type."""

    name: str
    cls: Type
    is_space: bool = False
    is_persistent: bool = False
    use_aoi: bool = True
    aoi_distance: float = 0.0
    # space types only: one instance spans ALL mesh shards as spatial
    # tiles (parallel.megaspace) instead of pinning to a single shard
    megaspace: bool = False
    client_attrs: frozenset = frozenset()
    all_client_attrs: frozenset = frozenset()
    persistent_attrs: frozenset = frozenset()
    # attr name -> SoA hot_attrs column index (device-visible scalars)
    hot_attrs: dict = dataclasses.field(default_factory=dict)
    # the reverse (column -> (attr name, audience)), precomputed once:
    # the device hot-attr delta decode runs per record on the per-tick
    # host path and must not scan hot_attrs.items() or re-derive
    # audience_of each time
    hot_attr_by_col: dict = dataclasses.field(default_factory=dict)
    rpc_descs: dict = dataclasses.field(default_factory=dict)
    type_id: int = 0  # device type_id column value (registration order)

    def audience_of(self, root_key: str) -> str | None:
        """'client' | 'all_clients' | None for a root attr key."""
        if root_key in self.all_client_attrs:
            return "all_clients"
        if root_key in self.client_attrs:
            return "client"
        return None


def _visit_rpc_methods(cls: Type) -> dict[str, RpcDesc]:
    """Walk public methods and derive RPC descriptors (suffix rules)."""
    descs: dict[str, RpcDesc] = {}
    for name, fn in inspect.getmembers(cls, callable):
        if name.startswith("_") or name in _LIFECYCLE:
            continue
        flags = RF_SERVER
        if name.endswith(ALL_CLIENTS_SUFFIX):
            flags |= RF_OWN_CLIENT | RF_OTHER_CLIENT
        elif name.endswith(CLIENT_SUFFIX):
            flags |= RF_OWN_CLIENT
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            continue
        params = [
            p for p in sig.parameters.values()
            if p.name != "self" and p.kind in (
                p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
            )
        ]
        var = any(
            p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()
        )
        descs[name] = RpcDesc(name, flags, -1 if var else len(params))
    return descs


class Registry:
    """Type-name -> EntityTypeDesc (reference ``registeredEntityTypes``)."""

    def __init__(self):
        self._types: dict[str, EntityTypeDesc] = {}

    def register(
        self,
        name: str,
        cls: Type,
        *,
        is_space: bool = False,
        persistent: bool = False,
        use_aoi: bool = True,
        aoi_distance: float = 0.0,
        megaspace: bool = False,
    ) -> EntityTypeDesc:
        if megaspace and not is_space:
            raise ValueError(f"{name!r}: megaspace=True requires a space type")
        if name in self._types:
            raise ValueError(f"entity type {name!r} already registered")
        # attr declarations come from class attributes, mirroring the
        # reference's DescribeEntityType(desc) hook where entity classes
        # call desc.DefineAttr(name, "Client", "Persistent", ...)
        client, all_clients, persist = set(), set(), set()
        hot: dict[str, int] = {}
        for attr_name, spec in getattr(cls, "ATTRS", {}).items():
            flags = {f.strip().lower() for f in spec.split() if f.strip()} \
                if isinstance(spec, str) else set(spec)
            flags = {str(f).lower() for f in flags}
            for f in list(flags):
                if f.startswith("hot:"):
                    hot[attr_name] = int(f.split(":", 1)[1])
                    flags.discard(f)
            if "allclients" in flags or "all_clients" in flags:
                all_clients.add(attr_name)
                client.add(attr_name)  # AllClients implies own client too
            elif "client" in flags:
                client.add(attr_name)
            if "persistent" in flags:
                persist.add(attr_name)
        desc = EntityTypeDesc(
            name=name,
            cls=cls,
            is_space=is_space,
            is_persistent=persistent or bool(persist),
            use_aoi=use_aoi,
            aoi_distance=aoi_distance,
            megaspace=megaspace,
            client_attrs=frozenset(client),
            all_client_attrs=frozenset(all_clients),
            persistent_attrs=frozenset(persist),
            hot_attrs=hot,
            hot_attr_by_col={
                c: (a, "all_clients" if a in all_clients
                    else "client" if a in client else None)
                for a, c in hot.items()
            },
            rpc_descs=_visit_rpc_methods(cls),
            type_id=len(self._types),
        )
        self._types[name] = desc
        cls._type_desc = desc
        return desc

    def get(self, name: str) -> EntityTypeDesc:
        try:
            return self._types[name]
        except KeyError:
            raise KeyError(f"entity type {name!r} not registered") from None

    def __contains__(self, name: str) -> bool:
        return name in self._types

    def type_id(self, name: str) -> int:
        """Stable small int for the device ``type_id`` column."""
        return self._types[name].type_id

    def name_of(self, type_id: int) -> str:
        for name, desc in self._types.items():
            if desc.type_id == type_id:
                return name
        raise KeyError(type_id)
