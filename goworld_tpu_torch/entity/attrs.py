"""Reactive attribute trees with path-delta journaling, the port's copy
of ``goworld_tpu/entity/attrs.py``.

Reference being rebuilt: ``engine/entity/{MapAttr,ListAttr,attr}.go`` — a
tree-shaped attribute store where every mutation computes its path from the
owning entity's root and emits a client-sync message; per-key flags on the
ROOT key decide the audience (own Client vs AllClients) and persistence
(``attr.go:5-36``, fan-out ``Entity.go:814-917``).

Device-first deviation: mutations never send packets directly. They append
``AttrDelta`` records to the owning entity's journal; the world loop drains
journals once per tick and hands them to the gateway in one batch (the same
batching shape as the device's hot-attr delta array,
:func:`goworld_tpu_torch.ops.sync.collect_attr_deltas`). Hot attrs (declared
``hot=<col>`` in the type's attr defs) additionally mirror into the SoA
``hot_attrs`` block so device kernels can read them.
"""

from __future__ import annotations

import numbers
from typing import Any, Callable, Iterator, NamedTuple

# journal ops
OP_SET = "set"
OP_DEL = "del"
OP_APPEND = "append"
OP_POP = "pop"
OP_INSERT = "insert"


class AttrDelta(NamedTuple):
    """One attribute mutation, addressed by path from the entity root.

    A NamedTuple (not a dataclass): deltas are constructed per mutation
    on the per-tick host path — device hot-attr decode journals one per
    record at attr_sync_cap volumes — and tuple construction is ~2x a
    dataclass ``__init__``."""

    path: tuple  # (key, key-or-index, ...) root-first
    op: str
    value: Any = None  # plain python (trees converted via to_plain)


def uniform_attr_type(v: Any) -> Any:
    """Canonicalize value types like the reference's ``uniformAttrType``
    (``attr.go:38-73``): ints -> int, floats -> float, bool/str/None pass,
    dict/list promote to MapAttr/ListAttr."""
    if isinstance(v, (MapAttr, ListAttr)) or v is None:
        return v
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, numbers.Integral):   # numpy ints etc.
        return int(v)
    if isinstance(v, numbers.Real):       # numpy floats etc.
        return float(v)
    if isinstance(v, bytes):
        return v
    if isinstance(v, dict):
        m = MapAttr()
        m.assign_map(v)
        return m
    if isinstance(v, (list, tuple)):
        l = ListAttr()
        for x in v:
            l.append(x)
        return l
    raise TypeError(f"unsupported attr value type: {type(v)!r}")


class _Node:
    """Shared parent/path machinery for MapAttr and ListAttr."""

    __slots__ = ("parent", "pkey", "_root_cb")

    def __init__(self):
        self.parent: _Node | None = None
        self.pkey: Any = None  # key (map) or index (list) under parent
        # set on the ROOT node only: callable(AttrDelta) -> None
        self._root_cb: Callable[[AttrDelta], None] | None = None

    def _path_from_root(self) -> tuple:
        """Reference ``getPathFromOwner`` (``attr.go:12-36``)."""
        parts = []
        node: _Node | None = self
        while node is not None and node.parent is not None:
            parts.append(node.pkey)
            node = node.parent
        parts.reverse()
        return tuple(parts)

    def _emit(self, rel_path: tuple, op: str, value: Any) -> None:
        node: _Node = self
        while node.parent is not None:
            node = node.parent
        if node._root_cb is not None:
            node._root_cb(
                AttrDelta(self._path_from_root() + rel_path, op, value)
            )

    def _adopt(self, child: Any, key: Any) -> None:
        if isinstance(child, _Node):
            if child.parent is not None or child._root_cb is not None:
                # reference panics on re-parenting (``MapAttr.go:84-115``):
                # an attr tree node belongs to exactly one place
                raise ValueError(
                    "attr node already attached elsewhere; assign a copy "
                    "(to_dict/to_list) instead"
                )
            child.parent = self
            child.pkey = key

    def _orphan(self, child: Any) -> None:
        if isinstance(child, _Node):
            child.parent = None
            child.pkey = None


def to_plain(v: Any) -> Any:
    if isinstance(v, MapAttr):
        return v.to_dict()
    if isinstance(v, ListAttr):
        return v.to_list()
    return v


class MapAttr(_Node):
    """Dict-shaped reactive attr node (reference ``MapAttr.go``)."""

    __slots__ = ("_d",)

    def __init__(self):
        super().__init__()
        self._d: dict[str, Any] = {}

    # -- mutation ---------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        value = uniform_attr_type(value)
        old = self._d.get(key)
        self._orphan(old)
        self._adopt(value, key)
        self._d[key] = value
        self._emit((key,), OP_SET, to_plain(value))

    __setitem__ = set

    def set_default(self, key: str, value: Any) -> Any:
        if key not in self._d:
            self.set(key, value)
        return self._d[key]

    def delete(self, key: str) -> None:
        old = self._d.pop(key)
        self._orphan(old)
        self._emit((key,), OP_DEL, None)

    __delitem__ = delete

    def assign_map(self, d: dict) -> None:
        for k, v in d.items():
            self.set(k, v)

    # -- access -----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def setdefault(self, key: str, default: Any) -> Any:
        """Set-if-absent (journals only when it actually sets)."""
        if key not in self._d:
            self.set(key, default)
        return self._d[key]

    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._d.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._d.get(key, default))

    def get_str(self, key: str, default: str = "") -> str:
        return str(self._d.get(key, default))

    def get_map(self, key: str) -> "MapAttr":
        return self.set_default(key, MapAttr())

    def get_list(self, key: str) -> "ListAttr":
        return self.set_default(key, ListAttr())

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    # -- conversion -------------------------------------------------------
    def to_dict(self) -> dict:
        return {k: to_plain(v) for k, v in self._d.items()}

    def to_dict_with_filter(self, keep: Callable[[str], bool]) -> dict:
        """Reference ``ToMapWithFilter`` — used to extract the persistent
        subset at save time (``Entity.go:164-177``)."""
        return {k: to_plain(v) for k, v in self._d.items() if keep(k)}

    def __repr__(self) -> str:
        return f"MapAttr({self.to_dict()!r})"


class ListAttr(_Node):
    """List-shaped reactive attr node (reference ``ListAttr.go``)."""

    __slots__ = ("_l",)

    def __init__(self):
        super().__init__()
        self._l: list[Any] = []

    def _reindex(self, start: int) -> None:
        for i in range(start, len(self._l)):
            v = self._l[i]
            if isinstance(v, _Node):
                v.pkey = i

    # -- mutation ---------------------------------------------------------
    def append(self, value: Any) -> None:
        value = uniform_attr_type(value)
        self._adopt(value, len(self._l))
        self._l.append(value)
        self._emit((), OP_APPEND, to_plain(value))

    def set(self, idx: int, value: Any) -> None:
        value = uniform_attr_type(value)
        self._orphan(self._l[idx])
        self._adopt(value, idx)
        self._l[idx] = value
        self._emit((idx,), OP_SET, to_plain(value))

    __setitem__ = set

    def pop(self, idx: int = -1) -> Any:
        v = self._l.pop(idx)
        self._orphan(v)
        if idx != -1:
            self._reindex(idx if idx >= 0 else len(self._l) + idx + 1)
        self._emit((), OP_POP, idx)
        return to_plain(v)

    def insert(self, idx: int, value: Any) -> None:
        value = uniform_attr_type(value)
        self._l.insert(idx, value)
        self._adopt(value, idx)
        self._reindex(idx)
        self._emit((idx,), OP_INSERT, to_plain(value))

    # -- access -----------------------------------------------------------
    def __getitem__(self, idx: int) -> Any:
        return self._l[idx]

    def __len__(self) -> int:
        return len(self._l)

    def __iter__(self):
        return iter(self._l)

    def to_list(self) -> list:
        return [to_plain(v) for v in self._l]

    def __repr__(self) -> str:
        return f"ListAttr({self.to_list()!r})"


def make_root(cb: Callable[[AttrDelta], None]) -> MapAttr:
    """Create an entity's root attr map wired to its delta journal."""
    root = MapAttr()
    root._root_cb = cb
    return root


def sever_tree(node: Any) -> None:
    """Clear every back-reference in an attr tree (child ``parent``
    pointers and the root's journal callback, whose closure holds the
    entity). A discarded tree then frees by plain refcounting — required
    for entities in the GC's permanent generation (the game logic
    loop's default ``gc.freeze`` boot discipline, ``net/game.py``),
    which the cyclic collector never revisits. Reads on a severed tree
    still work; mutations no longer journal."""
    if isinstance(node, MapAttr):
        children = node._d.values()
    elif isinstance(node, ListAttr):
        children = node._l
    else:
        return
    node._root_cb = None
    node.parent = None
    for v in children:
        sever_tree(v)


def load_into(root: MapAttr, data: dict) -> None:
    """Populate a root silently (no journal) — restore/load path, mirroring
    the reference's quiet attr assignment on load (``EntityManager.go:246``).
    """
    cb = root._root_cb
    root._root_cb = None
    try:
        root.assign_map(data)
    finally:
        root._root_cb = cb
