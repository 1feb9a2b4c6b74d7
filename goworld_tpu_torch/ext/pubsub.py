"""Publish/subscribe service — subject tree with trailing-``*`` wildcards.

The port's copy of ``goworld_tpu/ext/pubsub.py``, a port
:class:`~goworld_tpu_torch.entity.entity.Entity`.

Reference being rebuilt: ``ext/pubsub/PublishSubscribeService.go:34-130``:
a (shardable) service entity maintaining a subject trie; subscribers
register exact subjects or prefix wildcards (``"price.*"``); publishing
walks the trie and RPCs ``OnPublish`` on every subscriber entity. Shard by
subject (the reference example uses shard key = subject,
``examples/test_game/Avatar.go:53-55``) so one subject's fan-out stays on
one shard.

Usage::

    services.register("PublishSubscribeService", PublishSubscribeService,
                      shard_count=3)
    # from any entity:
    e.call_service("PublishSubscribeService", "Subscribe",
                   e.id, "chat.room1", shard_key="chat.room1")
    e.call_service("PublishSubscribeService", "Publish",
                   "chat.room1", "hello", shard_key="chat.room1")
    # subscriber entities implement OnPublish(subject, *args)
"""

from __future__ import annotations

from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.utils import log

logger = log.get("pubsub")

_SEP = "."
_WILDCARD = "*"


class _Node:
    __slots__ = ("children", "exact", "wildcard")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        self.exact: set[str] = set()      # subscriber eids on this subject
        self.wildcard: set[str] = set()   # subscribers of "<prefix>.*"


class PublishSubscribeService(Entity):
    """The service entity (register via ``ServiceManager.register``)."""

    def OnInit(self):
        self._root = _Node()

    # -- helpers ---------------------------------------------------------
    def _walk(self, parts: list[str], create: bool) -> _Node | None:
        node = self._root
        for p in parts:
            nxt = node.children.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = node.children[p] = _Node()
            node = nxt
        return node

    @staticmethod
    def _split(subject: str) -> tuple[list[str], bool]:
        """-> (path parts, is_wildcard). ``"a.b.*"`` -> ([a, b], True)."""
        parts = subject.split(_SEP)
        if parts and parts[-1] == _WILDCARD:
            return parts[:-1], True
        return parts, False

    # -- service RPCs (called via call_service) --------------------------
    def Subscribe(self, subscriber: str, subject: str):
        parts, wild = self._split(subject)
        node = self._walk(parts, create=True)
        (node.wildcard if wild else node.exact).add(subscriber)

    def Unsubscribe(self, subscriber: str, subject: str):
        parts, wild = self._split(subject)
        node = self._walk(parts, create=False)
        if node is not None:
            (node.wildcard if wild else node.exact).discard(subscriber)

    def UnsubscribeAll(self, subscriber: str):
        def rec(node: _Node) -> None:
            node.exact.discard(subscriber)
            node.wildcard.discard(subscriber)
            for c in node.children.values():
                rec(c)

        rec(self._root)

    def Publish(self, subject: str, *args):
        parts, wild = self._split(subject)
        if wild:
            logger.warning("cannot publish to wildcard subject %r", subject)
            return
        targets: set[str] = set()
        node = self._root
        for p in parts:
            # wildcard subscribers at every prefix level match
            targets |= node.wildcard
            node = node.children.get(p)
            if node is None:
                break
        else:
            # wildcard subs match strictly-longer subjects only: "a.*"
            # gets "a.b" (prefix loop above) but not "a" itself
            targets |= node.exact
        for eid in targets:
            self.call(eid, "OnPublish", subject, *args)
