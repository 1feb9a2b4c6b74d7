"""The port's pubsub service (``goworld_tpu_torch.ext.pubsub``) against
the JAX package's, on a World each (the port's on the CPU).

One script of Subscribe / Publish / Unsubscribe / UnsubscribeAll calls,
routed through each package's ServiceManager by the subject's first
segment (as ``examples/test_game`` routes them), runs on both sides with
the same listener ids; the ``OnPublish`` deliveries, each with its
listener, subject and arguments, are equal in content and order
(tolerance: exact). The cases of ``tests/test_services.py:103``
(exact and wildcard subscriptions, unsubscribe stops delivery) are
asserted on the port's deliveries as they are there.
"""

from __future__ import annotations

import pytest
import torch

from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.entity.entity import Entity as JEntity
from goworld_tpu.entity.manager import World as JWorld
from goworld_tpu.entity.service import ServiceManager as JServices
from goworld_tpu.ext.pubsub import PublishSubscribeService as JPubsub
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.entity.entity import Entity as TEntity
from goworld_tpu_torch.entity.manager import World as TWorld
from goworld_tpu_torch.entity.service import ServiceManager as TServices
from goworld_tpu_torch.ext.pubsub import PublishSubscribeService as TPubsub
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids as tids

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

GRID = dict(radius=10.0, extent_x=100.0, extent_z=100.0)
LISTENERS = [tids.gen_fixed_id(f"listener{i}") for i in range(6)]


class Side:
    """One package's World with the pubsub service and six listeners."""

    def __init__(self, pkg: str, shards: int):
        self.log: list = []
        log = self.log
        if pkg == "jax":
            Entity, Pubsub, services = JEntity, JPubsub, JServices
            self.w = JWorld(JConfig(capacity=64, grid=JGrid(**GRID)),
                            n_spaces=1, telemetry_live=False,
                            residency=False, audit=False)
        else:
            Entity, Pubsub, services = TEntity, TPubsub, TServices
            self.w = TWorld(TConfig(capacity=64, grid=TGrid(**GRID)),
                            n_spaces=1, telemetry_live=False,
                            residency=False, audit=False, device="cpu")

        class Listener(Entity):
            def OnInit(self):
                self.got = []

            def OnPublish(self, subject, *args):
                self.got.append((subject, args))
                log.append((self.id, subject, args))

        self.w.create_nil_space()
        self.sm = services(self.w, game_id=1)
        self.sm.register("Pubsub", Pubsub, shard_count=shards)
        self.w.register_entity("Listener", Listener)
        self.sm.start()
        self.w.tick()
        self.ls = [self.w.create_entity("Listener", eid=e)
                   for e in LISTENERS]

    def call(self, method: str, *args) -> None:
        subject = args[1] if method in ("Subscribe", "Unsubscribe") \
            else args[0]
        key = "" if method == "UnsubscribeAll" else subject.split(".")[0]
        self.sm.call("Pubsub", method, args, shard_key=key)

    def settle(self) -> list:
        """Two ticks (the service call, then the OnPublish calls); the
        deliveries since the last settle."""
        self.w.tick()
        self.w.tick()
        out = list(self.log)
        self.log.clear()
        return out


def _script(side: Side) -> list:
    """The calls, with the deliveries after each step."""
    L = [e.id for e in side.ls]
    steps = []
    for who, subject in ((0, "chat.room1"), (1, "chat.*"),
                         (2, "mail.inbox"), (3, "chat.room1.sub"),
                         (4, "chat.room1.*"), (5, "chat.room1"),
                         (5, "mail.*"), (3, "chat.*")):
        side.call("Subscribe", L[who], subject)
    steps.append(side.settle())
    for subject, args in (("chat.room1", ("hi",)), ("chat.*", ("wild",)),
                          ("chat", ("bare",)), ("chat.room1.sub",
                                                ("deep", 2)),
                          ("mail.inbox", ({"k": [1, 2]}, None)),
                          ("mail.other", (1.5,)), ("news.tpu", ())):
        side.call("Publish", subject, *args)
        steps.append(side.settle())
    side.call("Unsubscribe", L[0], "chat.room1")
    side.call("Unsubscribe", L[1], "nosuch.topic")
    side.call("Unsubscribe", L[3], "chat.*")
    side.settle()
    side.call("Publish", "chat.room1", "again")
    steps.append(side.settle())
    side.call("UnsubscribeAll", L[5])
    side.call("UnsubscribeAll", L[4])
    side.settle()
    for subject in ("chat.room1", "mail.inbox", "chat.room1.sub"):
        side.call("Publish", subject, "after")
        steps.append(side.settle())
    return steps


@pytest.mark.parametrize("shards", [1, 3])
def test_pubsub_script_delivers_alike(shards):
    jax_side, port_side = Side("jax", shards), Side("port", shards)
    want, got = _script(jax_side), _script(port_side)
    assert got == want
    assert sum(len(s) for s in got) > 0
    # each listener's own log is the same as well
    assert [e.got for e in port_side.ls] == [e.got for e in jax_side.ls]


def test_pubsub_exact_and_wildcard():
    """``tests/test_services.py:103`` on the port."""
    side = Side("port", 1)
    exact, wild, other = side.ls[:3]
    sm = side.sm
    sm.call("Pubsub", "Subscribe", (exact.id, "chat.room1"),
            shard_key="chat.room1")
    sm.call("Pubsub", "Subscribe", (wild.id, "chat.*"),
            shard_key="chat.room1")
    sm.call("Pubsub", "Subscribe", (other.id, "mail.inbox"),
            shard_key="chat.room1")
    side.w.tick()
    sm.call("Pubsub", "Publish", ("chat.room1", "hi"),
            shard_key="chat.room1")
    side.settle()
    assert exact.got == [("chat.room1", ("hi",))]
    assert wild.got == [("chat.room1", ("hi",))]
    assert other.got == []
    sm.call("Pubsub", "Unsubscribe", (exact.id, "chat.room1"),
            shard_key="chat.room1")
    side.w.tick()
    sm.call("Pubsub", "Publish", ("chat.room1", "again"),
            shard_key="chat.room1")
    side.settle()
    assert len(exact.got) == 1
    assert len(wild.got) == 2


def test_pubsub_split_and_wildcard_rules():
    """``_split`` and the matching rules, on both packages' service: a
    wildcard subscriber gets strictly longer subjects only, a wildcard
    publish delivers nothing."""
    for Pubsub in (JPubsub, TPubsub):
        assert Pubsub._split("a.b.*") == (["a", "b"], True)
        assert Pubsub._split("a.b") == (["a", "b"], False)
        assert Pubsub._split("*") == ([], True)
        assert Pubsub._split("") == ([""], False)
    side = Side("port", 1)
    a, b = side.ls[:2]
    side.call("Subscribe", a.id, "x.*")
    side.call("Subscribe", b.id, "x")
    side.settle()
    for subject in ("x", "x.y", "x.y.z", "x.*"):
        side.call("Publish", subject, 0)
    side.settle()
    assert a.got == [("x.y", (0,)), ("x.y.z", (0,))]
    assert b.got == [("x", (0,))]
