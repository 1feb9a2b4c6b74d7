"""test_game on the PyTorch/CUDA port: the same game as ``server.py``,
through ``goworld_tpu_torch`` (reference ``examples/test_game``): Account
(login flow, ``Account.go:37-70``), Avatar (persistent player,
``Avatar.go:25-37``), AOITester (its own AOI distance), Monster (AI npc),
MySpace, OnlineService, SpaceService (3 shards, fills spaces up to a
cap, ``SpaceService.go:14,26-39``), MailService, and the port's pubsub
service (``goworld_tpu_torch.ext.pubsub``).

The stock ``goworld_tpu.ini`` runs unchanged (filesystem storage and
kvdb); ``gw.run()`` puts the World on the CUDA card. For a networked
store set ``[storage] kind = mongodb`` with ``directory =
host:port/db`` and ``[kvdb] kind = redis_cluster`` with ``path =
host:port,host:port,...`` (or ``redis``, ``mongodb``). Start the whole
deployment with the port's ops CLI, which picks this script over
``server.py``:
    python -m goworld_tpu_torch start examples/test_game
    python -m goworld_tpu_torch stop examples/test_game
"""

import random

import goworld_tpu_torch as gw
from goworld_tpu_torch.ext.pubsub import PublishSubscribeService

_MAX_AVATARS_PER_SPACE = 100  # reference SpaceService.go:14


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "ready"

    def Login_Client(self, name):
        """kvdb-mapped login: one Avatar per name (reference
        ``Account.go:37-70``)."""

        def got(avatar_id, _err=None):
            if self.destroyed or self.client is None:
                return
            if avatar_id:
                existing = self.world.entities.get(avatar_id)
                if existing is not None:
                    self._handoff(existing)
                    return
                avatar = self.world.create_entity("Avatar", eid=avatar_id)
                avatar.attrs["name"] = name
                self._handoff(avatar)
            else:
                avatar = self.world.create_entity("Avatar")
                avatar.attrs["name"] = name
                try:
                    gw.kvdb_put(f"avatarOf/{name}", avatar.id,
                                lambda *_: None)
                except RuntimeError:
                    pass
                self._handoff(avatar)

        try:
            gw.kvdb_get(f"avatarOf/{name}", got)
        except RuntimeError:  # standalone World without run(): no kvdb
            got(None)

    def _handoff(self, avatar):
        self.give_client_to(avatar)
        self.destroy()


@gw.register_entity("Avatar", persistent=True)
class Avatar(gw.Entity):
    ATTRS = {
        "name": "allclients persistent",
        "level": "client persistent",
        "exp": "client persistent",
        "hp": "allclients",
    }

    def OnAttrsReady(self):
        self.attrs.setdefault("level", 1)
        self.attrs.setdefault("exp", 0)
        self.attrs["hp"] = 100

    def OnClientConnected(self):
        self.call_service("OnlineService", "NotifyOnline", self.id,
                          shard_key=self.id)
        self.call_service("SpaceService", "EnterSpace", self.id,
                          shard_key=self.id)

    def OnClientDisconnected(self):
        self.call_service("OnlineService", "NotifyOffline", self.id,
                          shard_key=self.id)
        self.destroy()

    def DoEnterSpace(self, space_id):
        """Called back by SpaceService with the assigned space."""
        self.enter_space(
            space_id,
            (random.uniform(10, 90), 0.0, random.uniform(10, 90)),
        )

    def Say_Client(self, text):
        self.call_all_clients("OnSay", self.id, text)

    def SendMail_Client(self, to_name, text):
        self.call_service("MailService", "SendMail",
                          self.attrs.get("name"), to_name, text,
                          shard_key=to_name)

    def Subscribe_Client(self, subject):
        # shard by the subject's first segment so a wildcard subscription
        # ("news.*") and the publishes it matches ("news.tpu") always land
        # on the same Pubsub shard
        self.call_service("Pubsub", "Subscribe", self.id, subject,
                          shard_key=subject.split(".")[0])

    def Publish_Client(self, subject, *args):
        self.call_service("Pubsub", "Publish", subject, *args,
                          shard_key=subject.split(".")[0])

    def OnPublish(self, subject, *args):
        # relay pubsub deliveries to the owning client
        self.call_client("OnPublish", subject, *args)

    def OnGainExp(self, amount):
        self.attrs["exp"] = self.attrs.get("exp", 0) + amount
        if self.attrs["exp"] >= self.attrs.get("level", 1) * 10:
            self.attrs["exp"] = 0
            self.attrs["level"] = self.attrs.get("level", 1) + 1
        self.save()


@gw.register_entity("AOITester", aoi_distance=100.0)
class AOITester(gw.Entity):
    """Reference ``examples/test_game/AOITester.go``: an entity type with
    its OWN AOI distance (SetUseAOI(true, 100)) — exercises the per-type
    ``aoi_distance`` honored by the grid sweep's watch_radius path."""

    ATTRS = {"name": "allclients"}


@gw.register_entity("Monster")
class Monster(gw.Entity):
    ATTRS = {"hp": "allclients hot:0"}

    def OnEnterSpace(self):
        self.attrs["hp"] = 50
        self.set_moving(True)  # device-side random walk
        self.add_timer(0.1, "AITick")  # reference Monster 100ms AI timer

    def AITick(self):
        # attack a random nearby avatar (InterestedIn sweep like the
        # reference unity_demo Monster)
        for eid in self.interested_in:
            e = self.world.entities.get(eid)
            if e is not None and e.type_name == "Avatar":
                self.call(eid, "OnGainExp", 1)
                break


@gw.register_space("MySpace")
class MySpace(gw.Space):
    ATTRS = {"kind": "allclients"}

    def OnSpaceCreated(self):
        for _ in range(4):
            self.world.create_entity(
                "Monster", space=self,
                pos=(random.uniform(20, 80), 0.0, random.uniform(20, 80)),
            )


@gw.register_service("OnlineService", shard_count=3)
class OnlineService(gw.Entity):
    def OnInit(self):
        self.online: set[str] = set()

    def NotifyOnline(self, avatar_id):
        self.online.add(avatar_id)

    def NotifyOffline(self, avatar_id):
        self.online.discard(avatar_id)


@gw.register_service("SpaceService", shard_count=3)
class SpaceService(gw.Entity):
    """Assigns avatars to spaces, filling the fullest below the cap
    (reference ``SpaceService.go:26-39``)."""

    def OnInit(self):
        self.space_loads: dict[str, int] = {}

    def EnterSpace(self, avatar_id):
        best, best_n = None, -1
        for sid, n in self.space_loads.items():
            if n < _MAX_AVATARS_PER_SPACE and n > best_n \
                    and sid in self.world.spaces:
                best, best_n = sid, n
        if best is None:
            sp = self.world.create_space("MySpace", kind=1)
            best = sp.id
            self.space_loads[best] = 0
        self.space_loads[best] += 1
        self.call(avatar_id, "DoEnterSpace", best)


@gw.register_service("MailService", shard_count=1)
class MailService(gw.Entity):
    def OnInit(self):
        self.mails: dict[str, list] = {}

    def SendMail(self, from_name, to_name, text):
        self.mails.setdefault(to_name, []).append([from_name, text])


gw.register_service("Pubsub", PublishSubscribeService, shard_count=3)


if __name__ == "__main__":
    gw.run()
