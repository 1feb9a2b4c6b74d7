"""unity_demo on the PyTorch/CUDA port: the same game as ``server.py``,
through ``goworld_tpu_torch`` (reference ``examples/unity_demo``): Player
with client-synced position and shooting, Monster with a 100 ms AI timer
hunting players over ``interested_in``, and a space that auto-summons
monsters (``MySpace.go:24-47``).

The stock ``goworld_tpu.ini`` runs unchanged, its WebSocket listener
(``ws_port``) included; ``gw.run()`` puts the World on the CUDA card.
Start the whole deployment with the port's ops CLI, which picks this
script over ``server.py``:
    python -m goworld_tpu_torch start examples/unity_demo
    python -m goworld_tpu_torch stop examples/unity_demo
"""

import random

import goworld_tpu_torch as gw


@gw.register_entity("Account")
class Account(gw.Entity):
    def Login_Client(self, name):
        player = self.world.create_entity("Player")
        player.attrs["name"] = name
        self.give_client_to(player)
        self.destroy()


@gw.register_entity("Player")
class Player(gw.Entity):
    ATTRS = {
        "name": "allclients",
        "hp": "allclients hot:0",
        "action": "allclients",
    }

    def OnAttrsReady(self):
        self.attrs["hp"] = 100
        self.attrs["action"] = "idle"

    def OnClientConnected(self):
        space = getattr(self.world, "_demo_space", None) \
            or self.world.nil_space
        self.enter_space(
            space.id, (random.uniform(30, 70), 0.0, random.uniform(30, 70))
        )

    def Shoot_Client(self, target_id):
        """Reference ``Player.go``: validate the target is visible, then
        damage it."""
        if target_id not in self.interested_in:
            return
        self.call(target_id, "TakeDamage", 10, self.id)

    def TakeDamage(self, amount, _attacker):
        hp = max(0, self.attrs.get("hp", 100) - amount)
        self.attrs["hp"] = hp
        if hp <= 0:
            self.attrs["action"] = "death"


@gw.register_entity("Monster")
class Monster(gw.Entity):
    ATTRS = {"hp": "allclients hot:0"}

    def OnEnterSpace(self):
        self.attrs["hp"] = 100
        self.set_moving(True)
        # reference Monster.go:32-100 — 100 ms AI tick
        self.add_timer(0.1, "AITick")

    def AITick(self):
        target = None
        for eid in self.interested_in:
            e = self.world.entities.get(eid)
            if e is not None and e.type_name == "Player" \
                    and e.attrs.get("hp", 0) > 0:
                target = e
                break
        if target is not None:
            self.call(target.id, "TakeDamage", 5, self.id)

    def TakeDamage(self, amount, attacker):
        hp = max(0, self.attrs.get("hp", 100) - amount)
        self.attrs["hp"] = hp
        if hp <= 0:
            self.set_moving(False)
            self.call_all_clients("OnDie", self.id)
            self.add_callback(2.0, "DoDestroy")

    def DoDestroy(self):
        self.destroy()


@gw.register_space("MySpace")
class MySpace(gw.Space):
    def OnSpaceCreated(self):
        # auto-summon monsters (reference MySpace.go:24-47)
        for _ in range(3):
            self.world.create_entity(
                "Monster", space=self,
                pos=(random.uniform(20, 80), 0.0, random.uniform(20, 80)),
            )


@gw.on_deployment_ready
def _create_demo_space():
    w = gw.world()
    if getattr(w, "_demo_space", None) is None:
        w._demo_space = gw.create_space("MySpace")


if __name__ == "__main__":
    gw.run()
