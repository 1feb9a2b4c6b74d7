"""Multihost demo on the PyTorch/CUDA port: the same game as
``server.py``, through ``goworld_tpu_torch``.

``[game1] mesh_processes = 2`` makes the ops CLI run THIS script as two
SPMD controller processes over one 8-shard mesh (4 tiles each, both on
the one CUDA card): one logical game spanning both. The controllers
form a ``torch.distributed`` group over gloo
(``goworld_tpu_torch.parallel.multihost``); the halo legs, the
migration exchange and the mutation log that cross between them go
through it.

    python -m goworld_tpu_torch start examples/multihost_demo

World population happens in ``@gw.on_boot`` — the SPMD-safe hook that
runs before the network/ticks, so every controller creates the identical
world (``on_deployment_ready`` fires at different wall instants per
controller and must not mutate a multi-controller world). The login
Avatar is placed on the SECOND controller's half of the world: its
create/sync traffic reaches the client through the dispatcher wire
(cross-controller client visibility).
"""

import numpy as np

import goworld_tpu_torch as gw


@gw.register_space("World", megaspace=True)
class World(gw.Space):
    pass


@gw.register_entity("Monster")
class Monster(gw.Entity):
    ATTRS = {"hp": "allclients"}


@gw.register_entity("Avatar")
class Avatar(gw.Entity):
    ATTRS = {"name": "allclients"}


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"

    def Login_Client(self, name):
        # look the megaspace up by type, never via an attribute only
        # on_boot sets: after a -restore boot (reload OR watchdog crash
        # recovery) on_boot is skipped and the space came from the
        # snapshot
        world = gw.world()
        sp = next(
            s for s in world.spaces.values() if s.type_name == "World"
        )
        # x=600 of the 800-wide world = the second controller's half
        avatar = gw.create_entity(
            "Avatar", space=sp, pos=(600.0, 0.0, 200.0),
        )
        avatar.attrs["name"] = name
        self.give_client_to(avatar)
        self.destroy()


@gw.on_boot
def populate(world):
    sp = world.create_space("World")
    world._mega_space = sp
    rng = np.random.default_rng(7)   # same seed => identical world on
    for _ in range(400):             # every controller (SPMD contract)
        world.create_entity(
            "Monster", space=sp, moving=True,
            pos=(float(rng.uniform(0, 800)), 0.0,
                 float(rng.uniform(0, 400))),
            attrs={"hp": 100},
        )


if __name__ == "__main__":
    gw.run()
