"""Megaspace demo on the PyTorch/CUDA port: the same game as
``server.py``, through ``goworld_tpu_torch``.

ONE logical space spans the mesh's shards as XZ tiles (``megaspace =
true``, ``mega_shape = 4x2`` over ``mesh_devices = 8`` in the ini): AOI
sees across tile borders through the halo exchange, and entities that
walk over a border change tile inside the step. On the port every tile
lives on one CUDA card (``goworld_tpu_torch.parallel.mesh.make_mesh``).

Run it with dispatchers and a gate up (``[dispatcherN]`` and
``[gate1]`` in the ini):
    python examples/megaspace_demo/server_torch.py \\
        -gid 1 -configfile examples/megaspace_demo/goworld_tpu.ini
"""

import goworld_tpu_torch as gw


@gw.register_space("World", megaspace=True)
class World(gw.Space):
    def OnGameReady(self):
        pass


@gw.register_entity("Monster")
class Monster(gw.Entity):
    ATTRS = {"hp": "allclients"}


@gw.register_entity("Avatar")
class Avatar(gw.Entity):
    ATTRS = {"name": "allclients"}

    def OnClientConnected(self):
        self.attrs["name"] = "hero"


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def Login_Client(self, name):
        avatar = gw.create_entity(
            "Avatar", space=gw.world()._mega_space, pos=(400.0, 0.0, 200.0)
        )
        avatar.attrs["name"] = name
        self.give_client_to(avatar)
        self.destroy()


@gw.on_deployment_ready
def setup():
    import numpy as np

    w = gw.world()
    sp = gw.create_space("World")
    w._mega_space = sp
    rng = np.random.default_rng(7)
    for _ in range(200):
        gw.create_entity(
            "Monster", space=sp, moving=True,
            pos=(rng.uniform(0, 800), 0.0, rng.uniform(0, 400)),
            attrs={"hp": 100},
        )


if __name__ == "__main__":
    gw.run()
