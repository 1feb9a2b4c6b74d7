"""nil_game on the PyTorch/CUDA port: the same minimal game as
``server.py``, through ``goworld_tpu_torch`` — boot entities only
(reference ``examples/nil_game``, ``nil_game.go:1-13``).

The stock ``goworld_tpu.ini`` runs unchanged; ``gw.run()`` puts the
World on the CUDA card. Start the whole deployment with the port's ops
CLI, which picks this script over ``server.py``:
    python -m goworld_tpu_torch start examples/nil_game
    python -m goworld_tpu_torch stop examples/nil_game
"""

import goworld_tpu_torch as gw


@gw.register_entity("Account")
class Account(gw.Entity):
    ATTRS = {"status": "client"}

    def OnClientConnected(self):
        self.attrs["status"] = "online"


if __name__ == "__main__":
    gw.run()
