"""chatroom_demo on the PyTorch/CUDA port: the same game as
``server.py``, through ``goworld_tpu_torch`` (reference
``examples/chatroom_demo``): avatars join numbered rooms via a client
filter prop and chat via ``call_filtered_clients``.

The stock ``goworld_tpu.ini`` runs unchanged; ``gw.run()`` puts the
World on the CUDA card. Start the whole deployment with the port's ops
CLI, which picks this script over ``server.py``:
    python -m goworld_tpu_torch start examples/chatroom_demo
    python -m goworld_tpu_torch stop examples/chatroom_demo
"""

import goworld_tpu_torch as gw


@gw.register_entity("Account")
class Account(gw.Entity):
    def Login_Client(self, name):
        avatar = self.world.create_entity("ChatAvatar")
        avatar.attrs["name"] = name
        self.give_client_to(avatar)
        self.destroy()


@gw.register_entity("ChatAvatar")
class ChatAvatar(gw.Entity):
    ATTRS = {"name": "allclients", "room": "client"}

    def OnClientConnected(self):
        self.EnterRoom_Client(1)

    def EnterRoom_Client(self, room):
        """Reference ``Avatar.go:33-50``: SetClientFilterProp("chatroom", n)."""
        self.attrs["room"] = int(room)
        self.set_client_filter_prop("chatroom", str(int(room)))

    def Say_Client(self, text):
        self.call_filtered_clients(
            "chatroom", "=", str(self.attrs.get("room", 1)),
            "OnRoomSay", self.attrs.get("name"), text,
        )

    def Shout_Client(self, text):
        # all rooms >= 1, i.e. everyone
        self.call_filtered_clients(
            "chatroom", ">=", "0", "OnRoomSay",
            self.attrs.get("name"), f"(shout) {text}",
        )


if __name__ == "__main__":
    gw.run()
