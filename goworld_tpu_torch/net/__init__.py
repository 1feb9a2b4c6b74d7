"""Networking: wire protocol, gate (client edge), dispatcher (router),
game server host, and the bot client harness.

Reference being rebuilt: ``engine/netutil`` (packet framing),
``engine/proto`` (message space), ``components/{dispatcher,gate}`` and the
game side of ``components/game`` (``GameService.go``), plus
``examples/test_client`` (bot swarm).

This package is the *between-process* layer — multiple game processes,
gates terminating client sockets over TCP, WebSocket and KCP (with TLS,
and snappy or zlib), and a sharded dispatcher router — kept host-side
exactly like the reference, with the hot sync-record path batched by a
native core. It is the port of ``goworld_tpu/net`` and puts the same
bytes on the wire.
"""
