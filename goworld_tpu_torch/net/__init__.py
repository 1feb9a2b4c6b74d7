"""Networking: wire protocol, gate (client edge), dispatcher (router),
game server host, and the bot client harness.

Reference being rebuilt: ``engine/netutil`` (packet framing),
``engine/proto`` (message space), ``components/{dispatcher,gate}`` and the
game side of ``components/game`` (``GameService.go``), plus
``examples/test_client`` (bot swarm).

This package is the *between-process* layer — multiple game processes,
gates terminating client sockets over TCP (with TLS and zlib), and a
sharded dispatcher router — kept host-side exactly like the reference,
with the hot sync-record path batched into numpy arrays. It is the port
of ``goworld_tpu/net`` and puts the same bytes on the wire; the KCP and
WebSocket edges and the snappy codec are not ported yet (ROADMAP.md
Queue A item 8).
"""
