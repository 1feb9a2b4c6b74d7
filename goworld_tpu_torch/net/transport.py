"""Client-edge transport hardening: TLS contexts + self-signed certs.

Reference parity: the gate optionally wraps every client connection in TLS
(``components/gate/ClientProxy.go:38-53``; cert/key shipped as ``rsa.crt``
/ ``rsa.key`` at the repo root, ini flags ``encrypt_connection``) and
snappy compression. Here TLS rides stdlib ``ssl`` over asyncio; stream
compression defaults to SNAPPY — the reference's codec, implemented from
scratch (block + framing formats, :mod:`goworld_tpu_torch.net.snappy`, C++
core in ``native/snappy_core.cpp``) — with zlib-1 selectable per ini
(``compress_codec``) for deployments that prefer its shared-dictionary
ratio on tiny packets.

The third client transport, KCP (reliable-UDP tuned for latency,
``GateService.go:129-161``), is implemented from scratch in
:mod:`goworld_tpu_torch.net.kcp` — same wire protocol as the reference's
kcp-go dependency, adapted to the (reader, writer) seam so
PacketConnection runs unchanged over it.

Fault injection (:mod:`goworld_tpu_torch.utils.faults`, docs/ROBUSTNESS.md)
wraps these boundaries one layer up: wire faults apply at
``PacketConnection.send`` above the TLS/compression stream (tampering
inside a negotiated stream would model a codec bug, not a network
fault), and the KCP edge drops whole datagrams through
``KcpServer``'s ``loss_hook`` so the ARQ path is what gets exercised.
"""

from __future__ import annotations

import os
import ssl
import subprocess

from goworld_tpu_torch.utils import log

logger = log.get("transport")


def ensure_self_signed_cert(cert_path: str, key_path: str,
                            cn: str = "goworld-tpu-gate") -> None:
    """Generate a self-signed cert/key pair if absent (the reference
    ships one in-repo; generating on first use avoids committing private
    keys)."""
    if os.path.exists(cert_path) and os.path.exists(key_path):
        return
    os.makedirs(os.path.dirname(os.path.abspath(cert_path)), exist_ok=True)
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key_path, "-out", cert_path,
            "-days", "3650", "-nodes", "-subj", f"/CN={cn}",
        ],
        check=True, capture_output=True,
    )
    logger.info("generated self-signed TLS cert %s", cert_path)


def server_ssl_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_ssl_context(verify: bool = False) -> ssl.SSLContext:
    """Client side; ``verify=False`` accepts the gate's self-signed cert
    (the reference's test client dials TLS without a CA bundle too)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
