"""Client-edge transport hardening: TLS contexts + self-signed certs.

Reference parity: the gate optionally wraps every client connection in TLS
(``components/gate/ClientProxy.go:38-53``; cert/key shipped as ``rsa.crt``
/ ``rsa.key`` at the repo root, ini flags ``encrypt_connection``) and
snappy compression. Here TLS rides stdlib ``ssl`` over asyncio; stream
compression is zlib-1 (``compress_codec = zlib``). The JAX package's
snappy codec and its KCP (reliable-UDP) edge are not ported yet
(``net/snappy.py``, ``net/kcp.py``; ROADMAP.md Queue A item 8): asking
for either raises ``NotImplementedError``.

Fault injection (:mod:`goworld_tpu_torch.utils.faults`) wraps these
boundaries one layer up: wire faults apply at ``PacketConnection.send``
above the TLS/compression stream (tampering inside a negotiated stream
would model a codec bug, not a network fault).
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
