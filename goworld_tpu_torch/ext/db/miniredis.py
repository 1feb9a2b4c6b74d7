"""In-process redis-compatible server (RESP2 over TCP).

The port's copy of ``goworld_tpu/ext/db/miniredis.py``: the same
replies, cluster mode and MOVED/ASK redirects.

The reference's CI provisions a real Redis service for its kvdb/storage
tests (``.github/workflows/test.yml``); no redis server or driver is needed:
tests (and single-host deployments that want
a networked store without external dependencies) get this instead — the
same role miniredis plays in the Go ecosystem. It is a real socket server
speaking the real protocol: the client stack above it
(:mod:`goworld_tpu_torch.ext.db.resp`, the storage/kvdb redis backends, gwredis)
is byte-for-byte the code that talks to an actual redis.

Supported commands: PING SELECT SET GET MGET SETNX DEL EXISTS KEYS SCAN
FLUSHDB DBSIZE HSET HGET HGETALL HDEL EXPIRE (expiry is accepted and
ignored — entity data must not vanish under the engine). Keyspace is
per-db (SELECT), values are bytes.
"""

from __future__ import annotations

import fnmatch
import socketserver
import threading


def _encode_array(items) -> bytes:
    """A RESP array reply: nested arrays, integers (CLUSTER SLOTS carries
    slot numbers and ports) and bulk strings (None is the null bulk)."""
    out = [b"*%d\r\n" % len(items)]
    for it in items:
        if isinstance(it, (list, tuple)):
            out.append(_encode_array(it))
        elif isinstance(it, int):
            out.append(b":%d\r\n" % it)
        elif it is None:
            out.append(b"$-1\r\n")
        else:
            out.append(b"$%d\r\n%s\r\n" % (len(it), it))
    return b"".join(out)


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.rfile = self.request.makefile("rb")
        self.db = 0

    def handle(self):
        try:
            while True:
                args = self._read_command()
                if args is None:
                    return
                self._dispatch(args)
        except (ConnectionError, OSError):
            return

    def finish(self):
        try:
            self.rfile.close()
        except OSError:
            pass

    # -- protocol -------------------------------------------------------
    def _read_command(self) -> list[bytes] | None:
        line = self.rfile.readline()
        if not line:
            return None
        if not line.startswith(b"*"):
            # inline command (telnet-style) — enough for PING
            return line.strip().split()
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = self.rfile.readline()
            ln = int(hdr[1:])
            data = self.rfile.read(ln + 2)
            args.append(data[:-2])
        return args

    def _send(self, data: bytes) -> None:
        self.request.sendall(data)

    def _ok(self, s: str = "OK") -> None:
        self._send(f"+{s}\r\n".encode())

    def _int(self, n: int) -> None:
        self._send(f":{n}\r\n".encode())

    def _bulk(self, b: bytes | None) -> None:
        if b is None:
            self._send(b"$-1\r\n")
        else:
            self._send(b"$%d\r\n%s\r\n" % (len(b), b))

    def _array(self, items) -> None:
        # one send for the whole reply: a write per element would wait
        # out the client's delayed ACK (~40 ms) behind Nagle's algorithm
        self._send(_encode_array(items))

    def _err(self, msg: str) -> None:
        self._send(f"-ERR {msg}\r\n".encode())

    def _redirect(self, kind: str, slot: int, addr: str) -> None:
        # cluster redirect replies are errors WITHOUT the ERR prefix:
        # "-MOVED 3999 127.0.0.1:6381" / "-ASK 3999 127.0.0.1:6381"
        self._send(f"-{kind} {slot} {addr}\r\n".encode())

    def _cluster_check(self, srv: "MiniRedis", keys: list[bytes]) -> bool:
        """Cluster-mode ownership check; True = an error/redirect was
        sent and the command must not execute. Validates EVERY key like
        real cluster redis: a multi-key command spanning slots gets
        -CROSSSLOT even when all slots are locally owned. The ASKING
        flag (set by the previous command on THIS connection) admits
        one command for a slot being imported, per the cluster spec."""
        if srv.cluster_slots is None or not keys:
            return False
        asking, self._asking = getattr(self, "_asking", False), False
        from goworld_tpu_torch.ext.db.resp import key_slot

        slots = {key_slot(k) for k in keys}
        if len(slots) > 1:
            self._send(b"-CROSSSLOT Keys in request don't hash to the "
                       b"same slot\r\n")
            return True
        slot = slots.pop()
        ask_to = srv.ask.get(slot)
        if ask_to is not None and not asking:
            self._redirect("ASK", slot, ask_to)
            return True
        lo, hi = srv.cluster_slots
        if lo <= slot <= hi or asking:
            return False
        for addr, (plo, phi) in srv.peers.items():
            if plo <= slot <= phi:
                self._redirect("MOVED", slot, addr)
                return True
        self._redirect("MOVED", slot, srv.addr)  # stale map fallback
        return True

    # -- commands -------------------------------------------------------
    def _dispatch(self, args: list[bytes]) -> None:
        srv: MiniRedis = self.server.owner  # type: ignore[attr-defined]
        cmd = args[0].upper().decode()
        a = args[1:]
        with srv.lock:
            d = srv.dbs.setdefault(self.db, {})
            if srv.cluster_slots is not None:
                if cmd in ("MGET", "DEL", "EXISTS"):
                    ck = a                      # every arg is a key
                elif cmd in ("SET", "SETNX", "GET", "HSET", "HGET",
                             "HGETALL", "HDEL", "EXPIRE"):
                    ck = a[:1]                  # first arg is THE key
                else:
                    ck = []
                if ck and self._cluster_check(srv, ck):
                    return
            if cmd == "PING":
                self._ok("PONG")
            elif cmd == "SELECT":
                self.db = int(a[0])
                self._ok()
            elif cmd == "SET":
                d[a[0]] = a[1]
                self._ok()
            elif cmd == "SETNX":
                if a[0] in d:
                    self._int(0)
                else:
                    d[a[0]] = a[1]
                    self._int(1)
            elif cmd == "GET":
                v = d.get(a[0])
                if isinstance(v, dict):
                    self._err("wrong type")
                else:
                    self._bulk(v)
            elif cmd == "MGET":
                vals = [d.get(k) for k in a]
                self._array([
                    None if isinstance(v, dict) else v for v in vals
                ])
            elif cmd == "DEL":
                n = sum(1 for k in a if d.pop(k, None) is not None)
                self._int(n)
            elif cmd == "EXISTS":
                self._int(sum(1 for k in a if k in d))
            elif cmd == "KEYS":
                pat = a[0].decode()
                self._array(
                    [k for k in d if fnmatch.fnmatchcase(k.decode(), pat)]
                )
            elif cmd == "SCAN":
                # single-pass cursor: return everything, cursor 0
                pat = b"*"
                for i, w in enumerate(a):
                    if w.upper() == b"MATCH":
                        pat = a[i + 1]
                keys = [
                    k for k in d
                    if fnmatch.fnmatchcase(k.decode(), pat.decode())
                ]
                self._array([b"0", keys])
            elif cmd == "FLUSHDB":
                d.clear()
                self._ok()
            elif cmd == "DBSIZE":
                self._int(len(d))
            elif cmd == "HSET":
                h = d.setdefault(a[0], {})
                if not isinstance(h, dict):
                    self._err("wrong type")
                    return
                added = 0
                for i in range(1, len(a) - 1, 2):
                    added += a[i] not in h
                    h[a[i]] = a[i + 1]
                self._int(added)
            elif cmd == "HGET":
                h = d.get(a[0])
                self._bulk(h.get(a[1]) if isinstance(h, dict) else None)
            elif cmd == "HGETALL":
                h = d.get(a[0])
                flat: list[bytes] = []
                if isinstance(h, dict):
                    for k, v in h.items():
                        flat += [k, v]
                self._array(flat)
            elif cmd == "HDEL":
                h = d.get(a[0])
                n = 0
                if isinstance(h, dict):
                    n = sum(1 for k in a[1:] if h.pop(k, None) is not None)
                self._int(n)
            elif cmd == "EXPIRE":
                self._int(1 if a[0] in d else 0)
            elif cmd == "ASKING":
                # admit the NEXT command on this connection for a slot
                # this node is importing (cluster spec)
                self._asking = True
                self._ok()
            elif cmd == "CLUSTER":
                sub = a[0].upper() if a else b""
                if srv.cluster_slots is None:
                    self._err("This instance has cluster support disabled")
                elif sub == b"SLOTS":
                    def node(addr: str):
                        h, _, p = addr.rpartition(":")
                        return [h.encode(), int(p)]

                    entries = [[srv.cluster_slots[0],
                                srv.cluster_slots[1], node(srv.addr)]]
                    for addr, (lo, hi) in srv.peers.items():
                        entries.append([lo, hi, node(addr)])
                    self._array(entries)
                else:
                    self._err(f"unknown CLUSTER subcommand {sub!r}")
            else:
                self._err(f"unknown command '{cmd}'")


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class MiniRedis:
    """``srv = MiniRedis(); srv.start()`` -> ``srv.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cluster_slots: tuple[int, int] | None = None):
        self.host = host
        self.port = port
        self.dbs: dict[int, dict[bytes, object]] = {}
        self.lock = threading.Lock()
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None
        # cluster mode (None = plain redis): this node owns the
        # inclusive slot range; `peers` maps other nodes' addr -> range
        # (drives CLUSTER SLOTS and -MOVED); `ask` maps slot -> addr
        # for migration-in-progress -ASK redirects. Tests mutate these
        # live to simulate resharding.
        self.cluster_slots = cluster_slots
        self.peers: dict[str, tuple[int, int]] = {}
        self.ask: dict[int, str] = {}

    def start(self) -> "MiniRedis":
        self._server = _Server((self.host, self.port), _Handler)
        self._server.owner = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="miniredis", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def __enter__(self) -> "MiniRedis":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
