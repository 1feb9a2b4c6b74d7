"""KCP reliable-UDP transport (the reference's low-latency client edge).

Reference behavior being rebuilt: the gate accepts KCP alongside TCP and
WebSocket (``components/gate/GateService.go:129-161``) with "turbo mode"
tuning — nodelay, 10 ms interval, fast resend after 2 duplicate ACKs, no
congestion window (``engine/consts/consts.go:99-106``). The reference
uses the kcp-go library; this module implements the same ARQ protocol
(skywind3000 KCP wire format) from scratch over asyncio UDP, in stream
mode, and adapts it to the asyncio (reader, writer) pair shape so
:class:`goworld_tpu_torch.net.packet.PacketConnection` — and therefore
the gate, bot client, TLS-less compression, everything above — runs
unchanged over it.

Wire format (little-endian, 24-byte header per segment, segments packed
into one UDP datagram up to the MTU):

    conv u32 | cmd u8 | frg u8 | wnd u16 | ts u32 | sn u32 | una u32
    | len u32 | data[len]

cmds: 81 PUSH (data), 82 ACK, 83 WASK (window probe), 84 WINS (window
answer). Reliability: cumulative ``una`` on every header plus selective
ACKs; RTO from TCP-style srtt/rttval with nodelay backoff (+rto/2);
fast retransmit once a segment is skipped by ``resend`` newer ACKs.
Server sessions are demultiplexed by (remote address, conv).

Deviations from kcp-go, documented: stream mode only (``frg`` always 0 —
the layer above does its own length-prefixed framing), and no window
probing initiation (WASK is answered, never sent; receive windows here
are large and the reference's turbo mode disables congestion control
anyway).
"""

from __future__ import annotations

import asyncio
import ctypes
import functools
import os
import secrets
import struct
import time
from collections import deque
from typing import Callable

from goworld_tpu_torch import native
from goworld_tpu_torch.utils import log

logger = log.get("kcp")

_HDR = struct.Struct("<IBBHIII")
OVERHEAD = _HDR.size + 4          # header + len field
assert OVERHEAD == 20 + 4

CMD_PUSH = 81
CMD_ACK = 82
CMD_WASK = 83
CMD_WINS = 84

_DEAD_LINK = 20                   # retransmits before declaring the conn dead

_U32 = 0xFFFFFFFF


def _sn_diff(a: int, b: int) -> int:
    """Signed serial-number distance a-b under u32 wrap (the kcp-go
    ``_itimediff`` idiom). All sn/una window compares go through this so
    the Python core wraps exactly like the native/kcp-go cores instead of
    diverging past 2^32 segments."""
    return ((a - b + 0x80000000) & _U32) - 0x80000000


def _now_ms() -> int:
    # unbounded python int for all local arithmetic; masked to u32 only
    # when a timestamp goes on the wire
    return int(time.monotonic() * 1000)


class _Seg:
    __slots__ = ("sn", "ts", "data", "resendts", "rto", "fastack", "xmit")

    def __init__(self, sn: int, data: bytes):
        self.sn = sn
        self.ts = 0
        self.data = data
        self.resendts = 0
        self.rto = 0
        self.fastack = 0
        self.xmit = 0


class KcpCore:
    """One KCP conversation. ``output(datagram)`` sends raw UDP payloads;
    turbo-mode defaults match the reference's tuning."""

    def __init__(
        self,
        conv: int,
        output: Callable[[bytes], None],
        *,
        mtu: int = 1400,
        snd_wnd: int = 1024,
        rcv_wnd: int = 1024,
        interval: int = 10,
        resend: int = 2,
        rx_minrto: int = 10,       # nodelay minimum RTO (kcp nodelay=1)
    ):
        self.conv = conv
        self.output = output
        self.mtu = mtu
        self.mss = mtu - OVERHEAD
        self.snd_wnd = snd_wnd
        self.rcv_wnd = rcv_wnd
        self.interval = interval
        self.resend = resend
        self.rx_minrto = rx_minrto

        self.snd_una = 0           # first unacknowledged sn
        self.snd_nxt = 0           # next sn to assign
        self.rcv_nxt = 0           # next sn expected in order
        self.rmt_wnd = rcv_wnd     # peer's advertised window

        self.snd_queue: deque[bytes] = deque()
        self.snd_buf: deque[_Seg] = deque()
        self.rcv_buf: dict[int, bytes] = {}
        self.rcv_queue: deque[bytes] = deque()
        self.acklist: list[tuple[int, int]] = []

        self.rx_srtt = 0
        self.rx_rttval = 0
        self.rx_rto = 200
        self.dead = False
        self._wins_pending = False
        self._wask_pending = False

    # ---------------------------------------------------------- sending --
    def send(self, data: bytes) -> None:
        """Stream mode: slice into MSS chunks, queue."""
        for off in range(0, len(data), self.mss):
            self.snd_queue.append(bytes(data[off:off + self.mss]))

    def unsent(self) -> int:
        return len(self.snd_queue) + len(self.snd_buf)

    # -------------------------------------------------------- rtt / acks --
    def _update_rtt(self, rtt: int) -> None:
        if rtt < 0:
            return
        if self.rx_srtt == 0:
            self.rx_srtt = rtt
            self.rx_rttval = rtt // 2
        else:
            delta = abs(rtt - self.rx_srtt)
            self.rx_rttval = (3 * self.rx_rttval + delta) // 4
            self.rx_srtt = max(1, (7 * self.rx_srtt + rtt) // 8)
        rto = self.rx_srtt + max(self.interval, 4 * self.rx_rttval)
        self.rx_rto = min(max(self.rx_minrto, rto), 60000)

    def _parse_una(self, una: int) -> None:
        while self.snd_buf and _sn_diff(self.snd_buf[0].sn, una) < 0:
            self.snd_buf.popleft()
        self.snd_una = (
            self.snd_buf[0].sn if self.snd_buf else self.snd_nxt
        )

    def _parse_ack(self, sn: int, ts: int) -> None:
        rtt = ((_now_ms() & 0xFFFFFFFF) - ts) & 0xFFFFFFFF
        if rtt < 60000:  # ignore wrapped / nonsense wire timestamps
            self._update_rtt(rtt)
        for i, seg in enumerate(self.snd_buf):
            if seg.sn == sn:
                del self.snd_buf[i]
                break
            if _sn_diff(seg.sn, sn) > 0:
                break
        # fast-retransmit bookkeeping: older in-flight segments were
        # skipped by this newer ack
        for seg in self.snd_buf:
            if _sn_diff(seg.sn, sn) < 0:
                seg.fastack += 1
        self.snd_una = (
            self.snd_buf[0].sn if self.snd_buf else self.snd_nxt
        )

    # --------------------------------------------------------- receiving --
    def input(self, datagram: bytes) -> None:
        """Feed one UDP datagram (possibly several segments)."""
        off = 0
        n = len(datagram)
        while off + OVERHEAD <= n:
            conv, cmd, _frg, wnd, ts, sn, una = _HDR.unpack_from(
                datagram, off
            )
            (length,) = struct.unpack_from("<I", datagram, off + _HDR.size)
            off += OVERHEAD
            if conv != self.conv or off + length > n:
                return  # corrupt / foreign
            data = datagram[off:off + length]
            off += length
            self.rmt_wnd = wnd
            self._parse_una(una)
            if cmd == CMD_ACK:
                self._parse_ack(sn, ts)
            elif cmd == CMD_PUSH:
                ahead = _sn_diff(sn, self.rcv_nxt)
                if 0 <= ahead < self.rcv_wnd:
                    self.acklist.append((sn, ts))
                    if sn not in self.rcv_buf:
                        self.rcv_buf[sn] = data
                    # drain in-order prefix
                    while self.rcv_nxt in self.rcv_buf:
                        self.rcv_queue.append(
                            self.rcv_buf.pop(self.rcv_nxt)
                        )
                        self.rcv_nxt = (self.rcv_nxt + 1) & _U32
                elif ahead < 0:
                    # duplicate of something already delivered: re-ack
                    self.acklist.append((sn, ts))
            elif cmd == CMD_WASK:
                self._wins_pending = True
            # CMD_WINS: header side effects (rmt_wnd, una) already applied

    def recv(self) -> bytes | None:
        if not self.rcv_queue:
            return None
        return self.rcv_queue.popleft()

    def announce(self) -> None:
        """Send one WINS (window announce) segment immediately. A KCP
        client is invisible until its first datagram — unlike TCP, where
        the handshake itself tells the server a client exists — so
        connectors fire this right after binding (the gate creates the
        ClientProxy, and with it the boot entity, on session creation)."""
        self.output(
            _HDR.pack(self.conv, CMD_WINS, 0, self._wnd_unused(),
                      _now_ms() & 0xFFFFFFFF, 0, self.rcv_nxt)
            + struct.pack("<I", 0)
        )

    def probe(self) -> None:
        """Queue a WASK (window probe) for the next flush. The peer
        answers with a WINS, so this doubles as a liveness probe for
        idle-session reaping: a silent-but-alive peer refreshes
        ``last_heard``, a dead one does not."""
        self._wask_pending = True

    # ------------------------------------------------------------ flush --
    def _wnd_unused(self) -> int:
        return max(0, self.rcv_wnd - len(self.rcv_queue))

    def flush(self) -> None:
        now = _now_ms()
        wnd = self._wnd_unused()
        out = bytearray()

        def emit(cmd: int, sn: int, ts: int, data: bytes = b"") -> None:
            nonlocal out
            if len(out) + OVERHEAD + len(data) > self.mtu and out:
                self.output(bytes(out))
                out = bytearray()
            out += _HDR.pack(self.conv, cmd, 0, wnd, ts & 0xFFFFFFFF,
                             sn, self.rcv_nxt)
            out += struct.pack("<I", len(data))
            out += data

        for sn, ts in self.acklist:
            emit(CMD_ACK, sn, ts)
        self.acklist.clear()
        if self._wins_pending:
            emit(CMD_WINS, 0, now)
            self._wins_pending = False
        if self._wask_pending:
            emit(CMD_WASK, 0, now)
            self._wask_pending = False

        # admit new segments into the in-flight window (turbo mode: no
        # congestion window; a zero remote window still admits one
        # segment so progress is made without WASK probing)
        cwnd = min(self.snd_wnd, max(self.rmt_wnd, 1))
        while self.snd_queue and \
                _sn_diff(self.snd_nxt, (self.snd_una + cwnd) & _U32) < 0:
            seg = _Seg(self.snd_nxt, self.snd_queue.popleft())
            self.snd_nxt = (self.snd_nxt + 1) & _U32
            self.snd_buf.append(seg)

        for seg in self.snd_buf:
            need = False
            if seg.xmit == 0:
                need = True
                seg.rto = self.rx_rto
                seg.resendts = now + seg.rto
            elif seg.fastack >= self.resend:
                need = True
                seg.fastack = 0
                seg.resendts = now + seg.rto
            elif now >= seg.resendts:
                need = True
                seg.rto += seg.rto // 2          # nodelay backoff
                seg.resendts = now + seg.rto
            if need:
                seg.xmit += 1
                seg.ts = now
                if seg.xmit >= _DEAD_LINK:
                    self.dead = True
                emit(CMD_PUSH, seg.sn, now, seg.data)
        if out:
            self.output(bytes(out))


# ===================================================== native C++ core ==
# Same state machine in C++ (native/kcp_core.cpp, built at first use by
# goworld_tpu_torch.native into _build/) — the reference links kcp-go
# for exactly this role. Sessions run the native core; a failed build or
# load raises. GOWORLD_TPU_PURE_KCP=1 selects the Python KcpCore above
# (the plain version of the same protocol) explicitly.


@functools.cache
def _load_native() -> ctypes.CDLL:
    lib = native.load("kcp_core")
    lib.kcp_create.restype = ctypes.c_void_p
    lib.kcp_create.argtypes = [ctypes.c_uint32] + [ctypes.c_int] * 6
    lib.kcp_free.argtypes = [ctypes.c_void_p]
    lib.kcp_send.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.kcp_input.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int64]
    lib.kcp_recv.restype = ctypes.c_int
    lib.kcp_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.kcp_flush.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kcp_drain_out.restype = ctypes.c_int
    lib.kcp_drain_out.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.kcp_unsent.restype = ctypes.c_int
    lib.kcp_unsent.argtypes = [ctypes.c_void_p]
    lib.kcp_dead.restype = ctypes.c_int
    lib.kcp_dead.argtypes = [ctypes.c_void_p]
    lib.kcp_announce.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kcp_probe.argtypes = [ctypes.c_void_p]
    lib.kcp_test_set_serials.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32]
    return lib


class NativeKcpCore:
    """ctypes facade over the C++ core; same interface as KcpCore."""

    def __init__(
        self,
        conv: int,
        output: Callable[[bytes], None],
        *,
        mtu: int = 1400,
        snd_wnd: int = 1024,
        rcv_wnd: int = 1024,
        interval: int = 10,
        resend: int = 2,
        rx_minrto: int = 10,
    ):
        self._lib = _load_native()
        self.conv = conv
        self.output = output
        self.interval = interval
        self._h = self._lib.kcp_create(
            conv, mtu, snd_wnd, rcv_wnd, interval, resend, rx_minrto
        )
        self._buf = ctypes.create_string_buffer(max(mtu, 65536))

    @property
    def dead(self) -> bool:
        return bool(self._lib.kcp_dead(self._h))

    def send(self, data: bytes) -> None:
        self._lib.kcp_send(self._h, bytes(data), len(data))

    def unsent(self) -> int:
        return self._lib.kcp_unsent(self._h)

    def input(self, datagram: bytes) -> None:
        self._lib.kcp_input(
            self._h, bytes(datagram), len(datagram), _now_ms()
        )

    def recv(self) -> bytes | None:
        n = self._lib.kcp_recv(self._h, self._buf, len(self._buf))
        if n == 0:
            return None
        if n < 0:  # chunk larger than buffer (can't happen at our MTUs)
            raise ConnectionError("kcp recv buffer overflow")
        return self._buf.raw[:n]

    def _drain(self) -> None:
        while True:
            n = self._lib.kcp_drain_out(self._h, self._buf, len(self._buf))
            if n == 0:
                return
            if n < 0:
                raise ConnectionError("kcp datagram buffer overflow")
            self.output(self._buf.raw[:n])

    def flush(self) -> None:
        self._lib.kcp_flush(self._h, _now_ms())
        self._drain()

    def announce(self) -> None:
        self._lib.kcp_announce(self._h, _now_ms())
        self._drain()

    def probe(self) -> None:
        self._lib.kcp_probe(self._h)

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.kcp_free(h)


def make_core(conv: int, output: Callable[[bytes], None]):
    """The native core, or the Python one under GOWORLD_TPU_PURE_KCP=1
    (same protocol, same datagrams)."""
    if os.environ.get("GOWORLD_TPU_PURE_KCP") == "1":
        return KcpCore(conv, output)
    return NativeKcpCore(conv, output)


# ======================================================== asyncio layer ==

class KcpWriter:
    """Duck-typed asyncio StreamWriter over a KcpCore (the subset
    PacketConnection uses: write/drain/close/wait_closed/get_extra_info)."""

    _HIGH_WATER = 4096  # segments buffered before drain() applies backpressure

    def __init__(self, core: KcpCore, peername, closer):
        self._core = core
        self._peername = peername
        self._closer = closer
        self.closed_event = asyncio.Event()

    def write(self, data: bytes) -> None:
        if self.closed_event.is_set():
            raise ConnectionError("kcp connection closed")
        self._core.send(data)
        self._core.flush()          # nodelay: no interval wait for data

    async def drain(self) -> None:
        while self._core.unsent() > self._HIGH_WATER \
                and not self.closed_event.is_set():
            await asyncio.sleep(self._core.interval / 1000.0)
        if self._core.dead:
            raise ConnectionError("kcp link dead (retransmit limit)")

    def close(self) -> None:
        self._closer()

    async def wait_closed(self) -> None:
        await self.closed_event.wait()

    def get_extra_info(self, name: str, default=None):
        if name == "peername":
            return self._peername
        return default

    def is_closing(self) -> bool:
        return self.closed_event.is_set()


class _Session:
    """One conversation endpoint: core + reader/writer pair + update task."""

    def __init__(self, conv: int, transport, addr, loss_hook=None):
        def output(datagram: bytes) -> None:
            if loss_hook is not None and loss_hook(datagram):
                # injected packet loss: unit tests pass ad-hoc hooks;
                # the gate wires faults.kcp_loss_hook so a seeded chaos
                # schedule (drop:gate->client:p) exercises the ARQ path
                return
            try:
                transport.sendto(datagram, addr)
            except OSError:
                pass

        self.core = make_core(conv, output)
        self.reader = asyncio.StreamReader()
        self.writer = KcpWriter(self.core, addr, self.close)
        self.await_peer = False   # client side: re-announce until heard
        self._heard_peer = False
        self.last_heard = time.monotonic()
        self._task = asyncio.ensure_future(self._update_loop())

    def feed(self, datagram: bytes) -> None:
        self._heard_peer = True
        self.last_heard = time.monotonic()
        self.core.input(datagram)
        while (chunk := self.core.recv()) is not None:
            self.reader.feed_data(chunk)
        self.core.flush()                    # acks go out immediately

    async def _update_loop(self) -> None:
        try:
            while not self.core.dead:
                await asyncio.sleep(self.core.interval / 1000.0)
                if self.await_peer and not self._heard_peer:
                    # the session-opening announce is one UDP datagram;
                    # on the lossy networks KCP exists for it must be
                    # re-sent until the peer answers (the server speaks
                    # first in the gate flow, so a lost announce would
                    # otherwise hang the connection)
                    self.core.announce()
                self.core.flush()
        except asyncio.CancelledError:
            pass
        if self.core.dead:
            self.close()

    def close(self) -> None:
        if not self.writer.closed_event.is_set():
            self.writer.closed_event.set()
            self.reader.feed_eof()
            self._task.cancel()


class KcpServer(asyncio.DatagramProtocol):
    """UDP listener demultiplexing sessions by (addr, conv); calls
    ``client_connected(reader, writer)`` exactly like
    ``asyncio.start_server`` so the gate's connection handler is shared
    with the TCP path (``GateService.go:129-161``).

    Self-defending independently of the gate's (optional) heartbeat:

    - **idle reaping** — UDP has no connection_lost and dead-link
      detection only fires while unacked OUTBOUND data exists, so a
      silently-vanished peer (or a spoofed datagram that passed mint
      validation) would otherwise pin a session + its update task
      forever and exhaust MAX_SESSIONS. A session with no inbound
      datagram for ``idle_timeout`` seconds is closed here.
    - **TIME_WAIT tombstones** — after a server-initiated close the peer
      may keep retransmitting unacked PUSH segments; without a tombstone
      each would re-pass mint validation and resurrect the connection
      (fresh ClientProxy + boot entity per kick). Recently-closed
      (addr, conv) keys drop datagrams for ``TIME_WAIT`` seconds.
    - **per-IP mint cap** — one source IP may hold at most
      ``max_sessions_per_ip`` live sessions, bounding what a single
      spoofing host can pin (ports are free to forge; IPs less so).
    """

    MAX_SESSIONS = 65536  # bound state growth from spoofed/garbage UDP
    TIME_WAIT = 3.0       # s; covers several nodelay RTO backoff rounds

    def __init__(self, client_connected, loss_hook=None, *,
                 idle_timeout: float = 60.0,
                 max_sessions_per_ip: int = 4096):
        self._cb = client_connected
        self._sessions: dict[tuple, _Session] = {}
        self._transport = None
        self._loss_hook = loss_hook
        self._idle_timeout = idle_timeout
        self._max_per_ip = max_sessions_per_ip
        self._per_ip: dict[str, int] = {}
        self._tombstones: dict[tuple, float] = {}
        self._reaper: asyncio.Task | None = None

    def connection_made(self, transport) -> None:
        self._transport = transport
        if self._idle_timeout > 0:
            self._reaper = asyncio.ensure_future(self._reap_loop())

    async def _reap_loop(self) -> None:
        period = max(0.5, min(self._idle_timeout / 4.0, 10.0))
        try:
            while True:
                await asyncio.sleep(period)
                now = time.monotonic()
                for key, sess in list(self._sessions.items()):
                    idle = now - sess.last_heard
                    if idle > self._idle_timeout:
                        logger.info("kcp: reaping idle session %s", key)
                        sess.close()  # close_and_forget -> tombstone
                    elif idle > self._idle_timeout / 2.0:
                        # half-idle liveness probe: a WASK elicits a WINS
                        # from a live-but-quiet peer (refreshing
                        # last_heard), so only truly dead peers reap —
                        # an idle player standing in a quiet area with
                        # zero traffic both ways must NOT be kicked
                        sess.core.probe()
                self._tombstones = {
                    k: t for k, t in self._tombstones.items() if t > now
                }
        except asyncio.CancelledError:
            pass

    @property
    def bound_port(self) -> int:
        return self._transport.get_extra_info("sockname")[1]

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < OVERHEAD:
            return
        conv, cmd, _frg, _wnd, _ts, _sn, _una = _HDR.unpack_from(data, 0)
        key = (addr, conv)
        sess = self._sessions.get(key)
        if sess is None:
            # validate before allocating server state: a garbage or
            # spoofed datagram must not mint a session (and with it a
            # ClientProxy + boot entity + retransmitting reply stream
            # aimed at the spoofed source)
            (length,) = struct.unpack_from("<I", data, _HDR.size)
            if (
                conv == 0
                or cmd not in (CMD_PUSH, CMD_ACK, CMD_WASK, CMD_WINS)
                or OVERHEAD + length > len(data)
                or len(self._sessions) >= self.MAX_SESSIONS
                or self._tombstones.get(key, 0.0) > time.monotonic()
                or self._per_ip.get(addr[0], 0) >= self._max_per_ip
            ):
                return
            sess = _Session(conv, self._transport, addr, self._loss_hook)
            self._sessions[key] = sess
            self._per_ip[addr[0]] = self._per_ip.get(addr[0], 0) + 1
            orig_close = sess.close

            def close_and_forget() -> None:
                orig_close()
                if self._sessions.pop(key, None) is not None:
                    left = self._per_ip.get(addr[0], 1) - 1
                    if left > 0:
                        self._per_ip[addr[0]] = left
                    else:
                        self._per_ip.pop(addr[0], None)
                    now = time.monotonic()
                    if len(self._tombstones) > 256:
                        # prune here too: with idle_timeout=0 the reaper
                        # never runs, and closed-session tombstones must
                        # not accumulate forever in a long-lived gate
                        self._tombstones = {
                            k2: t for k2, t in self._tombstones.items()
                            if t > now
                        }
                    self._tombstones[key] = now + self.TIME_WAIT
            sess.close = close_and_forget
            sess.writer._closer = close_and_forget
            asyncio.ensure_future(self._cb(sess.reader, sess.writer))
        sess.feed(data)

    def close(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
        for sess in list(self._sessions.values()):
            sess.close()
        self._sessions.clear()
        self._per_ip.clear()
        if self._transport is not None:
            self._transport.close()


async def start_kcp_server(
    client_connected, host: str, port: int, *, loss_hook=None,
    idle_timeout: float = 60.0, max_sessions_per_ip: int = 4096,
) -> KcpServer:
    loop = asyncio.get_running_loop()
    _, proto = await loop.create_datagram_endpoint(
        lambda: KcpServer(client_connected, loss_hook=loss_hook,
                          idle_timeout=idle_timeout,
                          max_sessions_per_ip=max_sessions_per_ip),
        local_addr=(host, port),
    )
    return proto


async def open_kcp_connection(
    host: str, port: int, *, conv: int | None = None, loss_hook=None
):
    """KCP analog of ``asyncio.open_connection``: returns (reader, writer)
    compatible with PacketConnection."""
    loop = asyncio.get_running_loop()
    conv = conv if conv is not None else secrets.randbits(31) | 1
    session_box: list[_Session] = []

    class _ClientProto(asyncio.DatagramProtocol):
        def connection_made(self, transport) -> None:
            session_box.append(
                _Session(conv, transport, (host, port), loss_hook)
            )

        def datagram_received(self, data: bytes, addr) -> None:
            if session_box:
                session_box[0].feed(data)

        def connection_lost(self, exc) -> None:
            if session_box:
                session_box[0].close()

    transport, _ = await loop.create_datagram_endpoint(
        _ClientProto, remote_addr=(host, port)
    )
    sess = session_box[0]
    orig_close = sess.close

    def close_all() -> None:
        orig_close()
        transport.close()
    sess.close = close_all
    sess.writer._closer = close_all
    sess.await_peer = True    # update loop re-announces until answered
    sess.core.announce()      # make the server open its side
    return sess.reader, sess.writer
