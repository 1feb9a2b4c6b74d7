"""The port's KCP transport (``goworld_tpu_torch.net.kcp``) against the
JAX package's (``goworld_tpu.net.kcp``).

Both of the port's cores — the C++ one (``native/kcp_core.cpp``, built
into ``goworld_tpu_torch/_build/``) and the Python ``KcpCore`` — emit the
same datagrams as the JAX package's cores for the same conversation id,
inputs, losses and clock, step by step. Over real localhost UDP a port
client and a JAX server, and a JAX client and a port server, carry a
framed packet stream both ways under loss. The cases of
``tests/test_kcp.py`` follow on the port: the u32 serial wrap, idle
reaping with the liveness probe, the TIME_WAIT tombstone, the per-IP
mint cap, crafted lengths and the dead link."""

from __future__ import annotations

import asyncio
import random
import struct
from contextlib import contextmanager

import pytest

import goworld_tpu.net.kcp as jkcp
import goworld_tpu_torch.net.kcp as tkcp
from goworld_tpu.net import packet as jpacket
from goworld_tpu_torch.net import packet as tpacket

CORES = {
    "port_native": tkcp.NativeKcpCore,
    "port_python": tkcp.KcpCore,
    "jax_native": jkcp.NativeKcpCore,
    "jax_python": jkcp.KcpCore,
}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@contextmanager
def fake_clock(step_ms=10):
    """One virtual clock for both packages' cores, from a fixed origin
    (so two conversations see the same timestamps); yields advance()."""
    t0 = 1_000_000
    real = (tkcp._now_ms, jkcp._now_ms)
    state = {"step": 0}

    def now() -> int:
        return t0 + state["step"] * step_ms

    def advance():
        state["step"] += 1

    tkcp._now_ms = jkcp._now_ms = now
    try:
        yield advance
    finally:
        tkcp._now_ms, jkcp._now_ms = real


def _conversation(cls_a, cls_b, seed: int, loss: float, steps: int,
                  serial_start: int | None = None):
    """Drive a <-> b full duplex under seeded loss on the virtual clock;
    every datagram each side emits, step by step, and what arrived."""
    rng = random.Random(seed)
    a_out, b_out = [], []
    a, b = cls_a(5, a_out.append), cls_b(5, b_out.append)
    if serial_start is not None:
        for core in (a, b):
            if isinstance(core, (tkcp.KcpCore, jkcp.KcpCore)):
                core.snd_nxt = core.snd_una = core.rcv_nxt = serial_start
            else:
                core._lib.kcp_test_set_serials(
                    core._h, serial_start, serial_start, serial_start)
    pay = bytes(rng.getrandbits(8) for _ in range(12000))
    a.send(pay)
    b.send(pay[::-1])
    trace, got_a, got_b = [], bytearray(), bytearray()
    with fake_clock() as advance:
        for step in range(steps):
            advance()
            if step == 3:
                a.probe()
            a.flush()
            trace.append(("a", list(a_out)))
            for d in a_out:
                if rng.random() >= loss:
                    b.input(d)
            a_out.clear()
            b.flush()
            trace.append(("b", list(b_out)))
            for d in b_out:
                if rng.random() >= loss:
                    a.input(d)
            b_out.clear()
            while (c := b.recv()) is not None:
                got_b += c
            while (c := a.recv()) is not None:
                got_a += c
    assert bytes(got_b) == pay and bytes(got_a) == pay[::-1]
    return trace


@pytest.mark.parametrize("port", ["port_native", "port_python"])
@pytest.mark.parametrize("jax", ["jax_native", "jax_python"])
@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("loss", [0.0, 0.25])
def test_datagrams_match_jax(port, jax, side, loss):
    """A port core in one seat of a conversation emits, at every step,
    exactly the datagrams the JAX core emits in that seat (the other
    seat a JAX core either way)."""
    peer = CORES[jax]
    if side == "a":
        got = _conversation(CORES[port], peer, 23, loss, 400)
        want = _conversation(CORES[jax], peer, 23, loss, 400)
    else:
        got = _conversation(peer, CORES[port], 23, loss, 400)
        want = _conversation(peer, CORES[jax], 23, loss, 400)
    assert got == want


@pytest.mark.parametrize("port", ["port_native", "port_python"])
def test_serial_wrap_datagrams_match_jax(port):
    """Serial numbers crossing 2^32: the same datagrams as the JAX
    core's, and the stream arrives (u32 wrap of sn/una)."""
    start = (1 << 32) - 3
    got = _conversation(CORES[port], jkcp.KcpCore, 4, 0.1, 300, start)
    want = _conversation(jkcp.KcpCore, jkcp.KcpCore, 4, 0.1, 300, start)
    assert got == want


async def _echo_over(server_mod, client_mod, server_pk, client_pk, loss,
                     n=30):
    """``n`` framed packets client -> server over real UDP under loss
    both ways, and one reply back; what the server got."""
    rng = random.Random(11)

    def drop(_d: bytes) -> bool:
        return rng.random() < loss

    received = []
    done = asyncio.Event()

    async def on_client(reader, writer):
        conn = server_pk.PacketConnection(reader, writer, compress=True,
                                          compress_codec="snappy")
        for _ in range(n):
            mt, pkt = await conn.recv()
            received.append((mt, pkt.read_var_str()))
        p = server_pk.new_packet(901)
        p.append_var_str("pong")
        conn.send(p)
        await conn.drain()
        done.set()

    server = await server_mod.start_kcp_server(
        on_client, "127.0.0.1", 0, loss_hook=drop)
    reader, writer = await client_mod.open_kcp_connection(
        "127.0.0.1", server.bound_port, loss_hook=drop)
    conn = client_pk.PacketConnection(reader, writer, compress=True,
                                      compress_codec="snappy")
    for i in range(n):
        p = client_pk.new_packet(900)
        p.append_var_str(f"msg-{i:03d}-" + "x" * (i * 37 % 300))
        conn.send(p)
    await conn.drain()
    await asyncio.wait_for(done.wait(), 40)
    mt, pkt = await conn.recv()
    assert (mt, pkt.read_var_str()) == (901, "pong")
    await conn.close()
    server.close()
    return received


@pytest.mark.parametrize("pure", ["0", "1"], ids=["native", "python"])
@pytest.mark.parametrize("direction", ["port_client", "port_server"])
def test_interop_with_jax_under_loss(direction, pure, monkeypatch):
    """A port client against a JAX server, and a JAX client against a
    port server, each with the port on its native or its Python core:
    a snappy-compressed packet stream arrives whole under 15% loss."""
    monkeypatch.setenv("GOWORLD_TPU_PURE_KCP", pure)
    if direction == "port_client":
        args = (jkcp, tkcp, jpacket, tpacket)
    else:
        args = (tkcp, jkcp, tpacket, jpacket)
    got = run(_echo_over(*args, loss=0.15))
    assert [t for t, _ in got] == [900] * 30
    assert got[0][1].startswith("msg-000") and got[29][1].startswith(
        "msg-029")


def test_make_core_is_native_unless_asked(monkeypatch):
    monkeypatch.delenv("GOWORLD_TPU_PURE_KCP", raising=False)
    assert isinstance(tkcp.make_core(1, lambda d: None), tkcp.NativeKcpCore)
    monkeypatch.setenv("GOWORLD_TPU_PURE_KCP", "1")
    assert isinstance(tkcp.make_core(1, lambda d: None), tkcp.KcpCore)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No warning-and-continue: a compiler that fails raises."""
    from goworld_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="kcp_core.cpp"):
        native.build("kcp_core")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="compiler"):
        native.build("kcp_core")


@pytest.mark.parametrize("core", ["port_native", "port_python"])
def test_crafted_len_field_rejected(core):
    c = CORES[core](5, lambda d: None)
    evil = struct.pack("<IBBHIII", 5, 81, 0, 64, 0, 0, 0) \
        + struct.pack("<I", 0x80000000) + b"xx"
    c.input(evil)
    assert c.recv() is None
    z = struct.pack("<IBBHIII", 5, 81, 0, 64, 0, 0, 0) \
        + struct.pack("<I", 0)
    d = struct.pack("<IBBHIII", 5, 81, 0, 64, 0, 1, 0) \
        + struct.pack("<I", 4) + b"data"
    c.input(z + d)
    chunks = []
    while (x := c.recv()) is not None:
        chunks.append(x)
    assert b"".join(chunks) == b"data"


@pytest.mark.parametrize("core", ["port_native", "port_python"])
def test_dead_link_detected(core):
    a = CORES[core](3, lambda d: None)
    a.send(b"hello")
    with fake_clock(step_ms=50) as advance:
        for _ in range(20000):
            advance()
            a.flush()
            if a.dead:
                break
    assert a.dead


@pytest.mark.parametrize("core", ["port_native", "port_python"])
def test_probe_elicits_wins(core):
    a_out, b_out = [], []
    a = CORES[core](5, a_out.append)
    b = CORES[core](5, b_out.append)
    a.probe()
    a.flush()
    assert any(d[4] == tkcp.CMD_WASK for d in a_out)
    for d in a_out:
        b.input(d)
    b.flush()
    assert any(d[4] == tkcp.CMD_WINS for d in b_out)


def test_server_reaps_vanished_but_probes_idle_sessions():
    async def main():
        held = asyncio.Event()

        async def on_client(reader, writer):
            await held.wait()

        server = await tkcp.start_kcp_server(
            on_client, "127.0.0.1", 0, idle_timeout=0.6)
        reader, writer = await tkcp.open_kcp_connection(
            "127.0.0.1", server.bound_port)
        writer.write(b"hello")
        await writer.drain()
        await asyncio.sleep(0.25)
        assert len(server._sessions) == 1
        await asyncio.sleep(1.2)
        assert len(server._sessions) == 1, "live idle client was kicked"
        writer.close()
        await asyncio.sleep(1.5)
        assert not server._sessions, "vanished client never reaped"
        held.set()
        server.close()

    run(main())


class _FakeTransport:
    def __init__(self):
        self.sent = []

    def sendto(self, d, addr):
        self.sent.append((d, addr))

    def get_extra_info(self, name, default=None):
        return ("127.0.0.1", 12345)

    def close(self):
        pass


def _push(conv, sn=0, data=b"x"):
    return struct.pack("<IBBHIII", conv, 81, 0, 64, 0, sn, 0) \
        + struct.pack("<I", len(data)) + data


def test_time_wait_tombstone_blocks_resurrection():
    async def main():
        async def cb(reader, writer):
            pass

        server = tkcp.KcpServer(cb, idle_timeout=0)
        server.connection_made(_FakeTransport())
        addr = ("10.0.0.1", 5555)
        server.datagram_received(_push(7), addr)
        assert (addr, 7) in server._sessions
        server._sessions[(addr, 7)].close()
        assert not server._sessions
        server.datagram_received(_push(7), addr)
        assert not server._sessions
        server._tombstones[(addr, 7)] = 0.0
        server.datagram_received(_push(7), addr)
        assert (addr, 7) in server._sessions
        server.close()

    run(main())


def test_per_ip_mint_cap():
    async def main():
        async def cb(reader, writer):
            pass

        server = tkcp.KcpServer(cb, idle_timeout=0, max_sessions_per_ip=2)
        server.connection_made(_FakeTransport())
        for conv in (1, 2, 3):
            server.datagram_received(_push(conv), ("10.0.0.9", 1000 + conv))
        assert len(server._sessions) == 2
        server.datagram_received(_push(9), ("10.0.0.10", 1))
        assert len(server._sessions) == 3
        first = next(k for k in server._sessions if k[0][0] == "10.0.0.9")
        server._sessions[first].close()
        server.datagram_received(_push(8), ("10.0.0.9", 2000))
        assert sum(1 for k in server._sessions
                   if k[0][0] == "10.0.0.9") == 2
        server.close()

    run(main())
