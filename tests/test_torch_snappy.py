"""The port's snappy codec (``goworld_tpu_torch.net.snappy``) against the
JAX package's (``goworld_tpu.net.snappy``), byte for byte.

The port has two block cores: the C++ one (``native/snappy_core.cpp``,
built into ``goworld_tpu_torch/_build/``) and its Python twin
(``py_compress``/``py_uncompress``/``py_crc32c``). Both are held to the
JAX package's core on the same inputs: the compressed blocks, the
decoded bytes, the CRC32C and the framed streams are the same bytes, on
hypothesis-drawn inputs and on ``tests/test_snappy.py``'s known vectors,
corruption, garbage and bomb cases, which every core must answer the
same way (the same bytes, or ValueError)."""

from __future__ import annotations

import os
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from goworld_tpu.net import snappy as jsnappy
from goworld_tpu_torch.net import snappy

CORES = {
    "native": (snappy.compress, snappy.uncompress, snappy.crc32c),
    "python": (snappy.py_compress, snappy.py_uncompress, snappy.py_crc32c),
}

CASES = [
    b"",
    b"a",
    b"ab" * 3,
    b"abcabcabcabcabcabc" * 100,       # short-period matches
    b"x" * 70000,                      # long run, >64KB literal span
    os.urandom(4096),                  # incompressible
    bytes(random.Random(7).choices(b"abcd", k=20000)),
    bytes(range(256)) * 300,           # 2-byte offsets
]

# payloads shaped like the client edge's: records of ids and floats
_records = st.lists(
    st.tuples(st.binary(min_size=16, max_size=16),
              st.binary(min_size=16, max_size=16)),
    max_size=40).map(lambda rs: b"".join(a + b for a, b in rs))
_inputs = st.one_of(
    st.binary(max_size=3000),
    _records,
    st.tuples(st.binary(min_size=1, max_size=40),
              st.integers(1, 200)).map(lambda t: t[0] * t[1]),
)


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("data", CASES, ids=[f"n{len(c)}" for c in CASES])
def test_block_matches_jax(core, data):
    comp, uncomp, crc = CORES[core]
    blk = comp(data)
    assert blk == jsnappy.compress(data)
    assert uncomp(blk, max(len(data) + 16, 32)) == data
    assert crc(data) == jsnappy.crc32c(data)


@pytest.mark.parametrize("core", sorted(CORES))
@settings(max_examples=60, deadline=None)
@given(data=_inputs)
def test_block_matches_jax_on_drawn_inputs(core, data):
    comp, uncomp, crc = CORES[core]
    want = jsnappy.compress(data)
    assert comp(data) == want
    assert uncomp(want, len(data) + 1) == data
    assert crc(data) == jsnappy.crc32c(data)


@settings(max_examples=40, deadline=None)
@given(chunks=st.lists(_inputs, max_size=6))
def test_streams_match_jax(chunks):
    """The framed stream (stream identifier, compressed and raw chunks,
    masked CRCs) is the JAX package's, and each decoder reads the
    other's."""
    enc, jenc = snappy.StreamCompressor(), jsnappy.StreamCompressor()
    wire = [enc.compress(c) for c in chunks]
    assert wire == [jenc.compress(c) for c in chunks]
    blob = b"".join(wire)
    assert snappy.StreamDecompressor().decompress(blob) \
        == jsnappy.StreamDecompressor().decompress(blob) \
        == b"".join(chunks)


@pytest.mark.parametrize("core", sorted(CORES))
def test_known_vectors(core):
    comp, uncomp, crc = CORES[core]
    assert comp(b"abc") == bytes([3, (3 - 1) << 2]) + b"abc"
    assert comp(b"") == b"\x00"
    src = bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([0b001, 4])
    assert uncomp(src, 16) == b"abcdabcd"
    src2 = bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([
        0b010 | ((4 - 1) << 2), 4, 0])
    assert uncomp(src2, 16) == b"abcdabcd"
    # offset < len: snappy's RLE idiom
    src3 = bytes([8, 0]) + b"a" + bytes([0b010 | ((7 - 1) << 2), 1, 0])
    assert uncomp(src3, 16) == b"a" * 8
    assert crc(b"123456789") == 0xE3069283
    assert crc(b"") == 0


@pytest.mark.parametrize("core", sorted(CORES))
def test_malformed_blocks_rejected(core):
    _, uncomp, _ = CORES[core]
    for bad in (
        b"\x05\x00",
        bytes([4, (4 - 1) << 2]) + b"ab",
        bytes([8, 0]) + b"a" + bytes([0b001, 9]),
        bytes([2, 0]) + b"a" + bytes([0b001, 0]),
        b"\xff\xff\xff\xff\xff",
        bytes([100]) + b"a" * 10,      # ulen over the bound
    ):
        with pytest.raises(ValueError):
            uncomp(bad, 64)
        with pytest.raises(ValueError):
            jsnappy.uncompress(bad, 64)


def _answer(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("core", sorted(CORES))
def test_garbage_answers_as_jax(core):
    """Random blocks and bit-flipped valid ones: every core answers each
    exactly as the JAX core does (the same bytes, or ValueError)."""
    _, uncomp, _ = CORES[core]
    rng = random.Random(11)
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 80)))
             for _ in range(300)]
    valid = jsnappy.compress(bytes(rng.choices(b"abcdef", k=3000)))
    for _ in range(200):
        m = bytearray(valid)
        for _ in range(rng.randrange(1, 4)):
            m[rng.randrange(len(m))] ^= 1 << rng.randrange(8)
        blobs.append(bytes(m))
    for blob in blobs:
        assert _answer(uncomp, blob, 1 << 16) \
            == _answer(jsnappy.uncompress, blob, 1 << 16)


def test_stream_corruption_and_chunks():
    enc = snappy.StreamCompressor()
    w = bytearray(enc.compress(b"payload" * 50))
    assert bytes(w[:10]) == b"\xff\x06\x00\x00sNaPpY"
    w[-1] ^= 0xFF
    with pytest.raises(ValueError):
        snappy.StreamDecompressor().decompress(bytes(w))
    dec = snappy.StreamDecompressor()
    assert dec.decompress(b"\xfe\x02\x00\x00ab") == b""
    with pytest.raises(ValueError):
        snappy.StreamDecompressor().decompress(b"\x02\x01\x00\x00a")
    rng = random.Random(5)
    for _ in range(200):
        blob = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(1, 120)))
        assert _answer(snappy.StreamDecompressor().decompress, blob) \
            == _answer(jsnappy.StreamDecompressor().decompress, blob)


def test_stream_bomb_bound():
    wire = snappy.StreamCompressor().compress(b"\x00" * 65536 * 8)
    with pytest.raises(ValueError):
        snappy.StreamDecompressor().decompress(wire, max_out=100000)


def test_stream_any_split():
    enc = snappy.StreamCompressor()
    dec = snappy.StreamDecompressor()
    wire = b"".join(enc.compress(c) for c in CASES)
    got = b""
    rng = random.Random(3)
    i = 0
    while i < len(wire):
        j = min(len(wire), i + rng.randint(1, 1000))
        got += dec.decompress(wire[i:j])
        i = j
    assert got == b"".join(CASES)


def test_core_builds_into_the_port_build_dir():
    """The C++ core is built from the port's source into
    ``goworld_tpu_torch/_build/``, never next to the JAX package's."""
    from goworld_tpu_torch import native

    snappy.available()
    path = native.library_path("snappy_core")
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "goworld_tpu_torch"
