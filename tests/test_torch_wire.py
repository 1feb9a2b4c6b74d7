"""The port's wire against the JAX package's, byte for byte: MessagePack
payloads (``utils/mpack.py`` against ``msgpack``), packet framing with
its trace and sync-age trailers, every ``net/proto.py`` packer, the
sync-record codec batches and the delta-sync codec, the zlib stream,
and the storage and kvdb files. Inputs from seeded numpy or hypothesis.
"""

import asyncio
import math

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from goworld_tpu import kvdb as jkvdb
from goworld_tpu import storage as jstorage
from goworld_tpu.net import codec as jcodec
from goworld_tpu.net import packet as jpacket
from goworld_tpu.net import proto as jproto
from goworld_tpu.utils import syncage as jsyncage
from goworld_tpu.utils import tracing as jtracing
from goworld_tpu_torch import kvdb as tkvdb
from goworld_tpu_torch import storage as tstorage
from goworld_tpu_torch.net import codec as tcodec
from goworld_tpu_torch.net import packet as tpacket
from goworld_tpu_torch.net import proto as tproto
from goworld_tpu_torch.utils import mpack
from goworld_tpu_torch.utils import syncage as tsyncage
from goworld_tpu_torch.utils import tracing as ttracing

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

_scalars = (hs.none() | hs.booleans()
            | hs.integers(-(1 << 63), (1 << 64) - 1)
            | hs.floats(allow_nan=False) | hs.text(max_size=40)
            | hs.binary(max_size=300))
_payloads = hs.recursive(
    _scalars,
    lambda kids: hs.lists(kids, max_size=20)
    | hs.dictionaries(hs.text(max_size=20), kids, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_payloads)
def test_mpack_payloads_match_msgpack(obj):
    """``packb`` writes ``msgpack.packb(obj, use_bin_type=True)``'s
    bytes and ``unpackb`` (strict map keys, as the packet path reads)
    gives back what ``msgpack.unpackb(raw=False)`` gives."""
    raw = msgpack.packb(obj, use_bin_type=True)
    assert mpack.packb(obj) == raw
    assert mpack.unpackb(raw, strict_map_key=True) == msgpack.unpackb(
        raw, raw=False)


@pytest.mark.parametrize("n", [0, 15, 16, 255, 256, 65535, 65536, 70000])
def test_mpack_length_headers_match_msgpack(n):
    """Every length form of str, bin, array and map at its edges."""
    for obj in ("x" * n, b"y" * n, [None] * min(n, 70000),
                {f"k{i}": i for i in range(min(n, 70000))}):
        raw = msgpack.packb(obj, use_bin_type=True)
        assert mpack.packb(obj) == raw
        assert mpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("key", [1, -3, 2.5, None, True])
def test_packet_path_refuses_non_str_map_keys(key):
    """``Packet.read_data`` raises where ``msgpack.unpackb(raw=False)``
    (strict map keys) raises: a map key that is not str or bytes."""
    blob = msgpack.packb({key: 1}, use_bin_type=True)
    for pk in (jpacket, tpacket):
        p = pk.Packet()
        p.append_var_bytes(blob)
        with pytest.raises(ValueError):
            pk.Packet(bytes(p.buf)).read_data()
    # the freeze files' reader keeps msgpack's strict_map_key=False
    assert mpack.unpackb(blob) == msgpack.unpackb(
        blob, raw=False, strict_map_key=False)


def _eid(rng) -> str:
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789"),
                              16))


def _packer_args(rng):
    """Seeded arguments of every proto packer, by name."""
    e = [_eid(rng) for _ in range(6)]
    data = {"hp": int(rng.integers(0, 1000)), "name": "n" * 7,
            "pos": [float(x) for x in rng.standard_normal(3)],
            "bag": {"a": [1, 2.5, None, True], "b": b"\x00\xff"}}
    args = (1, -2, 3.25, "s", [1, [2]], {"k": "v"}, None, b"raw")
    return {
        "pack_set_game_id": (7, True, False, True, e[:4]),
        "pack_set_gate_id": (3,),
        "pack_call_entity_method": (e[0], "Move", args, e[1]),
        "pack_create_entity_anywhere": ("Monster", data, e[2], 2),
        "pack_load_entity_anywhere": ("Avatar", e[3], 1),
        "pack_notify_client_connected": (e[0], e[1], 4),
        "pack_notify_client_disconnected": (e[1], e[2]),
        "pack_create_entity_on_client": (2, e[1], e[0], "Avatar", True,
                                         data, (1.5, 0.0, -2.25), 0.75),
        "pack_destroy_entity_on_client": (2, e[1], e[0], False),
        "pack_client_events_batch": (5, [(1001, b"abc"), (1006, b"")]),
        "pack_call_entity_method_on_client": (1, e[1], e[2], "OnSay", args),
        "pack_notify_attr_change_on_client": (1, e[1], e[2],
                                              [{"hp": 3}, {"x": [1]}]),
        "pack_set_client_filter_prop": (1, e[1], "room", "7"),
        "pack_call_filtered_clients": ("room", "=", "7", e[3], "OnChat",
                                       args),
        "pack_kvreg_register": ("svc/a", "b", True),
        "pack_replication_subscribe": (1, 2),
        "pack_replication_frame": (2, 1, b"\x01\x02frame"),
        "pack_game_lbc_info": (37.5,),
        "pack_query_space_gameid": (e[4], e[0]),
        "pack_migrate_request": (e[0], e[4], 3),
        "pack_real_migrate": (e[0], 3, data),
        "pack_cancel_migrate": (e[0],),
        "pack_call_nil_spaces": ("Reload", args),
    }


_PACKERS = sorted(n for n in dir(jproto) if n.startswith("pack_"))


def test_every_proto_packer_is_covered():
    assert _PACKERS == sorted(_packer_args(np.random.default_rng(0)))
    assert sorted(n for n in dir(tproto) if n.startswith("pack_")) \
        == _PACKERS


@pytest.mark.parametrize("name", _PACKERS)
def test_proto_packers_match_jax(name):
    """Each packer's framed bytes, on seeded arguments, equal the JAX
    package's; so do the message-type constants."""
    for seed in range(3):
        args = _packer_args(np.random.default_rng(seed))[name]
        jp = getattr(jproto, name)(*args)
        tp = getattr(tproto, name)(*args)
        assert tpacket.frame(tp) == jpacket.frame(jp)
    consts = {n: getattr(jproto, n) for n in dir(jproto)
              if n.startswith(("MT_", "FILTER_"))}
    assert consts == {n: getattr(tproto, n) for n in dir(tproto)
                      if n.startswith(("MT_", "FILTER_"))}


def test_packet_trailers_match_jax():
    """A packet with a trace context and a sync-age stamp goes on the
    wire as the JAX package's, and each decodes the other's."""
    rng = np.random.default_rng(1)
    tid, sid = rng.bytes(16), rng.bytes(8)
    stamp = (11, 1_700_000_000_000_000, 1_700_000_000_001_000,
             1_700_000_000_002_000, 1_700_000_000_003_000)
    frames = []
    for pk, tr, sa in ((jpacket, jtracing, jsyncage),
                       (tpacket, ttracing, tsyncage)):
        p = pk.new_packet(jproto.MT_SYNC_POSITION_YAW_ON_CLIENTS)
        p.append_u16(1)
        p.append_bytes(b"\x07" * 48)
        p.trace = tr.TraceContext(tid, sid)
        p.age = sa.SyncAgeStamp(*stamp)
        frames.append(pk.frame(p))
    assert frames[0] == frames[1]
    for pk in (jpacket, tpacket):
        mt, p = pk.decode_wire(frames[0][4:])
        assert mt == jproto.MT_SYNC_POSITION_YAW_ON_CLIENTS
        assert p.trace.trace_id == tid and p.trace.span_id == sid
        assert (p.age.pack() if hasattr(p.age, "pack") else None) \
            == tsyncage.SyncAgeStamp(*stamp).pack()


def _records(rng, n):
    ids = np.array([_eid(rng) for _ in range(n)], "S16")
    cids = np.array([_eid(rng) for _ in range(n)], "S16")
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    return ids, cids, vals


@pytest.mark.parametrize("n", [0, 1, 33, 1000])
def test_sync_codec_batches_match_jax(n):
    """The 32 B and 48 B sync records, their decodes, the shard
    bucketing and the frame scan: equal to the JAX package's on
    whichever path it loaded (its native core or numpy)."""
    rng = np.random.default_rng(n)
    ids, cids, vals = _records(rng, n)
    a = tcodec.encode_sync_batch(ids, vals)
    assert a == jcodec.encode_sync_batch(ids, vals)
    b = tcodec.encode_client_sync_batch(cids, ids, vals)
    assert b == jcodec.encode_client_sync_batch(cids, ids, vals)
    for got, want in zip(tcodec.decode_sync_batch(a),
                         jcodec.decode_sync_batch(a)):
        assert np.array_equal(got, want)
    for got, want in zip(tcodec.decode_client_sync_batch(b),
                         jcodec.decode_client_sync_batch(b)):
        assert np.array_equal(got, want)
    shard = rng.integers(-1, 5, n).astype(np.int32)
    for got, want in zip(tcodec.bucket_by_shard(shard, 4, 16),
                         jcodec.bucket_by_shard(shard, 4, 16)):
        assert np.array_equal(got, want)
    stream = b"".join(len(x).to_bytes(4, "little") + x
                      for x in (b"ab", a[:40] or b"cd", b"xyz")) + b"\x09\x00"
    assert tcodec.scan_frames(stream) == jcodec.scan_frames(stream)


def test_delta_sync_codec_matches_jax():
    """Ten ticks of a walking population through both packages'
    ``DeltaSyncEncoder`` (keyframes, deltas, an int16 overflow, a
    dropped client): equal bytes, and each decoder gives the same
    records from them."""
    rng = np.random.default_rng(5)
    ids, cids, vals = _records(rng, 64)
    encs = [m.DeltaSyncEncoder(0.03125, keyframe_every=4)
            for m in (jcodec, tcodec)]
    decs = [m.DeltaSyncDecoder() for m in (jcodec, tcodec)]
    for tick in range(10):
        vals = vals + rng.standard_normal(vals.shape).astype(np.float32)
        if tick == 6:
            vals[3] += 5000.0
            for e in encs:
                e.drop_client(cids[5].decode())
        blobs = [e.encode_batch(cids, ids, vals, tick) for e in encs]
        assert blobs[0] == blobs[1]
        outs = [d.decode_batch(blobs[0]) for d in decs]
        for got, want in zip(*outs):
            assert np.array_equal(got, want)
    assert encs[0].stats == encs[1].stats


class _Writer:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b


def test_zlib_stream_matches_jax_and_snappy_is_refused():
    """``compress_codec = zlib`` puts the JAX package's stream on the
    wire; the port reads it back. Snappy is not ported: it raises."""
    outs = []
    for pk in (jpacket, tpacket):
        rng = np.random.default_rng(2)
        w = _Writer()
        conn = pk.PacketConnection(None, w, compress=True,
                                   compress_codec="zlib")
        for i in range(20):
            p = pk.new_packet(jproto.MT_CALL_ENTITY_METHOD)
            p.append_var_str(f"m{i}")
            p.append_bytes(rng.bytes(int(rng.integers(0, 200))))
            conn.send(p)
        outs.append(bytes(w.data))
    assert outs[0] == outs[1]

    async def read_all():
        reader = asyncio.StreamReader()
        reader.feed_data(outs[0])
        reader.feed_eof()
        conn = tpacket.PacketConnection(reader, _Writer(), compress=True,
                                        compress_codec="zlib")
        return [(await conn.recv())[1].read_var_str() for _ in range(20)]

    assert asyncio.run(read_all()) == [f"m{i}" for i in range(20)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpacket.PacketConnection(None, _Writer(), compress=True)


def _attr_data(rng):
    return {"hp": int(rng.integers(0, 100)), "name": "m" * 5,
            "pos": [float(x) for x in rng.standard_normal(3)],
            "inv": {"slots": list(range(int(rng.integers(0, 9)))),
                    "gold": float(rng.uniform(0, 1e6)),
                    "tag": None, "ok": bool(rng.integers(0, 2))}}


def test_filesystem_storage_files_match_jax(tmp_path):
    """Entity files written through both packages' filesystem backend
    are the same bytes, and each reads the other's."""
    rng = np.random.default_rng(3)
    jb = jstorage.open_backend("filesystem", str(tmp_path / "j"))
    tb = tstorage.open_backend("filesystem", str(tmp_path / "t"))
    for i in range(12):
        data = _attr_data(rng)
        eid = _eid(rng)
        typ = ("Avatar", "Monster")[i % 2]
        jb.write(typ, eid, data)
        tb.write(typ, eid, data)
        for b in (jb, tb):
            assert b.read(typ, eid) == data
        assert (tmp_path / "t" / typ / f"{eid}.mp").read_bytes() == \
            (tmp_path / "j" / typ / f"{eid}.mp").read_bytes()
    for typ in ("Avatar", "Monster"):
        assert sorted(tb.list_entity_ids(typ)) == \
            sorted(jb.list_entity_ids(typ))
    assert tb.read("Avatar", "x" * 16) is None
    for kind in ("redis", "mongodb"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tstorage.open_backend(kind)


def test_filesystem_kvdb_files_match_jax(tmp_path):
    """The kvdb's one file after the same puts is the same bytes in
    both packages; each package reopens the other's."""
    rng = np.random.default_rng(4)
    paths = {m: str(tmp_path / f"{m}.mp") for m in ("j", "t")}
    jb = jkvdb.open_kvdb_backend("filesystem", paths["j"])
    tb = tkvdb.open_kvdb_backend("filesystem", paths["t"])
    for i in range(30):
        key, val = f"acct/{int(rng.integers(0, 12))}", _eid(rng)
        jb.put(key, val)
        tb.put(key, val)
    with open(paths["t"], "rb") as f, open(paths["j"], "rb") as g:
        assert f.read() == g.read()
    again = tkvdb.open_kvdb_backend("filesystem", paths["j"])
    assert again.get_range("acct/", "acct0") == jb.get_range("acct/",
                                                            "acct0")
    for kind in ("redis", "redis_cluster", "mongodb"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tkvdb.open_kvdb_backend(kind)


def test_float_payloads_keep_their_bits():
    """Doubles, infinities and NaN ride MessagePack as the same eight
    bytes in both packages."""
    vals = [0.0, -0.0, math.inf, -math.inf, 1e-310, 2.0 ** -1074,
            float(np.float32(0.1))]
    for v in vals + [math.nan]:
        assert mpack.packb(v) == msgpack.packb(v, use_bin_type=True)
