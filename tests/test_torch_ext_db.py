"""The port's ``ext/db`` (BSON, OP_MSG, RESP, minimongo, miniredis, the
redis/mongodb storage and kvdb kinds, gwredis, gwmongo) against the JAX
package's.

Tolerance: exact throughout. Encodings and wire frames are compared byte
for byte, decoded documents and replies as equal objects; every mini
server binds port 0.

* BSON: ``encode`` byte-equal and ``decode`` equal over documents drawn
  by hypothesis from a fixed seed (every type ``_encode_value`` takes);
  the hardening cases of ``tests/test_db_hardening.py`` on both packages.
* RESP: request frames byte-equal, the cluster slot hash equal, each
  package's client against the other package's server.
* Wire: one scripted command sequence sent as raw bytes to the JAX and
  the port ``MiniMongo`` and ``MiniRedis`` (plain and a three-node
  cluster: MOVED, ASK, ASKING, CROSSSLOT) gives byte-equal replies, the
  servers' addresses named alike; a slot migration in the middle of the
  cluster kvdb's ``get_range`` returns one copy of each key.
* Storage: each storage kind and each kvdb kind round-trips on the
  port, and what one package's backend writes the other's reads, both
  ways; the same for gwredis and gwmongo's documents.
"""

from __future__ import annotations

import math
import socket
import struct
import threading
import time

import pytest
import torch
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st

from goworld_tpu import kvdb as jkvdb
from goworld_tpu import storage as jstorage
from goworld_tpu.ext.db import bson as jbson
from goworld_tpu.ext.db import gwmongo as jgwmongo
from goworld_tpu.ext.db import gwredis as jgwredis
from goworld_tpu.ext.db import minimongo as jminimongo
from goworld_tpu.ext.db import miniredis as jminiredis
from goworld_tpu.ext.db import mongowire as jmongowire
from goworld_tpu.ext.db import resp as jresp
from goworld_tpu.utils.asyncwork import AsyncWorkers as JWorkers
from goworld_tpu_torch import kvdb as tkvdb
from goworld_tpu_torch import storage as tstorage
from goworld_tpu_torch.ext.db import bson as tbson
from goworld_tpu_torch.ext.db import gwmongo as tgwmongo
from goworld_tpu_torch.ext.db import gwredis as tgwredis
from goworld_tpu_torch.ext.db import minimongo as tminimongo
from goworld_tpu_torch.ext.db import miniredis as tminiredis
from goworld_tpu_torch.ext.db import mongowire as tmongowire
from goworld_tpu_torch.ext.db import resp as tresp
from goworld_tpu_torch.utils.asyncwork import AsyncWorkers as TWorkers

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

PKGS = {
    "jax": dict(bson=jbson, resp=jresp, mongowire=jmongowire,
                minimongo=jminimongo, miniredis=jminiredis,
                storage=jstorage, kvdb=jkvdb, gwmongo=jgwmongo,
                gwredis=jgwredis, workers=JWorkers),
    "port": dict(bson=tbson, resp=tresp, mongowire=tmongowire,
                 minimongo=tminimongo, miniredis=tminiredis,
                 storage=tstorage, kvdb=tkvdb, gwmongo=tgwmongo,
                 gwredis=tgwredis, workers=TWorkers),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))
CROSS = pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                                  ("port", "jax")])


# =======================================================================
# BSON
# =======================================================================
_key = st.text(st.characters(blacklist_characters="\x00",
                             blacklist_categories=("Cs",)), max_size=8)
_scalar = st.one_of(
    st.none(), st.booleans(),
    st.integers(-(1 << 31), (1 << 31) - 1),
    st.integers(-(1 << 63), (1 << 63) - 1),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(max_size=16),
    st.binary(max_size=16),
    st.binary(max_size=8).map(bytearray),
)
_value = st.recursive(
    _scalar,
    lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.lists(inner, max_size=3).map(tuple),
        st.dictionaries(_key, inner, max_size=4)),
    max_leaves=12)
_doc = st.dictionaries(st.one_of(_key, st.integers(-99, 99)), _value,
                       max_size=6)


def _plain(v):
    """A decoded value with NaN made comparable (``nan != nan``)."""
    if isinstance(v, float) and math.isnan(v):
        return ("nan", struct.pack("<d", v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@seed(16)
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_doc)
def test_bson_encode_byte_equal_and_decode_equal(doc):
    try:
        want = jbson.encode(doc)
    except (UnicodeEncodeError, ValueError) as e:
        # lone surrogates and NUL keys: both refuse alike
        with pytest.raises(type(e)):
            tbson.encode(doc)
        return
    got = tbson.encode(doc)
    assert got == want
    assert _plain(tbson.decode(got)) == _plain(jbson.decode(want))
    d, end = tbson.decode_with_end(b"xx" + got, 2)
    assert end == len(got) + 2 and _plain(d) == _plain(jbson.decode(got))


def test_bson_refuses_what_it_cannot_encode_alike():
    for bad in ({"a": object()}, {"a": {1, 2}}, {"a\x00b": 1}):
        with pytest.raises(Exception) as je:
            jbson.encode(bad)
        with pytest.raises(je.type):
            tbson.encode(bad)


# ---- the hardening cases of tests/test_db_hardening.py, both packages
def _raw_doc(body: bytes) -> bytes:
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


@BOTH
def test_bson_roundtrip_still_works(pkg):
    bson = PKGS[pkg]["bson"]
    doc = {"a": 1, "s": "x", "b": b"\x00\x01", "n": None, "f": 1.5,
           "l": [1, 2], "d": {"k": "v"}, "t": True, "big": 1 << 40}
    assert bson.decode(bson.encode(doc)) == doc


@BOTH
@pytest.mark.parametrize("body", [
    b"\x02a\x00" + struct.pack("<i", -1) + b"\x00",          # negative str
    b"\x02a\x00" + struct.pack("<i", 1 << 20) + b"x\x00",    # oversized str
    b"\x05a\x00" + struct.pack("<i", -5) + b"\x00",          # negative bin
], ids=["negative_string", "oversized_string", "negative_binary"])
def test_bson_bad_lengths_raise(pkg, body):
    with pytest.raises(ValueError):
        PKGS[pkg]["bson"].decode(_raw_doc(body))


@BOTH
def test_bson_document_length_out_of_range(pkg):
    bson = PKGS[pkg]["bson"]
    with pytest.raises(ValueError):
        bson.decode(struct.pack("<i", 4) + b"\x00")        # total < 5
    with pytest.raises(ValueError):
        bson.decode(struct.pack("<i", 64) + b"\x00" * 16)  # total > buf
    with pytest.raises(ValueError):
        bson.decode(b"\x01\x02")                           # truncated


_HDR = struct.Struct("<iiii")
OP_MSG = 2013


def _op_msg(bson, cmd: dict, rid: int = 1) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson.encode(cmd)
    return _HDR.pack(16 + len(body), rid, 0, OP_MSG) + body


def _recv_exact(s: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = s.recv(n)
        if not b:
            return b"".join(chunks)
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _mongo_raw(s: socket.socket, msg: bytes) -> bytes:
    """One OP_MSG round trip; the reply's raw bytes."""
    s.sendall(msg)
    hdr = _recv_exact(s, 16)
    return hdr + _recv_exact(s, _HDR.unpack(hdr)[0] - 16)


@BOTH
def test_minimongo_rejects_bad_lengths(pkg):
    with PKGS[pkg]["minimongo"].MiniMongo() as srv:
        for length in (8, 49 * 1024 * 1024):
            s = socket.create_connection((srv.host, srv.port), timeout=5)
            s.sendall(_HDR.pack(length, 1, 0, OP_MSG))
            assert s.recv(1) == b""  # connection dropped
            s.close()


@BOTH
def test_minimongo_empty_command_answers_and_survives(pkg):
    bson = PKGS[pkg]["bson"]
    with PKGS[pkg]["minimongo"].MiniMongo() as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        reply = bson.decode(_mongo_raw(s, _op_msg(bson, {})), 21)
        assert reply["ok"] == 0.0 and reply["code"] == 59
        reply = bson.decode(_mongo_raw(
            s, _op_msg(bson, {"ping": 1, "$db": "goworld"})), 21)
        assert reply["ok"] == 1.0
        s.close()


@BOTH
def test_minimongo_malformed_bson_drops_connection(pkg):
    with PKGS[pkg]["minimongo"].MiniMongo() as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        body = struct.pack("<I", 0) + b"\x00" + _raw_doc(
            b"\x02a\x00" + struct.pack("<i", -1) + b"\x00")
        s.sendall(_HDR.pack(16 + len(body), 1, 0, OP_MSG) + body)
        assert s.recv(1) == b""
        s.close()


@BOTH
def test_kvdb_cluster_get_range_dedupes_keys(pkg):
    resp, kvdb = PKGS[pkg]["resp"], PKGS[pkg]["kvdb"]
    store = {b"kv:a": b"1", b"kv:b": b"2"}

    class _FakeNode:
        def __init__(self, keys):
            self._keys = keys

        def scan_keys(self, pattern):
            return list(self._keys)

        def command(self, *args):
            assert args[0] == b"MGET"
            return [store.get(k) for k in args[1:]]

    kv = kvdb.RedisClusterKVDB.__new__(kvdb.RedisClusterKVDB)
    kv._resp = resp
    # mid-migration: BOTH nodes report key "a" from their SCAN sweep
    kv._clients = {"n1": _FakeNode([b"kv:a", b"kv:b"]),
                   "n2": _FakeNode([b"kv:a"])}
    kv._seed_addrs = ["n1", "n2"]
    kv._slot_map = ["n1" if s % 2 == 0 else "n2" for s in range(16384)]
    assert kv.get_range("a", "z") == [("a", "1"), ("b", "2")]


@BOTH
def test_bson_decoder_never_crashes_on_garbage(pkg):
    """Random and truncated bytes raise ValueError (or decode), never
    anything else, and never hang (the JAX ``test_mongo`` probe)."""
    import random

    bson = PKGS[pkg]["bson"]
    rng = random.Random(7)
    good = bson.encode({"a": "x" * 9, "b": [1, 2.5, b"z"], "c": {"d": 1}})
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
             for _ in range(300)]
    blobs += [good[:i] for i in range(len(good))]
    for i in range(4, len(good) - 1):
        mut = bytearray(good)
        mut[i] ^= 0xFF
        blobs.append(bytes(mut))
    outcome = []
    for blob in blobs:
        try:
            outcome.append(("ok", _plain(bson.decode(blob))))
        except (ValueError, struct.error, UnicodeDecodeError, IndexError) \
                as e:
            outcome.append(("err", type(e).__name__))
    # the same outcome in the other package
    other = PKGS["port" if pkg == "jax" else "jax"]["bson"]
    for blob, (kind, what) in zip(blobs, outcome):
        try:
            assert (kind, _plain(other.decode(blob))) == (kind, what)
        except (ValueError, struct.error, UnicodeDecodeError, IndexError) \
                as e:
            assert (kind, what) == ("err", type(e).__name__)


# =======================================================================
# RESP
# =======================================================================
ARGS = [(b"PING",), (b"SET", b"k", b"v"), (b"SET", b"", b"\r\n\x00"),
        (b"MGET",) + tuple(b"key%d" % i for i in range(40)),
        (b"SET", b"big", bytes(range(256)) * 300)]


def test_resp_request_frames_byte_equal():
    for args in ARGS:
        assert tresp.RespClient._encode(args) == \
            jresp.RespClient._encode(args)
    for addr in ("h:1", "h:2/3", ":6379", "10.0.0.1:7000/", "x"):
        if addr == "x":
            with pytest.raises(ValueError):
                jresp.parse_addr(addr)
            with pytest.raises(ValueError):
                tresp.parse_addr(addr)
            continue
        assert tresp.parse_addr(addr) == jresp.parse_addr(addr)
    for addr in ("h:27017", "h:1/db", "h:1/", ":2"):
        assert tmongowire.parse_mongo_addr(addr) == \
            jmongowire.parse_mongo_addr(addr)


def test_resp_slot_hash_equal():
    keys = [b"", b"{", b"{}", b"{}x", b"a{b}c", b"{user1}.a", b"x{y",
            b"123456789"] + [b"kv:avatarOf/bot%d" % i for i in range(2000)]
    for k in keys:
        assert tresp.crc16(k) == jresp.crc16(k)
        assert tresp.key_slot(k) == jresp.key_slot(k)
    assert tresp.crc16(b"123456789") == 0x31C3  # the XModem check value
    assert tresp.NUM_SLOTS == jresp.NUM_SLOTS == 16384


@CROSS
def test_resp_client_against_the_other_server(writer, reader):
    """``writer``'s server, ``reader``'s client: every convenience call."""
    with PKGS[writer]["miniredis"].MiniRedis() as srv:
        c = PKGS[reader]["resp"].RespClient.from_addr(srv.addr)
        assert c.ping()
        c.set("a", b"\x00\x01")
        c.set("b", 7)
        assert c.get("a") == b"\x00\x01" and c.get("b") == b"7"
        assert c.get("none") is None
        assert c.setnx("a", "x") is False and c.setnx("c", "y") is True
        assert c.mget(["a", "zz", "c"]) == [b"\x00\x01", None, b"y"]
        assert c.mget([]) == []
        assert sorted(c.scan_keys("*")) == [b"a", b"b", b"c"]
        assert c.exists("a") and not c.exists("zz")
        assert c.delete("a", "b", "zz") == 2
        with pytest.raises(PKGS[reader]["resp"].RespError):
            c.command("NOSUCH")
        c.close()
        db = PKGS[reader]["resp"].RespClient.from_addr(srv.addr + "/3")
        db.set("only3", "x")
        assert c.get("only3") is None and db.get("only3") == b"x"
        db.close()


# =======================================================================
# Wire: the same scripted commands, byte-equal replies
# =======================================================================
def _read_resp(f) -> bytes:
    """One RESP reply's raw bytes from a socket file."""
    line = f.readline()
    sigil, body = line[:1], line[1:-2]
    if sigil == b"$" and int(body) >= 0:
        return line + f.read(int(body) + 2)
    if sigil == b"*" and int(body) >= 0:
        return line + b"".join(_read_resp(f) for _ in range(int(body)))
    return line


def _frame(*args) -> bytes:
    return jresp.RespClient._encode(tuple(
        a if isinstance(a, bytes) else str(a).encode() for a in args))


REDIS_SCRIPT = [
    ("PING",), ("SET", "a", "1"), ("GET", "a"), ("GET", "none"),
    ("SETNX", "a", "2"), ("SETNX", "b", "2"), ("MGET", "a", "b", "c"),
    ("EXISTS", "a", "b", "c"), ("KEYS", "*"), ("SCAN", "0", "MATCH", "a*",
                                               "COUNT", "512"),
    ("DBSIZE",), ("HSET", "h", "f1", "v1", "f2", "v2"), ("HSET", "h", "f1",
                                                         "v3"),
    ("HGET", "h", "f1"), ("HGET", "h", "zz"), ("HGETALL", "h"),
    ("GET", "h"), ("MGET", "h", "a"), ("HSET", "a", "f", "v"),
    ("HDEL", "h", "f1", "zz"), ("EXPIRE", "a", "10"), ("EXPIRE", "zz", "1"),
    ("DEL", "a", "zz"), ("SELECT", "2"), ("GET", "b"), ("SET", "b", "db2"),
    ("SELECT", "0"), ("GET", "b"), ("CLUSTER", "SLOTS"), ("ASKING",),
    ("NOSUCH", "x"), ("FLUSHDB",), ("DBSIZE",),
]


def _redis_replies(srv, script, names: dict) -> list[bytes]:
    s = socket.create_connection((srv.host, srv.port), timeout=5)
    f = s.makefile("rb")
    out = []
    try:
        for cmd in script:
            s.sendall(_frame(*cmd))
            out.append(_name_nodes(_read_resp(f), names))
        s.sendall(b"PING\r\n")  # the inline form
        out.append(_read_resp(f))
    finally:
        f.close()
        s.close()
    return out


def _name_nodes(raw: bytes, names: dict) -> bytes:
    """Each server's address (and, in CLUSTER SLOTS, its port) by name."""
    for addr, name in names.items():
        port = addr.rsplit(":", 1)[1].encode()
        raw = raw.replace(addr.encode(), name.encode())
        raw = raw.replace(b":" + port + b"\r\n", b":" + name.encode()
                          + b"\r\n")
    return raw


def test_miniredis_replies_byte_equal():
    got = {}
    for pkg in PKGS:
        with PKGS[pkg]["miniredis"].MiniRedis() as srv:
            got[pkg] = _redis_replies(srv, REDIS_SCRIPT, {})
    assert got["port"] == got["jax"]
    assert got["port"][-1] == b"+PONG\r\n"


SPLIT = [(0, 5460), (5461, 10922), (10923, 16383)]


def _cluster(pkg: str) -> list:
    """Three cluster-mode nodes with the slots split as ``SPLIT``."""
    mod = PKGS[pkg]["miniredis"]
    nodes = [mod.MiniRedis(cluster_slots=r).start() for r in SPLIT]
    for n in nodes:
        n.peers = {m.addr: m.cluster_slots for m in nodes if m is not n}
    return nodes


def _stop_all(servers) -> None:
    """Stop servers side by side (each ``shutdown`` waits out its serve
    loop's 0.5 s poll)."""
    ts = [threading.Thread(target=s.stop) for s in servers]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def _slot_keys(lo: int, hi: int, n: int) -> list[str]:
    out, i = [], 0
    while len(out) < n:
        k = f"k{i}"
        if lo <= jresp.key_slot(k.encode()) <= hi:
            out.append(k)
        i += 1
    return out


def test_miniredis_cluster_replies_byte_equal():
    """MOVED for a key owned elsewhere, ASK during a migration, ASKING
    admitting one command, CROSSSLOT, CLUSTER SLOTS; a node's replies
    are equal with the three nodes' addresses named n0, n1, n2."""
    mine = _slot_keys(*SPLIT[0], 3)
    theirs = _slot_keys(*SPLIT[1], 2) + _slot_keys(*SPLIT[2], 1)
    moving = mine[2]
    script = [
        ("CLUSTER", "SLOTS"), ("CLUSTER", "NODES"), ("SET", mine[0], "a"),
        ("GET", mine[0]), ("SET", theirs[0], "x"), ("GET", theirs[2]),
        ("MGET", mine[0], mine[1]), ("MGET", mine[0], theirs[0]),
        ("SET", "{t}1", "1"), ("SET", "{t}2", "2"), ("MGET", "{t}1", "{t}2"),
        ("DEL", mine[0], theirs[0]), ("SET", moving, "m"), ("KEYS", "*"),
        ("SCAN", "0", "MATCH", "*"), ("PING",),
    ]
    migrate = [("GET", moving), ("ASKING",), ("GET", moving),
               ("GET", moving), ("SET", moving, "new")]
    got = {}
    for pkg in PKGS:
        nodes = _cluster(pkg)
        names = {n.addr: f"n{i}" for i, n in enumerate(nodes)}
        try:
            first = _redis_replies(nodes[0], script, names)
            # migrating `moving`'s slot from n0 to n1: n0 answers ASK,
            # n1 serves it after ASKING, then refuses it without
            nodes[0].ask[jresp.key_slot(moving.encode())] = nodes[1].addr
            on_src = _redis_replies(nodes[0], migrate[:1], names)
            on_dst = _redis_replies(nodes[1], migrate[1:], names)
            got[pkg] = (first, on_src, on_dst)
        finally:
            _stop_all(nodes)
    assert got["port"] == got["jax"]
    first, on_src, on_dst = got["port"]
    assert first[4].startswith(b"-MOVED ") and first[4].endswith(
        b" n1\r\n")
    assert first[7].startswith(b"-CROSSSLOT")
    assert on_src[0].startswith(b"-ASK ") and on_src[0].endswith(b" n1\r\n")
    assert on_dst[:2] == [b"+OK\r\n", b"$-1\r\n"]
    assert on_dst[2].startswith(b"-MOVED ")


def _mongo_script() -> list[dict]:
    db = {"$db": "goworld"}
    many = [{"_id": f"m{i:03d}", "v": i} for i in range(7)]
    return [dict(c, **db) for c in (
        {"hello": 1}, {"isMaster": 1}, {"ping": 1},
        {"insert": "c", "documents": [{"_id": "a", "x": 1, "s": "t"},
                                      {"y": 2.5}]},
        {"insert": "c", "documents": [{"_id": "a", "x": 9}]},
        {"insert": "m", "documents": many},
        {"update": "c", "updates": [{"q": {"_id": "a"},
                                     "u": {"x": 3, "l": [1, None]},
                                     "upsert": True, "multi": False}]},
        {"update": "c", "updates": [{"q": {"_id": "b"}, "u": {"x": 4},
                                     "upsert": True, "multi": False},
                                    {"q": {"x": 99}, "u": {"x": 5}}]},
        {"update": "c", "updates": [{"q": {}, "u": {"$set": {"x": 1}}}]},
        {"find": "c", "filter": {}},
        {"find": "c", "filter": {"_id": "a"}, "limit": 1},
        {"find": "m", "filter": {"_id": {"$gte": "m002", "$lt": "m005"}},
         "sort": {"_id": -1}},
        {"find": "m", "filter": {"_id": {"$gt": "m001", "$lte": "m003"}},
         "projection": {"v": 1}},
        {"find": "m", "filter": {}, "projection": {"_id": 0, "v": 1},
         "limit": 2},
        {"find": "m", "filter": {}, "projection": {"v": 0}},
        {"find": "m", "filter": {"v": {"$eq": 3}}},
        {"find": "m", "filter": {"v": {"$in": [3]}}},
        {"find": "m", "filter": {}, "sort": {"v": 1}},
        {"find": "m", "filter": {}, "batchSize": 3},
        {"getMore": 1, "collection": "m", "batchSize": 3},
        {"getMore": 0, "collection": "m"},
        {"delete": "m", "deletes": [{"q": {"v": {"$gte": 2}}, "limit": 1}]},
        {"delete": "m", "deletes": [{"q": {}, "limit": 0}]},
        {"listCollections": 1}, {"drop": "c"}, {"listCollections": 1},
        {"find": "c", "filter": {}}, {"noSuchCommand": 1},
    )] + [{}]


def test_minimongo_replies_byte_equal():
    got = {}
    for pkg in PKGS:
        bson = PKGS[pkg]["bson"]
        with PKGS[pkg]["minimongo"].MiniMongo() as srv:
            s = socket.create_connection((srv.host, srv.port), timeout=5)
            script = _mongo_script()
            # the getMore's cursor id is the first find's: the servers'
            # counters run alike
            out = []
            for rid, cmd in enumerate(script, 1):
                raw = _mongo_raw(s, _op_msg(bson, cmd, rid))
                out.append(raw)
                if "batchSize" in cmd and "find" in cmd:
                    cid = bson.decode(raw, 21)["cursor"]["id"]
                    nxt = next(c for c in script if "getMore" in c)
                    nxt["getMore"] = cid
            s.close()
            got[pkg] = out
    assert got["port"] == got["jax"]
    replies = [jbson.decode(r, 21) for r in got["port"]]
    assert replies[4]["writeErrors"][0]["code"] == 11000
    assert [d["_id"] for d in replies[11]["cursor"]["firstBatch"]] == [
        "m004", "m003", "m002"]
    assert replies[18]["cursor"]["id"] != 0      # a multi-batch cursor
    assert replies[-1]["code"] == 59             # the empty command


# =======================================================================
# a slot migration in the middle of the cluster kvdb's get_range
# =======================================================================
@BOTH
def test_cluster_get_range_across_a_live_migration(pkg):
    """``get_range`` sweeps the nodes in turn; after the first node's
    sweep, a slot of that node's moves to the node swept last: its keys
    are copied there and the first node answers ASK for it. Both nodes
    then report the slot's keys; the range follows ASK (and the target's
    MOVED back to the source) and holds one copy of each key, equal to
    the other package's range over the same nodes."""
    nodes = _cluster(pkg)
    try:
        kv = PKGS[pkg]["kvdb"].RedisClusterKVDB([nodes[0].addr])
        keys = [f"avatarOf/bot{i}" for i in range(64)]
        for k in keys:
            kv.put(k, k.upper())
        by_addr = {n.addr: n for n in nodes}
        order = sorted(set(kv._slot_map))
        src, dst = by_addr[order[0]], by_addr[order[-1]]
        lo, hi = src.cluster_slots
        moving = next(s for s in (jresp.key_slot(b"kv:" + k.encode())
                                  for k in keys) if lo <= s <= hi)
        client = kv._client_for(src.addr)
        sweep = client.scan_keys
        moved = []

        def scan_then_migrate(pattern):
            got = sweep(pattern)
            if not moved:
                with src.lock, dst.lock:
                    d_src = src.dbs[0]
                    d_dst = dst.dbs.setdefault(0, {})
                    for k in list(d_src):
                        if jresp.key_slot(k) == moving:
                            d_dst[k] = d_src[k]
                            moved.append(k)
                    src.ask[moving] = dst.addr
            return got

        client.scan_keys = scan_then_migrate
        out = kv.get_range("avatarOf/", "avatarOf0")
        assert moved
        assert [k for k, _ in out] == sorted(keys)
        assert all(v == k.upper() for k, v in out)
        other = PKGS["port" if pkg == "jax" else "jax"]["kvdb"]
        kv2 = other.RedisClusterKVDB([nodes[2].addr])
        assert kv2.get_range("avatarOf/", "avatarOf0") == out
        kv.close()
        kv2.close()
    finally:
        _stop_all(nodes)


# =======================================================================
# storage and kvdb kinds
# =======================================================================
DOCS = {
    "A" * 16: {"name": "bob", "level": 3, "exp": 0.5, "bag": [1, "x", None],
               "nested": {"k": {"deep": [True, False]}}, "raw": b"\x00\xff"},
    "B" * 16: {"name": "eve", "big": 1 << 40, "neg": -(1 << 33)},
    "C" * 16: {},
}


@pytest.fixture()
def servers():
    """The port's minimongo, a plain miniredis and a three-node cluster."""
    mongo = tminimongo.MiniMongo().start()
    redis = tminiredis.MiniRedis().start()
    nodes = _cluster("port")
    yield dict(mongodb=mongo.addr + "/goworld", redis=redis.addr,
               redis_cluster=",".join(n.addr for n in nodes))
    _stop_all([mongo, redis, *nodes])


def _storage_roundtrip(st):
    for eid, d in DOCS.items():
        st.write("Avatar", eid, d)
    st.write("Monster", "M" * 16, {"hp": 5})
    for eid, d in DOCS.items():
        assert st.read("Avatar", eid) == d
        assert st.exists("Avatar", eid)
    assert st.read("Avatar", "Z" * 16) is None
    assert not st.exists("Avatar", "Z" * 16)
    assert sorted(st.list_entity_ids("Avatar")) == sorted(DOCS)
    st.write("Avatar", "A" * 16, {"name": "bob2"})  # a whole-doc replace
    assert st.read("Avatar", "A" * 16) == {"name": "bob2"}


@pytest.mark.parametrize("kind", ["memory", "filesystem", "redis",
                                  "mongodb"])
def test_storage_kind_roundtrips(kind, servers, tmp_path):
    loc = str(tmp_path / "es") if kind == "filesystem" else \
        servers.get(kind, "")
    st = tstorage.open_backend(kind, loc)
    _storage_roundtrip(st)
    st.close()


@CROSS
@pytest.mark.parametrize("kind", ["filesystem", "redis", "mongodb"])
def test_storage_read_across_packages(kind, writer, reader, servers,
                                      tmp_path):
    loc = str(tmp_path / "es") if kind == "filesystem" else servers[kind]
    w = PKGS[writer]["storage"].open_backend(kind, loc)
    r = PKGS[reader]["storage"].open_backend(kind, loc)
    for eid, d in DOCS.items():
        w.write("Avatar", eid, d)
    for eid, d in DOCS.items():
        assert r.read("Avatar", eid) == d
    assert sorted(r.list_entity_ids("Avatar")) == sorted(DOCS)
    if kind == "redis":  # the stored blobs themselves are equal
        c = tresp.RespClient.from_addr(loc)
        blob = c.get(f"gw:Avatar:{'A' * 16}")
        assert tstorage.mpack.unpackb(blob, strict_map_key=True) == \
            DOCS["A" * 16]
        c.close()
    w.close()
    r.close()


def test_async_storage_over_mongodb(servers):
    """The port's ``Storage`` front-end over the mongodb kind: callbacks
    are posted, the saved attrs read back."""
    posted = []
    st = tstorage.Storage(tstorage.open_backend("mongodb",
                                                servers["mongodb"]),
                          posted.append)
    st.save("Avatar", "A" * 16, DOCS["A" * 16])
    done = {}
    st.load("Avatar", "A" * 16, lambda d: done.update(got=d))
    st.list_entity_ids("Avatar", lambda xs: done.update(ids=xs))
    deadline = time.time() + 10
    while len(posted) < 2 and time.time() < deadline:
        time.sleep(0.01)
    for cb in posted:
        cb()
    assert done == {"got": DOCS["A" * 16], "ids": ["A" * 16]}
    st.shutdown()


KV = [("avatarOf/alice", "E" * 16), ("avatarOf/bob", "F" * 16),
      ("avatarOf/bob2", "G" * 16), ("mail/1", "hi"), ("zz", "end")]


@pytest.mark.parametrize("kind", ["memory", "filesystem", "redis",
                                  "redis_cluster", "mongodb"])
def test_kvdb_kind_roundtrips(kind, servers, tmp_path):
    loc = str(tmp_path / "kv.mp") if kind == "filesystem" else \
        servers.get(kind, "")
    kv = tkvdb.open_kvdb_backend(kind, loc)
    for k, v in KV:
        kv.put(k, v)
    for k, v in KV:
        assert kv.get(k) == v
    assert kv.get("none") is None
    assert kv.get_range("avatarOf/", "avatarOf0") == KV[:3]
    assert kv.get_range("avatarOf/bob", tkvdb.next_larger_key(
        "avatarOf/bob")) == KV[1:2]
    kv.put("avatarOf/bob", "H" * 16)
    assert kv.get("avatarOf/bob") == "H" * 16
    kv.close()


@CROSS
@pytest.mark.parametrize("kind", ["filesystem", "redis", "redis_cluster",
                                  "mongodb"])
def test_kvdb_read_across_packages(kind, writer, reader, servers, tmp_path):
    loc = str(tmp_path / "kv.mp") if kind == "filesystem" else \
        servers[kind]
    w = PKGS[writer]["kvdb"].open_kvdb_backend(kind, loc)
    for k, v in KV:
        w.put(k, v)
    w.close()
    r = PKGS[reader]["kvdb"].open_kvdb_backend(kind, loc)
    for k, v in KV:
        assert r.get(k) == v
    assert r.get_range("", "\x7f") == KV
    r.close()


def test_kvdb_kinds_refused_no_more():
    """The refusals naming ROADMAP are gone: unknown kinds still raise
    ValueError as the JAX package's do."""
    for mod in (tkvdb, jkvdb):
        with pytest.raises(ValueError):
            mod.open_kvdb_backend("nosuch", "")
    for mod in (tstorage, jstorage):
        with pytest.raises(ValueError):
            mod.open_backend("nosuch", "")


# =======================================================================
# gwredis / gwmongo: the async document APIs
# =======================================================================
def _pump(posted: list, n: int, timeout: float = 10.0) -> None:
    deadline = time.time() + timeout
    while len(posted) < n and time.time() < deadline:
        time.sleep(0.005)
    assert len(posted) >= n, posted
    for cb in posted[:n]:
        cb()
    del posted[:n]


def _gw(pkg: str, posted: list):
    return PKGS[pkg]["workers"](posted.append)


@CROSS
@pytest.mark.parametrize("store", ["mongodb", "redis"])
def test_gwmongo_documents_across_packages(writer, reader, store, servers):
    posted: list = []
    connect = "connect_mongodb" if store == "mongodb" else "connect_redis"
    addr = servers[store]
    wm = getattr(PKGS[writer]["gwmongo"].GWMongo, connect)(
        addr, _gw(writer, posted))
    rm = getattr(PKGS[reader]["gwmongo"].GWMongo, connect)(
        addr, _gw(reader, posted))
    got: dict = {}
    wm.insert_one("game", "mail", {"_id": "m1", "to": "bob", "n": 1,
                                   "body": {"t": "hi", "tags": ["a"]}},
                  lambda r, e: got.update(ins=(r, e)))
    wm.insert_one("game", "mail", {"_id": "m2", "to": "eve", "n": 2},
                  lambda r, e: got.update(ins2=(r, e)))
    _pump(posted, 2)
    rm.find_id("game", "mail", "m1", lambda r, e: got.update(one=(r, e)))
    rm.find_one("game", "mail", {"to": "eve"},
                lambda r, e: got.update(q=(r, e)))
    rm.find_all("game", "mail", {}, lambda r, e: got.update(all=(r, e)))
    rm.count("game", "mail", lambda r, e: got.update(n=(r, e)))
    _pump(posted, 4)
    assert got["ins"] == ("m1", None)
    assert got["one"] == ({"_id": "m1", "to": "bob", "n": 1,
                           "body": {"t": "hi", "tags": ["a"]}}, None)
    assert got["q"] == ({"_id": "m2", "to": "eve", "n": 2}, None)
    assert sorted(d["_id"] for d in got["all"][0]) == ["m1", "m2"]
    assert got["n"] == (2, None)
    rm.update_id("game", "mail", "m1", {"n": 5},
                 lambda r, e: got.update(upd=(r, e)))
    rm.remove_id("game", "mail", "m2", lambda r, e: got.update(rm=(r, e)))
    _pump(posted, 2)
    wm.find_all("game", "mail", {}, lambda r, e: got.update(after=(r, e)))
    _pump(posted, 1)
    assert (got["upd"], got["rm"]) == ((None, None), (True, None))
    assert got["after"][0] == [{"_id": "m1", "to": "bob", "n": 5,
                                "body": {"t": "hi", "tags": ["a"]}}]
    wm.close()
    rm.close()


@CROSS
def test_gwredis_commands_across_packages(writer, reader, servers):
    posted: list = []
    w = PKGS[writer]["gwredis"].GWRedis(servers["redis"],
                                        _gw(writer, posted))
    r = PKGS[reader]["gwredis"].GWRedis(servers["redis"],
                                        _gw(reader, posted))
    got: dict = {}
    w.set("greeting", "hello", lambda v, e: got.update(set=(v, e)))
    _pump(posted, 1)
    r.get("greeting", lambda v, e: got.update(get=(v, e)))
    r.command(lambda v, e: got.update(dbsize=(v, e)), "DBSIZE")
    _pump(posted, 2)
    r.delete("greeting", lambda v, e: got.update(dele=(v, e)))
    _pump(posted, 1)
    assert got == {"set": ("OK", None), "get": (b"hello", None),
                   "dbsize": (1, None), "dele": (1, None)}
    w.close()
    r.close()


def test_wire_clients_reconnect():
    """A server that drops the connection: the port's clients reconnect
    once, transparently, as the JAX package's do."""
    with tminimongo.MiniMongo() as srv:
        c = tmongowire.MongoClient.from_addr(srv.addr)
        assert c.ping()
        c._sock.close()
        assert c.ping()
        c.close()
    with tminiredis.MiniRedis() as srv:
        c = tresp.RespClient.from_addr(srv.addr)
        assert c.ping()
        c._sock.close()
        assert c.ping()
        c.close()


def test_port_servers_run_beside_jax_servers():
    """Both packages' servers on one host, each bound to port 0: no
    shared state between the two."""
    with jminiredis.MiniRedis() as a, tminiredis.MiniRedis() as b:
        assert a.port != b.port
        ca, cb = (tresp.RespClient.from_addr(s.addr) for s in (a, b))
        ca.set("x", "1")
        assert cb.get("x") is None and ca.get("x") == b"1"
        ca.close()
        cb.close()
