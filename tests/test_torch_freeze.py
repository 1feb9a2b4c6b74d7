"""The port's freeze/restore (``goworld_tpu_torch.freeze``) against the
JAX package's ``goworld_tpu.freeze`` on the CPU, capacity 64.

One scripted world (fixed entity ids, a fake clock, method-name timers, a
client binding, an entity parked in the nil space) runs on both packages'
Worlds; their freeze records must be equal key by key and serialize to
the same bytes, as must the SnapshotChain's keyframe and delta records
built from them. The port's own cases follow the reference's
``tests/test_freeze.py``: round trips through restore, async checkpoints
capturing their tick, the corrupt-file walk, the chain's cadence, its
lattice round trip and its fallbacks, and the audit's chain scrub."""

from __future__ import annotations

import os
import time

import msgpack
import numpy as np
import pytest

from goworld_tpu import entity as jent
from goworld_tpu import freeze as jfreeze
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import freeze
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids, mpack

GRID = dict(radius=30.0, extent_x=120.0, extent_z=120.0, k=8,
            cell_cap=16, row_block=64, topk_impl="sort")
WORLD = dict(capacity=64, npc_speed=6.0, enter_cap=256, leave_cap=256,
             sync_cap=256, attr_sync_cap=64, input_cap=64,
             delta_rows_cap=64)


class Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self) -> float:
        return self.t


def types(pkg):
    class Npc(pkg.Entity):
        ATTRS = {"hp": "allclients", "name": "client"}

        def __init__(self):
            super().__init__()
            self.heal_count = 0

        def Heal(self, amount):
            self.heal_count += 1
            self.attrs["hp"] = self.attrs.get("hp", 0) + amount

    class Arena(pkg.Space):
        pass

    return Npc, Arena


def make_world(pkg: str, grid: dict | None = None, planes: bool = False,
               clock=None, **kw):
    mod = jent if pkg == "jax" else tent
    g = dict(GRID, **(grid or {}))
    if pkg == "jax":
        cfg = JConfig(grid=JGrid(sweep_impl="ranges", sort_impl="argsort",
                                 **g), **WORLD)
    else:
        cfg = TConfig(grid=TGrid(sweep_impl="fused", sort_impl="pallas",
                                 **g), **WORLD)
        kw["device"] = "cpu"
    if not planes:
        kw.update(telemetry_live=False, residency=False, audit=False)
    w = mod.World(cfg, clock=clock or Clock(), **kw)
    npc, arena = types(mod)
    w.register_entity("Npc", npc)
    w.register_space("Arena", arena)
    w.create_nil_space()
    return w


def script(w, pkg: str, n: int = 12):
    """The scripted population; returns (arena, entities)."""
    mod = jent if pkg == "jax" else tent
    arena = w.create_space("Arena", motd="welcome",
                           eid=ids.gen_fixed_id("freeze.arena"))
    rng = np.random.default_rng(2)
    ents = []
    for i in range(n):
        e = w.create_entity(
            "Npc", space=arena, pos=(float(rng.uniform(5, 115)), 0.0,
                                     float(rng.uniform(5, 115))),
            moving=i % 2 == 0, eid=ids.gen_fixed_id(f"freeze.{i}"))
        e.attrs["hp"] = 50 + i
        ents.append(e)
    ents[0].attrs["name"] = "alice"
    ents[1].set_yaw(1.5)
    ents[1].add_timer(0.05, "Heal", 5)
    ents[0].client = mod.GameClient(2, "c" * 16, w)
    ents.append(w.create_entity("Npc", pos=(0.0, 0.0, 0.0),
                                eid=ids.gen_fixed_id("freeze.parked")))
    return arena, ents


def both(ticks: int = 3, **kw):
    out = {}
    for pkg in ("jax", "port"):
        w = make_world(pkg, **kw)
        arena, ents = script(w, pkg)
        for _ in range(ticks):
            w.tick()
        out[pkg] = (w, arena, ents)
    return out


def test_freeze_records_match_jax():
    ws = both()
    jd = jfreeze.freeze_world(ws["jax"][0])
    td = freeze.freeze_world(ws["port"][0])
    assert td.keys() == jd.keys()
    for key in jd:
        assert td[key] == jd[key], key
    assert mpack.packb(td) == msgpack.packb(jd, use_bin_type=True)
    assert mpack.unpackb(mpack.packb(td)) == td


def test_files_cross_read_between_packages(tmp_path):
    ws = both()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = jfreeze.freeze_to_file(ws["jax"][0], str(tmp_path / "j"))
    pt = freeze.freeze_to_file(ws["port"][0], str(tmp_path / "t"))
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert freeze.read_freeze_file(pj) == jfreeze.read_freeze_file(pt)


def test_requires_nil_space_and_empty_target():
    w = tent.World(TConfig(grid=TGrid(**GRID), **WORLD), device="cpu",
                   telemetry_live=False, residency=False, audit=False)
    with pytest.raises(RuntimeError):
        freeze.freeze_world(w)
    data = freeze.freeze_world(make_world("port"))
    w2 = make_world("port")
    w2.create_space("Arena")
    with pytest.raises(RuntimeError):
        freeze.restore_world(w2, data)


def test_world_roundtrip():
    """Restore into a fresh World (its audit ledger re-anchored on the
    restored population): attrs, client binding, spaces, parked entity,
    positions and yaw on the first tick, interest rebuilt, the method
    timer still firing."""
    clock = Clock()
    w, arena, ents = both(clock=clock)["port"]
    data = freeze.freeze_world(w)
    w2 = make_world("port", planes=True, clock=clock)
    freeze.restore_world(w2, data)
    assert set(w2.entities) == set(w.entities)
    assert w2.audit.ledger.live_eids() == set(w2.entities)
    assert w2.spaces[arena.id].attrs.get("motd") == "welcome"
    a2, b2 = w2.entities[ents[0].id], w2.entities[ents[1].id]
    assert a2.attrs.get("name") == "alice" and a2.client.gate_id == 2
    assert w2.entities[ents[-1].id].space is w2.nil_space
    w2.tick()
    for i, e in enumerate(ents[:-1]):
        if i % 2:  # still entities hold the frozen position
            assert np.array_equal(w2.read_pos(0, w2.entities[e.id].slot),
                                  w.read_pos(0, e.slot)), e.id
    assert w2.read_yaw(0, b2.slot) == pytest.approx(1.5)
    assert a2.interested_in
    assert all(a2.id in w2.entities[x].interested_by
               for x in a2.interested_in)
    clock.t += 1.0
    w2.tick()
    assert b2.heal_count == 1 and b2.attrs.get("hp") == 51 + 5


def test_restored_q16_world_rebuilds_on_its_lattice():
    """A q16 World with a skin: the restored World's first tick rebuilds
    its (invalid) Verlet cache, and its planes are the source's lattice
    points, which re-quantize to themselves."""
    grid = dict(skin=4.0, precision="q16")
    w, _, _ = both(grid=grid)["port"]
    chain = freeze.SnapshotChain(w, ".", keyframe_every=4)
    kind, rec = chain.build(freeze.freeze_world(w, run_hooks=False))
    data = freeze._inject_planes(dict(rec["host"]), rec["planes"],
                                 chain.step, chain.origin)
    w2 = make_world("port", grid=grid)
    freeze.restore_world(w2, data)
    w2.tick()
    assert int(w2.last_outputs.aoi_rebuilt[0]) == 1
    step = w2.cfg.grid.quant_step
    for ed in data["entities"]:
        e = w2.entities[ed["id"]]
        if e.slot is None:
            continue
        x, _, z = w2.read_pos(0, e.slot)
        if not ed["moving"]:
            assert (x / step).is_integer() and (z / step).is_integer()
    _, rec2 = freeze.SnapshotChain(w2, ".", 4).build(
        freeze.freeze_world(w2, run_hooks=False))
    still = [i for i, ed in enumerate(data["entities"]) if not ed["moving"]]
    a = np.frombuffer(rec["planes"]["pos_xz"], np.int16).reshape(-1, 2)
    b = np.frombuffer(rec2["planes"]["pos_xz"], np.int16).reshape(-1, 2)
    assert np.array_equal(a[still], b[still])


def test_checkpoint_async_restores_its_capture_point(tmp_path):
    """The capture is the tick boundary it was called at: later ticks
    and attr writes do not reach the file, which holds no slot refs and
    equals a synchronous freeze at that boundary."""
    w, _, ents = both()["port"]
    sync = freeze.freeze_world(w, run_hooks=False)
    handle = freeze.checkpoint_async(w, str(tmp_path))
    for _ in range(5):
        w.tick()
    for e in ents:
        e.attrs["hp"] = 1
    handle.join(30)
    assert handle.path and handle.nbytes == os.path.getsize(handle.path)
    assert handle.capture_s > 0 and handle.worker_s > 0
    data = freeze.read_freeze_file(handle.path)
    assert all("_slot" not in rec for rec in data["entities"])
    assert data == sync
    with pytest.raises(RuntimeError, match="in flight"):
        w._ckpt_inflight = True
        freeze.checkpoint_async(w, str(tmp_path))


def test_mpack_is_msgpack_byte_for_byte():
    """The port's MessagePack codec against the ``msgpack`` package on
    every type and length class a record can hold, and its refusal of
    bytes that are not exactly one object."""
    objs = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
            2**32 - 1, 2**32, 2**63, -1, -32, -33, -128, -129, -32768,
            -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, float("inf"),
            "", "a" * 31, "a" * 32, "\u00e9" * 200, "x" * 70000, b"",
            b"x" * 300, b"y" * 70000, [], [1] * 15, [1] * 16, [2] * 70000,
            {}, {str(i): i for i in range(15)},
            {str(i): i for i in range(16)}, {1: 2, "a": [None, {"b": b"c"}]},
            (1, 2)]
    for o in objs:
        ref = msgpack.packb(o, use_bin_type=True)
        assert mpack.packb(o) == ref
        assert mpack.unpackb(ref) == msgpack.unpackb(
            ref, raw=False, strict_map_key=False)
    for bad in (b"", b"\x92\x01", b"\xd9\x05ab", b"\x01\x02", b"\xc1",
                b"\xcd\x01", b"\xc4\x05ab"):
        with pytest.raises(mpack.UnpackError):
            mpack.unpackb(bad)


def test_freeze_drains_a_pipelined_world():
    w = make_world("port", pipeline_decode=True)
    _, ents = script(w, "port")
    for _ in range(3):
        w.tick()
    assert w._pending_outs is not None
    freeze.freeze_world(w)
    assert w._pending_outs is None
    assert any(e.interested_in for e in ents)


class TestCorruption:
    def frozen(self):
        w, _, ents = both()["port"]
        return ents[0], freeze.freeze_world(w)

    def test_truncated_freeze_falls_back_to_checkpoint(self, tmp_path):
        e, data = self.frozen()
        freeze.write_freeze_file(
            str(tmp_path / freeze.checkpoint_filename(1)), data)
        blob = mpack.packb(data)
        fz = tmp_path / freeze.freeze_filename(1)
        fz.write_bytes(blob[: len(blob) // 2])
        later = time.time() + 5
        os.utime(str(fz), (later, later))
        assert freeze.latest_snapshot_path(1, str(tmp_path)) == str(fz)
        w2 = make_world("port")
        freeze.restore_from_file(w2, str(tmp_path))
        assert w2.entities[e.id].attrs.get("hp") == 50
        assert freeze.has_restorable_snapshot(1, str(tmp_path))

    def test_all_corrupt_rejected_not_half_loaded(self, tmp_path):
        _, data = self.frozen()
        (tmp_path / freeze.freeze_filename(1)).write_bytes(
            mpack.packb(data)[:40])
        assert not freeze.has_restorable_snapshot(1, str(tmp_path))
        w2 = make_world("port")
        with pytest.raises(freeze.CorruptSnapshotError):
            freeze.restore_from_file(w2, str(tmp_path))
        assert list(w2.entities) == [w2.nil_space.id]
        with pytest.raises(FileNotFoundError):
            freeze.restore_from_file(w2, str(tmp_path / "none"))

    def test_parseable_but_wrong_shape_rejected(self, tmp_path):
        p = tmp_path / freeze.freeze_filename(1)
        p.write_bytes(mpack.packb(["not", "a", "freeze"]))
        with pytest.raises(freeze.CorruptSnapshotError):
            freeze.read_freeze_file(str(p))


class TestSnapshotChain:
    def chains(self, tmp_path, every=4):
        ws = both()
        out = {}
        for pkg, mod in (("jax", jfreeze), ("port", freeze)):
            d = tmp_path / pkg
            d.mkdir()
            out[pkg] = (ws[pkg], mod.SnapshotChain(ws[pkg][0], str(d),
                                                   keyframe_every=every))
        return out

    def test_records_byte_identical_to_jax(self, tmp_path):
        """A keyframe, then (one entity moved, one tick on) a delta, each
        built by both packages from their own Worlds' freezes."""
        cs = self.chains(tmp_path)
        for step in range(2):
            recs = {}
            for pkg, mod in (("jax", jfreeze), ("port", freeze)):
                (w, _, ents), chain = cs[pkg]
                if step:
                    ents[3].set_position((100.0, 0.0, 100.0))
                    w.tick()
                recs[pkg] = chain.build(mod.freeze_world(w, run_hooks=False))
            assert recs["port"][0] == recs["jax"][0] == ("delta" if step
                                                          else "key")
            assert mpack.packb(recs["port"][1]) == msgpack.packb(
                recs["jax"][1], use_bin_type=True)
        # the moved entity and the movers ship their planes; every still
        # entity references its keyframe row
        rows = np.frombuffer(recs["port"][1]["rows"], np.int32)
        assert rows[3] < 0
        assert all(rows[i] == i for i in (1, 5, 7, 9, 11, 12))

    def test_records_resolve_as_their_files(self, tmp_path):
        """A keyframe and a delta record resolve in memory to what their
        files resolve to; a delta against another keyframe is corrupt."""
        (w, _, ents), chain = self.chains(tmp_path)["port"]
        data = freeze.freeze_world(w, run_hooks=False)
        kind, key = chain.build(data)
        pk = chain.write_record(kind, key)
        key_file = mpack.unpackb(open(pk, "rb").read())
        ents[3].set_position((90.0, 0.0, 90.0))
        w.tick()
        kind, delta = chain.build(freeze.freeze_world(w, run_hooks=False))
        pd = chain.write_record(kind, delta)
        assert freeze.resolve_record(key_file) == freeze.read_freeze_file(pk)
        assert freeze.resolve_record(mpack.unpackb(open(pd, "rb").read()),
                                     key_file) == freeze.read_freeze_file(pd)
        other = dict(key_file, planes=dict(key_file["planes"],
                                           yaw=b"\0" * 26))
        with pytest.raises(freeze.CorruptSnapshotError):
            freeze.resolve_record(mpack.unpackb(open(pd, "rb").read()),
                                  other)

    def test_keyframe_cadence_honored(self, tmp_path):
        (w, _, _), chain = self.chains(tmp_path, every=3)["port"]
        kinds = ["K" if chain.write().endswith("_ckpt_key.dat") else "D"
                 for _ in range(7)]
        assert kinds == ["K", "D", "D", "K", "D", "D", "K"]

    def test_roundtrip_bit_exact_on_restore(self, tmp_path):
        (w, _, ents), chain = self.chains(tmp_path)["port"]
        pk = chain.write()
        pd = chain.write()
        data = freeze.read_freeze_file(pd)
        assert data["version"] == 1
        assert data == jfreeze.read_freeze_file(pd)
        w2 = make_world("port")
        freeze.restore_world(w2, data)
        w2.tick()
        (tmp_path / "b").mkdir()
        pk2 = freeze.SnapshotChain(w2, str(tmp_path / "b"), 4).write()
        a = mpack.unpackb(open(pk, "rb").read())
        b = mpack.unpackb(open(pk2, "rb").read())
        still = np.array([not ed["moving"] for ed in data["entities"]])
        for nm, (dt, wd) in (("pos_xz", (np.int16, 2)),
                             ("pos_y", (np.float32, 1)),
                             ("yaw", (np.int16, 1)),
                             ("moving", (np.uint8, 1))):
            pa = np.frombuffer(a["planes"][nm], dt).reshape(-1, wd)
            pb = np.frombuffer(b["planes"][nm], dt).reshape(-1, wd)
            assert np.array_equal(pa[still], pb[still]), nm

    def test_corrupt_delta_falls_back_to_keyframe(self, tmp_path):
        (w, _, ents), chain = self.chains(tmp_path)["port"]
        chain.write()
        pd = chain.write()
        with open(pd, "r+b") as f:
            f.seek(24)
            f.write(b"\xff" * 16)
        with pytest.raises(freeze.CorruptSnapshotError):
            freeze.read_freeze_file(pd)
        w2 = make_world("port", planes=True)
        w2.audit.scrub_snapshots(os.path.dirname(pd), 1, 0)
        assert w2.audit.scrub_stats["files"] == 2
        assert w2.audit.scrub_stats["corrupt"] == 1
        freeze.restore_from_file(w2, os.path.dirname(pd))
        assert set(w2.entities) == set(w.entities)

    def test_rewritten_keyframe_fails_delta_crc(self, tmp_path):
        (w, _, _), chain = self.chains(tmp_path)["port"]
        chain.write()
        pd = chain.write()
        w3 = make_world("port")
        sp3 = w3.create_space("Arena")
        w3.create_entity("Npc", space=sp3, pos=(99.0, 0.0, 99.0))
        w3.tick()
        freeze.SnapshotChain(w3, os.path.dirname(pd), 4).write()
        with pytest.raises(freeze.CorruptSnapshotError,
                           match="CRC mismatch"):
            freeze.read_freeze_file(pd)
        w2 = make_world("port")
        freeze.restore_from_file(w2, os.path.dirname(pd))

    def test_scrub_matches_jax_and_reads_zero_on_a_good_chain(self,
                                                               tmp_path):
        (w, _, _), chain = self.chains(tmp_path)["port"]
        chain.write()
        chain.write()
        d = os.path.dirname(chain.write())
        planes = []
        for pkg in ("jax", "port"):
            wp = make_world(pkg, planes=True)
            wp.audit.scrub_snapshots(d, 1, 0)
            planes.append(wp.audit.scrub_stats)
        assert planes[0] == planes[1] == {"walks": 1, "files": 2,
                                          "corrupt": 0, "last_error": None}

    def test_world_keeps_the_keyframe_knob(self):
        w = make_world("port", snapshot_keyframe_every=4)
        assert w.snapshot_keyframe_every == 4
        w.tick()
        assert make_world("port", snapshot_keyframe_every=-3) \
            .snapshot_keyframe_every == 0
