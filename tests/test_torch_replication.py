"""The port's hot-standby replication plane against the JAX package's, on
the CPU.

Each case of ``tests/test_replication.py`` runs here on both packages
(``goworld_tpu.replication`` and ``goworld_tpu_torch.replication``, the
port's Worlds on ``device="cpu"``) and holds the port to the JAX
package's outcome: the torn-stream taxonomy by reason, the worker's
never-block contract, the promotion arbitration and the ``/standby``
registry. Tolerance is exact throughout: frames and logs compare as
bytes, Worlds entity for entity and lane for lane.

Across the packages: the same seeded World streams byte-equal frames;
a JAX stream applied by the port's ``StandbyApplier`` gives the World
the JAX applier gives, after every frame and after the promotion tick,
and the reverse; the in-process ``run_failover`` (the JAX package's
``tools/chaos_soak.py`` against ``goworld_tpu_torch.tools.chaos_soak``,
n 96, the soak's size) gives equal reports, decision logs and
censuses, and the promoted Worlds' next ticks are equal. Entity ids are
one seeded sequence on each side (``ids.gen_entity_id`` patched), so
the two packages mint the same ids.

One end-to-end case serves a deployment through the port's CLI on the
CPU: a primary, its standby and a third game, a manual handoff to the
third game through ``/rebalance``, the primary killed, the watchdog
promoting the standby, and a bot served by the promoted game.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import os
import threading
import time
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest
import torch

from goworld_tpu import entity as jent
from goworld_tpu import freeze as jfreeze
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.replication import frames as jframes
from goworld_tpu.replication import promote as jpromote
from goworld_tpu.replication import standby as jstandby
from goworld_tpu.replication import worker as jworker
from goworld_tpu.utils import audit as jaudit
from goworld_tpu.utils import ids as jids
from goworld_tpu.utils import metrics as jmetrics
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import freeze as tfreeze
from goworld_tpu_torch import interop
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.replication import frames as tframes
from goworld_tpu_torch.replication import promote as tpromote
from goworld_tpu_torch.replication import standby as tstandby
from goworld_tpu_torch.replication import worker as tworker
from goworld_tpu_torch.utils import audit as taudit
from goworld_tpu_torch.utils import ids as tids
from goworld_tpu_torch.utils import metrics as tmetrics

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

J = SimpleNamespace(name="jax", ent=jent, freeze=jfreeze, frames=jframes,
                    promote=jpromote, standby=jstandby, worker=jworker,
                    audit=jaudit, metrics=jmetrics, ids=jids,
                    Config=JConfig, Grid=JGrid, kw={})
T = SimpleNamespace(name="port", ent=tent, freeze=tfreeze, frames=tframes,
                    promote=tpromote, standby=tstandby, worker=tworker,
                    audit=taudit, metrics=tmetrics, ids=tids,
                    Config=TConfig, Grid=TGrid, kw={"device": "cpu"})
PKGS = (J, T)

pytestmark = pytest.mark.replication


@pytest.fixture(autouse=True)
def _fresh_registries():
    for p in PKGS:
        p.metrics.REGISTRY.reset()
        p.standby.reset()
    yield
    for p in PKGS:
        p.metrics.REGISTRY.reset()
        p.standby.reset()


def seeded_ids(mp) -> None:
    """``gen_entity_id`` on both packages: one seeded sequence each."""
    for mod in (jids, tids):
        seq = itertools.count()
        mp.setattr(mod, "gen_entity_id",
                   lambda seq=seq, mod=mod: mod.gen_fixed_id(
                       f"repl.{next(seq)}"))


def both(fn):
    """``fn`` on each package; the port's result must be the JAX
    package's."""
    got = [fn(p) for p in PKGS]
    assert got[0] == got[1], (got[0], got[1])
    return got[0]


# =======================================================================
# a real primary world streaming real chain records, on both packages
# =======================================================================
def _mk_world(p, game_id: int):
    class Mob(p.ent.Entity):
        ATTRS = {"hp": "allclients hot:0"}

    cfg = p.Config(
        capacity=64,
        grid=p.Grid(radius=30.0, extent_x=200.0, extent_z=200.0),
        input_cap=64,
    )
    w = p.ent.World(cfg, n_spaces=1, game_id=game_id, **p.kw)
    w.register_entity("Mob", Mob)
    w.register_space("Arena", p.ent.Space)
    return w


def _stream(p, d):
    w = _mk_world(p, 941)
    w.create_nil_space()
    sp = w.create_space("Arena")
    rng = np.random.default_rng(7)
    ents = []
    for i in range(10):
        x, z = rng.uniform(20.0, 180.0, 2)
        e = sp.create_entity("Mob", pos=(float(x), 0.0, float(z)))
        e.attrs["hp"] = i
        ents.append(e)
    ents[0].set_client(p.ent.GameClient(1, "repl-c0", w))
    chain = p.freeze.SnapshotChain(w, str(d), keyframe_every=4)
    enc = p.frames.StreamEncoder()
    frames = []  # (kind, tick, blob)
    for _t in range(9):
        for e in ents:
            if e.destroyed:
                continue
            x, z = rng.uniform(20.0, 180.0, 2)
            w.stage_pose(e, (float(x), 0.0, float(z)),
                         yaw=float(rng.uniform(0, 6.28)))
        w.tick()
        data, tick = p.freeze.SnapshotChain.complete_capture(
            chain.capture())
        kind, rec = chain.build(data)
        frames.append((kind, tick, enc.encode(tick, kind, rec)))
    assert [k for k, _t, _b in frames].count("key") == 3
    return SimpleNamespace(w=w, ents=ents, frames=frames, chain=chain,
                           enc=enc)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Per package: the primary world, its entities and its encoded wire
    stream (9 records at keyframe_every=4: keys at 0, 4, 8), with the
    same seeded pose churn between captures on both sides."""
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    out = {}
    try:
        for p in PKGS:
            out[p.name] = _stream(p, tmp_path_factory.mktemp(
                f"repl_{p.name}"))
        yield out
    finally:
        mp.undo()
        for p in PKGS:
            p.audit.unregister("game941")
            w = out.get(p.name)
            if w is not None and w.w.audit is not None:
                w.w.audit.close()


def _frames(streams, p):
    return streams[p.name].frames


def _tamper(blob: bytes, **patch) -> bytes:
    fr = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    fr.update(patch)
    return msgpack.packb(fr, use_bin_type=True)


def test_same_world_streams_byte_equal_frames(streams):
    """The same seeded World in both packages: every frame on the wire,
    keyframes and deltas, byte for byte."""
    jf, tf = streams["jax"].frames, streams["port"].frames
    assert [(k, t) for k, t, _ in jf] == [(k, t) for k, t, _ in tf]
    for (_k, t, a), (_k2, _t2, b) in zip(jf, tf):
        assert a == b, f"frame at tick {t}"


# =======================================================================
# stream determinism: double apply -> bit-identical lattice planes
# =======================================================================
def test_double_apply_is_bit_identical(streams):
    def run(p):
        frames = _frames(streams, p)
        d1, d2 = p.frames.StreamDecoder(), p.frames.StreamDecoder()
        out = []
        for _kind, _tick, blob in frames:
            k1, t1, _data1, planes1, eids1 = d1.feed(blob)
            k2, t2, _data2, planes2, eids2 = d2.feed(blob)
            assert (k1, t1, eids1) == (k2, t2, eids2)
            assert set(planes1) == {"pos_xz", "pos_y", "yaw", "moving"}
            for nm in planes1:
                assert planes1[nm] == planes2[nm], nm
            out.append((k1, t1, eids1, planes1))
        assert d1.applied_seq == d2.applied_seq == len(frames) - 1
        return out

    both(run)


def test_delta_resolves_to_keyframe_identical_planes(streams):
    def run(p):
        dec = p.frames.StreamDecoder()
        key_planes = None
        for kind, _t, blob in _frames(streams, p)[:2]:
            k, _tick, data, planes, eids = dec.feed(blob)
            if k == "key":
                key_planes = (planes, eids)
            last = (planes, data["entities"])
        planes, eids = key_planes
        assert planes["pos_xz"]
        return key_planes, last

    both(run)


# =======================================================================
# torn streams: rejected whole, named reason, heals at next keyframe
# =======================================================================
def test_truncated_frame_rejected(streams):
    def run(p):
        dec = p.frames.StreamDecoder()
        with pytest.raises(p.frames.TornStreamError) as ei:
            dec.feed(_frames(streams, p)[0][2][:-5])
        assert dec.needs_keyframe
        return ei.value.reason

    assert both(run) == "unparseable"


def test_body_crc_corruption_rejected(streams):
    def run(p):
        dec = p.frames.StreamDecoder()
        blob = _frames(streams, p)[0][2]
        fr = msgpack.unpackb(blob, raw=False, strict_map_key=False)
        body = bytearray(fr["body"])
        body[len(body) // 2] ^= 0x5A
        with pytest.raises(p.frames.TornStreamError) as ei:
            dec.feed(_tamper(blob, body=bytes(body)))
        assert dec.needs_keyframe
        return ei.value.reason, dec.last_reject

    assert both(run) == ("body_crc", "body_crc")


def test_reordered_delta_rejected_as_seq_gap(streams):
    def run(p):
        frames = _frames(streams, p)
        dec = p.frames.StreamDecoder()
        dec.feed(frames[0][2])
        with pytest.raises(p.frames.TornStreamError) as ei:
            dec.feed(frames[2][2])
        return ei.value.reason, str(ei.value)

    assert both(run)[0] == "seq_gap"


def test_chain_break_on_wrong_prev_crc(streams):
    def run(p):
        frames = _frames(streams, p)
        dec = p.frames.StreamDecoder()
        dec.feed(frames[0][2])
        fr = msgpack.unpackb(frames[1][2], raw=False,
                             strict_map_key=False)
        with pytest.raises(p.frames.TornStreamError) as ei:
            dec.feed(_tamper(frames[1][2], prev_crc=fr["prev_crc"] ^ 1))
        return ei.value.reason, str(ei.value)

    assert both(run)[0] == "chain_break"


def test_replayed_old_keyframe_rejected_stale(streams):
    def run(p):
        frames = _frames(streams, p)
        dec = p.frames.StreamDecoder()
        for _k, _t, blob in frames[:6]:
            dec.feed(blob)
        reasons = []
        for old in (frames[0], frames[4]):
            with pytest.raises(p.frames.TornStreamError) as ei:
                dec.feed(old[2])
            reasons.append(ei.value.reason)
        return reasons

    assert both(run) == ["stale_keyframe", "stale_keyframe"]


def test_torn_stream_heals_at_next_keyframe(streams):
    def run(p):
        frames = _frames(streams, p)
        dec = p.frames.StreamDecoder()
        dec.feed(frames[0][2])
        dec.feed(frames[1][2])
        with pytest.raises(p.frames.TornStreamError):
            dec.feed(frames[2][2][:-9])
        with pytest.raises(p.frames.TornStreamError) as ei:
            dec.feed(frames[3][2])
        reason = ei.value.reason
        kind, _tick, _data, _planes, _eids = dec.feed(frames[4][2])
        assert not dec.needs_keyframe
        dec.feed(frames[5][2])
        return reason, kind, dec.applied_seq

    assert both(run) == ("awaiting_keyframe", "key", 5)


# =======================================================================
# standby apply: live-world mirror, census equality, quiet destroy
# =======================================================================
def _census(world):
    out = {e.id for e in world.entities.values() if not e.destroyed}
    out.discard(world.nil_space.id)
    return out


def _host_view(w) -> dict:
    """A World's host side as plain values: every live entity's type,
    space, slot, position, yaw, staged pose, attrs and client binding,
    the staged pose rows and the ledger's census."""
    ents = {}
    for eid, e in sorted(w.entities.items()):
        if e.destroyed or e is w.nil_space:
            continue
        ents[eid] = (
            e.type_name, getattr(e.space, "id", None), e.shard, e.slot,
            tuple(map(float, e.position)), float(e.yaw),
            None if e._pending_pos is None
            else tuple(map(float, e._pending_pos)),
            None if e._pending_yaw is None else float(e._pending_yaw),
            e.attrs.to_dict(),
            None if e.client is None
            else (e.client.gate_id, e.client.client_id),
            sorted(e.interested_in))
    led = w.audit.ledger.snapshot(tick=w.tick_count, eids=True) \
        if w.audit is not None else None
    if led is not None:
        led.pop("tick", None)
    return {"entities": ents, "staged": sorted(w._staged_pos),
            "moving": [tuple(m) for m in w._staged_moving],
            "spaces": sorted(w.spaces), "ledger": led}


def _same(a, b) -> bool:
    """Equality of nested plain values, floats bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def _jax_state(w) -> dict:
    out = {}
    for f in dataclasses.fields(w.state):
        v = getattr(w.state, f.name)
        if dataclasses.is_dataclass(v):  # the Verlet cache
            out[f.name] = {c.name: np.asarray(getattr(v, c.name))
                           for c in dataclasses.fields(v)}
        elif v is not None:
            out[f.name] = np.asarray(v)
    return out


def diff_device(jw, tw) -> list[str]:
    """State and output lanes of a JAX World and a port World."""
    bad = []
    jst, tst = _jax_state(jw), interop.state_to_numpy(tw.state)
    for name, a in tst.items():
        if not _same(jst[name], a):
            bad.append(f"state lane {name}")
    jo, to = jw.last_outputs, tw.last_outputs
    if (jo is None) != (to is None):
        return bad + ["outputs"]
    if to is not None:
        for f in dataclasses.fields(to):
            if not _same(np.asarray(getattr(jo, f.name)),
                         getattr(to, f.name)):
                bad.append(f"output lane {f.name}")
    return bad


def test_applier_mirrors_census_and_destroys(streams):
    def run(p):
        s = streams[p.name]
        w, ents, frames, chain, enc = s.w, s.ents, s.frames, s.chain, \
            s.enc
        sb = _mk_world(p, 942)
        tracker = p.standby.StandbyTracker(942, 941, tick_hz=60.0)
        ap = p.standby.StandbyApplier(sb, 941, tracker=tracker)
        for _k, _t, blob in frames:
            out = ap.apply(blob)
            assert out["ok"], out
        assert _census(sb) == _census(w)
        src = ents[0]
        mir = sb.entities[src.id]
        assert mir.attrs.get_int("hp") == src.attrs.get_int("hp")
        assert (mir.client.gate_id, mir.client.client_id) == \
            (1, "repl-c0")
        assert sb.client_messages == []
        victim = ents[3]
        w.destroy_entity(victim)
        w.tick()
        data, tick = p.freeze.SnapshotChain.complete_capture(
            chain.capture())
        kind, rec = chain.build(data)
        blob = enc.encode(tick, kind, rec)
        out = ap.apply(blob)
        assert out["ok"], out
        assert victim.id not in _census(sb)
        assert _census(sb) == _census(w)
        snap = tracker.snapshot()
        assert snap["frames"] == len(frames) + 1
        assert snap["rejects"] == {}
        sb.audit.drain()
        v = p.audit.conservation_verdict(
            [sb.audit.snapshot(tick=sb.tick_count)])
        assert v["ok"], v["problems"]
        p.audit.unregister("game942")
        return (sorted(_census(sb)), out, blob, snap["bytes"],
                _host_view(sb)["entities"])

    both(run)


def test_applier_reject_changes_nothing(streams):
    def run(p):
        sb = _mk_world(p, 943)
        tracker = p.standby.StandbyTracker(943, 941, tick_hz=60.0)
        ap = p.standby.StandbyApplier(sb, 941, tracker=tracker)
        out = ap.apply(_frames(streams, p)[0][2][:-3])
        assert len(sb.entities) == 0
        p.audit.unregister("game943")
        return out, tracker.snapshot()["rejects"]

    assert both(run) == ({"ok": False, "reason": "unparseable",
                          "needs_keyframe": True}, {"unparseable": 1})


@pytest.mark.parametrize("src", ["jax", "port"])
def test_cross_applied_world_equals_the_jax_applied_one(streams, src):
    """One package's stream applied by both packages' appliers: after
    every frame the two standby Worlds agree on every entity (type,
    space, slot, pose and staged pose, attrs, client binding), the
    staged rows and the ledger; then both promote (one tick) and agree
    on every state and output lane too, and again a tick later."""
    frames = streams[src].frames
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    try:
        sides = []
        for p in PKGS:
            sb = _mk_world(p, 944)
            # the standby's warm tick on the empty world, as the game
            # server and the soak run it
            sb.tick()
            sb.tick_count = 0
            sides.append((sb, p.standby.StandbyApplier(sb, 941)))
        for i, (_k, _t, blob) in enumerate(frames):
            outs = [ap.apply(blob) for _w, ap in sides]
            assert outs[0] == outs[1] and outs[0]["ok"], outs
            views = [_host_view(w) for w, _ in sides]
            assert _same(views[0], views[1]), f"after frame {i}"
        (jw, _), (tw, _) = sides
        for w, ap in sides:
            w.tick_count = max(w.tick_count, ap.decoder.applied_tick)
        for t in range(2):
            jw.tick()
            tw.tick()
            assert diff_device(jw, tw) == [], f"promoted tick {t}"
            assert _same(_host_view(jw), _host_view(tw))
    finally:
        mp.undo()
        for p in PKGS:
            p.audit.unregister("game944")


# =======================================================================
# the bounded worker: slow disk NEVER blocks the tick thread
# =======================================================================
class StubChain:
    """Chain stand-in: records every build's force_key flag; disk
    writes can be made arbitrarily slow; builds can be made to fail."""

    def __init__(self, write_delay: float = 0.0, fail_builds: int = 0):
        self.write_delay = write_delay
        self.fail_builds = fail_builds
        self.force_flags: list[bool] = []
        self.writes = 0
        self._built = 0
        self._lock = threading.Lock()

    def complete_capture(self, captured):
        return {"n": int(captured)}, int(captured)

    def build(self, data, force_key: bool = False):
        with self._lock:
            if self.fail_builds > 0:
                self.fail_builds -= 1
                raise RuntimeError("deliberate build failure")
            self.force_flags.append(bool(force_key))
            self._built += 1
            kind = "key" if force_key or self._built == 1 else "delta"
        return kind, {"tick": data["n"]}

    def write_record(self, kind, rec):
        if self.write_delay:
            time.sleep(self.write_delay)
        with self._lock:
            self.writes += 1
        return "unused"


def test_slow_disk_never_blocks_submit():
    """Both workers: a slow disk costs drops (loud counter + keyframe
    collapse), never a stalled submit, and the frames each sends for
    the same accepted captures are the same bytes."""
    def run(p):
        chain = StubChain(write_delay=0.25)
        sent = []
        worker = p.worker.ReplicationWorker(
            chain, game_id=51, queue_max=2,
            send_fn=lambda blob, kind, tick: sent.append((kind, tick)))
        try:
            worst = 0.0
            accepted = 0
            builds_at_first_drop = None
            for i in range(10):
                t0 = time.perf_counter()
                if worker.submit(i, to_disk=True, to_stream=True):
                    accepted += 1
                elif builds_at_first_drop is None:
                    builds_at_first_drop = len(chain.force_flags)
                worst = max(worst, time.perf_counter() - t0)
            assert worst < 0.05, f"submit blocked {worst * 1e3:.1f} ms"
            assert worker.dropped_total() > 0
            assert accepted + worker.dropped_total() == 10
            assert worker.drain(timeout=30.0)
            assert chain.writes == accepted
            assert len(sent) == accepted
            chain.write_delay = 0.0
            assert worker.submit(99)
            assert worker.drain(timeout=10.0)
            assert any(chain.force_flags[builds_at_first_drop:]), \
                (builds_at_first_drop, chain.force_flags)
            return worker.stats()["frames_sent"] == len(sent)
        finally:
            worker.close()

    assert both(run)


def test_request_keyframe_forces_next_build():
    def run(p):
        chain = StubChain()
        frames = []
        worker = p.worker.ReplicationWorker(
            chain, game_id=52, queue_max=4,
            send_fn=lambda blob, kind, tick: frames.append(blob))
        try:
            worker.submit(1)
            assert worker.drain()
            worker.request_keyframe()
            worker.submit(2)
            assert worker.drain()
            return chain.force_flags, frames
        finally:
            worker.close()

    assert both(run)[0] == [False, True]


def test_worker_survives_build_failure():
    def run(p):
        chain = StubChain(fail_builds=1)
        worker = p.worker.ReplicationWorker(chain, game_id=53,
                                            queue_max=4,
                                            send_fn=lambda *a: None)
        try:
            worker.submit(1)
            worker.submit(2)
            assert worker.drain()
            return (worker.errors, chain.force_flags,
                    worker.stats()["frames_sent"])
        finally:
            worker.close()

    assert both(run) == (1, [True], 1)


def test_worker_rejects_zero_queue():
    def run(p):
        with pytest.raises(ValueError) as ei:
            p.worker.ReplicationWorker(StubChain(), game_id=54,
                                       queue_max=0)
        return str(ei.value)

    both(run)


# =======================================================================
# promotion arbitration: both stale-claim race orders refused
# =======================================================================
def _kvreg():
    """The dispatcher's exact first-writer-wins register semantics over
    a local dict."""
    reg: dict = {}

    def register(key, val, force=False):
        if key not in reg or force:
            reg[key] = val
        return reg[key]

    return reg, register


def test_claim_value_roundtrip():
    def run(p):
        m = p.promote
        v = m.claim_value(4, 3, 77)
        return (v, m.parse_claim(v), m.parse_claim("garbage"),
                m.parse_claim("gameX:eY:sZ"), m.claim_key(9))

    assert both(run)[1:] == ({"gid": 4, "epoch": 3, "seq": 77}, None,
                             None, "promote/game9")


def test_stale_claim_second_is_refused():
    def run(p):
        m = p.promote
        reg, register = _kvreg()
        key = m.claim_key(1)
        live = m.claim_value(2, epoch=3, frame_seq=90)
        stale = m.claim_value(9, epoch=1, frame_seq=10)
        return (m.adjudicate(register(key, live), live),
                m.adjudicate(register(key, stale), stale),
                reg[key] == live)

    assert both(run) == ("won", "lost", True)


def test_stale_claim_first_is_refused():
    def run(p):
        m = p.promote
        reg, register = _kvreg()
        key = m.claim_key(1)
        stale = m.claim_value(9, epoch=1, frame_seq=10)
        live = m.claim_value(2, epoch=3, frame_seq=90)
        register(key, stale)
        return (m.adjudicate(register(key, live), live),
                m.adjudicate(register(key, live, force=True), live),
                m.adjudicate(reg[key], stale))

    assert both(run) == ("stale_winner", "won", "lost")


def test_equal_epoch_loser_stands_down():
    def run(p):
        m = p.promote
        _reg, register = _kvreg()
        key = m.claim_key(1)
        a = m.claim_value(2, epoch=3, frame_seq=90)
        b = m.claim_value(5, epoch=3, frame_seq=88)
        return (m.adjudicate(register(key, a), a),
                m.adjudicate(register(key, b), b))

    assert both(run) == ("won", "lost")


def test_decision_log_replays_byte_for_byte():
    """Each package's log replays through its own and the other's
    ``replay_decisions`` to the same bytes."""
    def run(p):
        log = p.promote.DecisionLog()
        log.note("claim", key="promote/game1", value="game2:e1:s9",
                 epoch=1, applied_seq=9, applied_tick=40)
        log.note("adjudicate", winner="game2:e1:s9", mine="game2:e1:s9",
                 verdict="won")
        log.note("promoted", epoch=1, tick=40, seq=9, entities=12)
        dump = log.dump()
        for q in PKGS:
            assert q.promote.replay_decisions(log.inputs) == dump
        assert dump.endswith(b"\n")
        other = p.promote.DecisionLog()
        other.note("claim", applied_tick=40, applied_seq=9, epoch=1,
                   value="game2:e1:s9", key="promote/game1")
        assert other.lines[0] == log.lines[0]
        return dump

    both(run)


# =======================================================================
# /standby registry
# =======================================================================
def test_standby_registry_and_promotion_hook():
    def run(p):
        m = p.standby
        clock = [100.0]
        tr = m.StandbyTracker(6, 5, tick_hz=10.0, lag_budget_ticks=4,
                              clock=lambda: clock[0])
        m.register("game6", tr)
        tr.note_applied("key", tick=7, seq=0, nbytes=900, apply_ms=1.5)
        clock[0] += 0.2
        snap = m.snapshot_all()["game6"]
        clock[0] += 1.0
        late = m.snapshot_all()["game6"]["pass"]
        calls = []
        tr.on_promote = lambda epoch=None: calls.append(epoch) or \
            {"status": "claiming"}
        out = m.request_promotion(epoch=9)
        m.unregister("game6")
        return (snap, late, out, calls, m.snapshot_all(),
                m.request_promotion())

    snap, late, out, calls, empty, no_hook = both(run)
    assert (snap["role"], snap["applied_tick"], snap["lag_ticks"],
            snap["pass"]) == ("standby", 7, 2.0, True)
    assert late is False
    assert out == {"standby": "game6", "status": "claiming"}
    assert calls == [9]
    assert "error" in empty and "error" in no_hook


# =======================================================================
# the in-process failover soak on both packages
# =======================================================================
def _load_jax_soak():
    spec = importlib.util.spec_from_file_location(
        "chaos_soak_under_test",
        os.path.join(REPO, "tools", "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the report's keys read off clocks (times, the A/B ratio and its
# verdict, the tracker's ages) and the port's own extra measurements
_TIMED = {"promotion_secs", "cold_restore_secs", "warm_vs_cold_speedup",
          "ab_ok", "standby_apply_ms_per_tick", "standby", "converged",
          "apply_ms_frames", "frame_lag_ms", "frame_kinds"}


@pytest.fixture(scope="module")
def failovers():
    from goworld_tpu_torch.tools import chaos_soak as tsoak

    jsoak = _load_jax_soak()
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    kept = {}
    try:
        for name, soak, kw in (("jax", jsoak, {}),
                               ("port", tsoak, {"device": "cpu"})):
            made = []
            real = soak._mirror_world
            mp.setattr(soak, "_mirror_world",
                       lambda *a, real=real, made=made, **k:
                       made.append(real(*a, **k)) or made[-1])
            rep = soak.run_failover(77, **kw)
            standby = next(w for w in made if w.game_id == 2)
            kept[name] = (rep, standby)
        yield kept
    finally:
        mp.undo()


def test_failover_soak_reports_equal(failovers):
    """``run_failover`` (n 96, 40 ticks at keyframe cadence 8, the kill
    at the last tick): the same report on both packages — stream,
    arbitration, decision log, census, conservation, the worker's
    frame counts — but for what a clock reads. ``converged`` is the
    JAX soak's verdict on both, its A/B (warm promotion >= 10x a cold
    restore) included; the port's ratio misses it (ROADMAP.md Queue
    C15), so every other verdict is held here one by one."""
    (jrep, _), (trep, _) = failovers["jax"], failovers["port"]
    assert jrep.get("error") is None and trep.get("error") is None
    assert jrep["converged"], jrep
    verdicts = ("stream_ok", "promote_ok", "arbitration_ok",
                "decision_log_replay_ok", "census_ok", "conservation_ok",
                "cold_restore_ok")
    assert all(trep[k] is True for k in verdicts), trep
    assert trep["converged"] is trep["ab_ok"], trep
    shared = {k: v for k, v in jrep.items() if k not in _TIMED}
    port = {k: trep[k] for k in shared}
    assert port["worker"].pop("last_kind") == \
        shared["worker"].pop("last_kind")
    assert _same(port, shared)
    assert trep["entities_lost"] == trep["entities_duplicated"] == 0
    assert trep["frame_kinds"] == {"key": 5, "delta": 35}
    for k in ("frames", "bytes", "applied_seq", "applied_tick",
              "last_keyframe_tick", "rejects", "promoted_epoch"):
        assert jrep["standby"][k] == trep["standby"][k], k


def test_failover_promoted_worlds_tick_equal(failovers):
    """The promoted standbys of both soaks, ticked on: equal in every
    state and output lane and every entity, tick after tick."""
    (_, jw), (_, tw) = failovers["jax"], failovers["port"]
    assert _same(_host_view(jw)["entities"], _host_view(tw)["entities"])
    for t in range(3):
        jw.tick()
        tw.tick()
        assert diff_device(jw, tw) == [], f"tick {t}"
        assert _same(_host_view(jw)["entities"],
                     _host_view(tw)["entities"]), f"tick {t}"


# =======================================================================
# the standby's game server: no client message before promotion
# =======================================================================
def _game_pkgs(p):
    if p is J:
        from goworld_tpu.net import game, packet, proto
    else:
        from goworld_tpu_torch.net import game, packet, proto
    return game, packet, proto


def test_promoted_standby_flushes_no_mirror_client_message(tmp_path):
    """A standby ``GameServer`` mirrors a client-bound entity that the
    primary then destroys (a bot's boot Account handing its client to
    an Avatar does just that), and is promoted through the kvreg claim.
    The port's promoted game sends that client nothing from the
    mirroring: the primary served it. The JAX package's standby stages
    the mirror-side destroy and flushes it at its first promoted tick,
    a destroy of an entity the client already let go (ROADMAP.md Queue
    C10); its packet is read here to name the difference."""
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    got = {}
    try:
        for p in PKGS:
            game, packet, proto = _game_pkgs(p)
            prim = _mk_world(p, 951)
            prim.create_nil_space()
            sp = prim.create_space("Arena")
            acc = sp.create_entity("Mob", pos=(50.0, 0.0, 50.0))
            acc.set_client(p.ent.GameClient(1, "c-boot0000000000", prim))
            sp.create_entity("Mob", pos=(60.0, 0.0, 50.0))
            prim.tick()
            chain = p.freeze.SnapshotChain(prim, str(tmp_path / p.name),
                                           keyframe_every=4)
            os.makedirs(chain.directory, exist_ok=True)
            enc = p.frames.StreamEncoder()
            blobs = []
            for i in range(2):
                if i:
                    acc.client = None      # quiet unbind, then destroy
                    prim.destroy_entity(acc)
                    prim.tick()
                data, tick = p.freeze.SnapshotChain.complete_capture(
                    chain.capture())
                kind, rec = chain.build(data)
                blobs.append(enc.encode(tick, kind, rec))
            sb = _mk_world(p, 952)
            sb.create_nil_space()
            gs = game.GameServer(
                952, sb, [("127.0.0.1", 1)], standby_of=951,
                gc_freeze_on_boot=False, flightrec_ring=0,
                freeze_dir=str(tmp_path))
            sent = []
            gs.cluster.conns[0].send = (
                lambda pk, release=True: sent.append(
                    packet.wire_payload(pk)))
            for blob in blobs:
                pk = proto.pack_replication_frame(952, 951, blob)
                gs._handle_packet(0, proto.MT_REPLICATION_FRAME,
                                  packet.Packet(bytes(pk.buf[2:])))
                gs.tick()
            assert acc.id not in sb.entities or sb.entities[acc.id] \
                .destroyed
            assert gs._request_promotion(1)["status"] == "claiming"
            gs.tick()                       # stages the claim
            claim = gs._promote_claim
            pk = proto.pack_kvreg_register(
                p.promote.claim_key(951), claim, False)
            gs._handle_packet(0, proto.MT_KVREG_REGISTER,
                              packet.Packet(bytes(pk.buf[2:])))
            assert gs._promoted
            sent.clear()
            gs.tick()                       # the first promoted tick
            got[p.name] = [raw for raw in sent if packet.decode_wire(
                raw)[0] == proto.MT_CLIENT_EVENTS_BATCH]
            with open(os.path.join(str(tmp_path),
                                   "game952_promotion.log"), "rb") as f:
                assert f.read().startswith(b"claim ")
            p.audit.unregister("game951")
            p.audit.unregister("game952")
    finally:
        mp.undo()
    assert got["port"] == []
    assert len(got["jax"]) == 1     # the stale destroy of the mirror


def test_rejected_stale_copy_leaves_its_live_twin_alone(tmp_path):
    """ROADMAP.md Queue C16: a promoted standby re-handshakes with its
    census, and the dispatcher rejects the ids it routes to another game
    (an entity the primary handed off after the standby's last frame).
    The port's game drops its stale copy quietly: no destroy of the
    client's player (the live copy on the other game serves that
    client) and no destroy notice to the dispatcher (which would drop
    the live copy's route, so its client's next RPC goes nowhere). The
    JAX package's game sends both; its packets are read here to name
    the difference."""
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    got = {}
    try:
        for p in PKGS:
            game, packet, proto = _game_pkgs(p)
            w = _mk_world(p, 971)
            w.create_nil_space()
            sp = w.create_space("Arena")
            av = sp.create_entity("Mob", pos=(50.0, 0.0, 50.0))
            av.set_client(p.ent.GameClient(1, "c-moved000000000", w))
            watcher = sp.create_entity("Mob", pos=(60.0, 0.0, 50.0))
            w.tick()
            gs = game.GameServer(
                971, w, [("127.0.0.1", 1)], gc_freeze_on_boot=False,
                flightrec_ring=0, freeze_dir=str(tmp_path))
            sent = []
            gs.cluster.conns[0].send = (
                lambda pk, release=True: sent.append(
                    packet.wire_payload(pk)))
            gs.tick()
            sent.clear()
            ack = packet.new_packet(proto.MT_SET_GAME_ID_ACK)
            ack.append_u16(1)
            ack.append_data({})
            ack.append_data([av.id])
            ack.append_data([])
            gs._handle_packet(0, proto.MT_SET_GAME_ID_ACK,
                              packet.Packet(bytes(ack.buf[2:])))
            gs.tick()
            gs.tick()
            assert av.destroyed and av.id not in w.entities
            assert av.id not in watcher.interested_in
            got[p.name] = sorted({packet.decode_wire(raw)[0]
                                  for raw in sent} & {
                proto.MT_NOTIFY_DESTROY_ENTITY,
                proto.MT_CLIENT_EVENTS_BATCH})
            p.audit.unregister("game971")
    finally:
        mp.undo()
    assert got["port"] == []
    assert got["jax"] == sorted([proto.MT_NOTIFY_DESTROY_ENTITY,
                                 proto.MT_CLIENT_EVENTS_BATCH])


def test_standby_claims_after_its_dispatchers_drop_the_primary(tmp_path):
    """ROADMAP.md Queue C16: a dispatcher drops a dead primary's routes
    only when it reads that primary's connection to its end, which a
    backlog of the primary's frames can delay past the standby's claim;
    a census it takes before the drop is rejected whole, and the drop
    then leaves every id without a route. The port's standby stages its
    kvreg claim only once every dispatcher that listed the primary
    reported its disconnect (``MT_NOTIFY_GAME_DISCONNECTED``), and then
    sends its census at the promotion; the JAX package's claims while
    the dispatcher still holds the primary (its packets are read here to
    name the difference)."""
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    got = {}
    try:
        for p in PKGS:
            game, packet, proto = _game_pkgs(p)
            sb = _mk_world(p, 982)
            sb.create_nil_space()
            gs = game.GameServer(
                982, sb, [("127.0.0.1", 1)], standby_of=981,
                gc_freeze_on_boot=False, flightrec_ring=0,
                freeze_dir=str(tmp_path))
            sent = []
            gs.cluster.conns[0].send = (
                lambda pk, release=True: sent.append(
                    packet.decode_wire(packet.wire_payload(pk))[0]))

            def deliver(pk):
                gs._handle_packet(0, packet.decode_wire(
                    packet.wire_payload(pk))[0],
                    packet.Packet(bytes(pk.buf[2:])))

            ack = packet.new_packet(proto.MT_SET_GAME_ID_ACK)
            ack.append_u16(1)
            ack.append_data({})
            ack.append_data([])
            ack.append_data([981])          # the primary is online
            deliver(ack)
            gs.tick()
            assert gs._request_promotion(1)["status"] == "claiming"
            gs.tick()
            claimed_while_online = gs._promote_claim is not None
            gone = packet.new_packet(proto.MT_NOTIFY_GAME_DISCONNECTED)
            gone.append_u16(981)
            deliver(gone)
            gs.tick()                       # stages the claim
            assert gs._promote_claim is not None
            sent.clear()
            deliver(proto.pack_kvreg_register(
                p.promote.claim_key(981), gs._promote_claim, False))
            assert gs._promoted
            got[p.name] = (claimed_while_online,
                           sent.count(proto.MT_SET_GAME_ID))
            p.audit.unregister("game982")
    finally:
        mp.undo()
    assert got["port"] == (False, 1)
    assert got["jax"] == (True, 1)


@pytest.mark.parametrize("case", ["dispatcher_restart", "reack_without",
                                  "wait_bound"])
def test_standby_claims_when_a_dispatcher_leg_forgets_the_primary(
        tmp_path, case, monkeypatch):
    """ROADMAP.md Queue C16: the standby's wait for the dispatchers to
    drop the dead primary must end. ``dispatcher_restart``: the
    dispatcher that listed the primary dies with it and is respawned
    (the connection is lost, and the new dispatcher's ack lists no
    primary); ``reack_without``: a later ack of the same leg lists it no
    more; ``wait_bound``: no dispatcher ever reports the primary gone,
    and the standby claims once ``PROMOTE_LEG_WAIT_S`` has passed. In
    each case the claim is staged and the promotion completes."""
    from goworld_tpu_torch.net import game, packet, proto

    seeded_ids(monkeypatch)
    sb = _mk_world(T, 992)
    sb.create_nil_space()
    gs = game.GameServer(
        992, sb, [("127.0.0.1", 1)], standby_of=991,
        gc_freeze_on_boot=False, flightrec_ring=0,
        freeze_dir=str(tmp_path))
    gs.cluster.conns[0].send = lambda pk, release=True: None

    def ack(online):
        pk = packet.new_packet(proto.MT_SET_GAME_ID_ACK)
        pk.append_u16(1)
        pk.append_data({})
        pk.append_data([])
        pk.append_data(online)
        gs._handle_packet(0, proto.MT_SET_GAME_ID_ACK,
                          packet.Packet(bytes(pk.buf[2:])))

    ack([991])                      # the primary is online
    gs.tick()
    assert gs._request_promotion(1)["status"] == "claiming"
    if case == "wait_bound":
        monkeypatch.setattr(game.GameServer, "PROMOTE_LEG_WAIT_S", 0.05)
    gs.tick()
    assert gs._promote_claim is None    # the leg still holds game991
    if case == "dispatcher_restart":
        gs.cluster.conns[0].on_disconnect(0)    # as the net thread does
        ack([])                     # the respawned dispatcher's
    elif case == "reack_without":
        ack([])
    else:
        time.sleep(0.1)
    gs.tick()                       # stages the claim
    assert gs._promote_claim is not None, case
    gs._handle_packet(0, proto.MT_KVREG_REGISTER, packet.Packet(bytes(
        proto.pack_kvreg_register(tpromote.claim_key(991),
                                  gs._promote_claim, False).buf[2:])))
    assert gs._promoted
    taudit.unregister("game991")
    taudit.unregister("game992")


def test_disk_chain_resolves_after_a_stream_only_keyframe(tmp_path):
    """ROADMAP.md Queue C11: a standby's attach forces a keyframe that
    only the stream carries; the next checkpoint job writes a delta to
    disk. The port's worker builds that job as a keyframe, so the chain
    files resolve; the JAX package's worker writes a delta whose
    keyframe its files never held, and reading it raises
    ``CorruptSnapshotError`` (its packet is read here to name the
    difference)."""
    mp = pytest.MonkeyPatch()
    seeded_ids(mp)
    got = {}
    try:
        for p in PKGS:
            w = _mk_world(p, 961)
            w.create_nil_space()
            sp = w.create_space("Arena")
            ents = [sp.create_entity("Mob", pos=(20.0 + 9 * i, 0.0, 50.0))
                    for i in range(6)]
            d = tmp_path / p.name
            d.mkdir()
            chain = p.freeze.SnapshotChain(w, str(d), keyframe_every=8)
            sent = []
            worker = p.worker.ReplicationWorker(
                chain, game_id=961, queue_max=4,
                send_fn=lambda blob, kind, tick: sent.append(kind))
            try:
                kinds = []
                for step, (disk, stream, key) in enumerate((
                        (True, False, False),     # the first checkpoint
                        (False, True, True),      # a standby attaches
                        (True, True, False))):    # the next checkpoint
                    w.stage_pose(ents[step], (30.0 + step, 0.0, 60.0), 0.5)
                    w.tick()
                    if key:
                        worker.request_keyframe()
                    worker.submit(chain.capture(), to_disk=disk,
                                  to_stream=stream)
                    assert worker.drain()
                    kinds.append(worker.last_kind)
                try:
                    p.freeze.read_freeze_file(str(
                        d / p.freeze.chain_delta_filename(961)))
                    resolved = "delta"
                except FileNotFoundError:
                    resolved = "no delta file"
                except p.freeze.CorruptSnapshotError:
                    resolved = "corrupt"
                key = p.freeze.read_freeze_file(str(
                    d / p.freeze.chain_key_filename(961)))
                got[p.name] = (kinds, sent, resolved, len(key["entities"]))
            finally:
                worker.close()
                p.audit.unregister("game961")
    finally:
        mp.undo()
    assert got["jax"] == (["key", "key", "delta"], ["key", "delta"],
                          "corrupt", 6)
    assert got["port"] == (["key", "key", "key"], ["key", "key"],
                           "no delta file", 6)
