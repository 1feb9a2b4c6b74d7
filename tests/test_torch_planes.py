"""The port's World planes against the JAX package's, on the CPU: the
sync-age stamp and tracker, the residency tracker, the audit plane's
oracle and ledger, the devprof quantiles and the metrics histogram, each
fed the same inputs on both sides; and the port World's own residency
census, on ``data_ptr()``, with the carry resident."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from goworld_tpu.utils import audit as jaudit
from goworld_tpu.utils import devprof as jdevprof
from goworld_tpu.utils import metrics as jmetrics
from goworld_tpu.utils import residency as jres
from goworld_tpu.utils import syncage as jsync
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch.core.state import WorldConfig
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.utils import audit as taudit
from goworld_tpu_torch.utils import devprof as tdevprof
from goworld_tpu_torch.utils import metrics as tmetrics
from goworld_tpu_torch.utils import residency as tres
from goworld_tpu_torch.utils import syncage as tsync

_names = itertools.count()


def uniq(prefix: str) -> str:
    """A tracker name no other test used: the metrics registries are
    process-wide on both sides."""
    return f"{prefix}-{next(_names)}"


STAMPS = [(7, 1_000_000, 1_004_000, 1_004_500, 1_005_000, 1_007_000),
          (8, 1_016_000, 1_020_000, 1_019_000, 1_021_000, 0),
          (2**32 + 5, 5, 9, 9, 12, 40)]


@pytest.mark.parametrize("fields", STAMPS, ids=["hops", "warp", "wrap"])
def test_sync_age_stamp_packs_the_same_45_bytes(fields):
    a, b = jsync.SyncAgeStamp(*fields), tsync.SyncAgeStamp(*fields)
    assert tsync.STAMP_WIRE_SIZE == jsync.STAMP_WIRE_SIZE == 45
    assert a.pack() == b.pack() and len(b.pack()) == 45
    back = tsync.SyncAgeStamp.unpack(b.pack())
    assert back.pack() == b.pack()
    for t in (fields[1] + 30_000, fields[1] - 10):
        assert a.lanes_us(t) == b.lanes_us(t)
    with pytest.raises(ValueError):
        tsync.SyncAgeStamp.unpack(b.pack()[:-1])


def test_age_tracker_snapshot_matches_the_reference():
    name = uniq("planes-gate")
    ja, ta = jsync.AgeTracker(name=name), tsync.AgeTracker(name=name)
    rng = np.random.default_rng(4)
    for i in range(40):
        t0 = int(rng.integers(0, 10**6))
        st = [t0]
        for _ in range(4):
            st.append(st[-1] + int(rng.integers(-300, 9000)))
        fields = (i, *st)
        deliver = st[-1] + int(rng.integers(-100, 20000))
        n = int(rng.integers(0, 50))
        ja.observe(jsync.SyncAgeStamp(*fields), deliver, n)
        ta.observe(tsync.SyncAgeStamp(*fields), deliver, n)
        if i % 10 == 9:
            assert ja.window_verdict() == ta.window_verdict()
    assert ja.snapshot() == ta.snapshot()
    assert ja.last_lanes_ms == ta.last_lanes_ms
    counts = [0, 3, 5, 0, 9, 1]
    edges = [0.5, 1.0, 2.0, 4.0, 8.0]
    assert jsync.ptiles(edges, counts) == tsync.ptiles(edges, counts)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t

    def advance(self, ms: float) -> None:
        self.t += ms / 1e3


def test_residency_tracker_snapshot_matches_under_a_fake_clock(
        monkeypatch):
    clock = FakeClock()
    # both modules read the one time module's perf_counter
    monkeypatch.setattr(tres.time, "perf_counter", clock)
    assert jres.time is tres.time
    name = uniq("planes-world")
    jt = jres.ResidencyTracker(name, sample_every=4)
    tt = tres.ResidencyTracker(name, sample_every=4)
    rng = np.random.default_rng(8)
    steps = []
    for tick in range(24):
        steps.append(("tick_begin",))
        steps.append(("adv", float(rng.uniform(0.1, 3))))
        steps.append(("mark_dispatch",))
        steps.append(("adv", float(rng.uniform(0.0, 1))))
        steps.append(("mark_fetch",))
        steps.append(("adv", float(rng.uniform(0.5, 20))))
        steps.append(("mark_visible",))
        steps.append(("adv", float(rng.uniform(1, 200))))
        steps.append(("mark_decode_done",))
        steps.append(("observe_device_step", float(rng.uniform(0.001,
                                                               0.03))))
        steps.append(("add_host", float(rng.uniform(0, 0.004))))
        steps.append(("add_idle", float(rng.uniform(0, 0.008))))
        steps.append(("adv", float(rng.uniform(0, 15))))
    for step in steps:
        if step[0] == "adv":
            clock.advance(step[1])
            continue
        for t in (jt, tt):
            getattr(t, step[0])(*step[1:])
        if step[0] == "mark_decode_done":
            assert jt.window_verdict() == tt.window_verdict()
    js, ts = jt.snapshot(), tt.snapshot()
    for snap in (js, ts):
        snap.pop("gc")  # pauses of collections the runs happened to meet
    assert js == ts
    assert ts["ticks"] == 23 and "serve_gap" in ts
    tt.set_scan_marginal_ms(2.5)
    jt.set_scan_marginal_ms(2.5)
    assert jt.snapshot()["serve_gap"] == tt.snapshot()["serve_gap"]
    assert [jt.should_sample(i) for i in range(9)] == \
        [tt.should_sample(i) for i in range(9)]
    for t in (jt, tt):
        t.close()
    with pytest.raises(ValueError):
        tres.ResidencyTracker(uniq("bad"), sample_every=0)


def test_memory_stats_are_absent_on_the_cpu():
    t = tres.ResidencyTracker(uniq("planes-mem"))
    t.sample_memory(torch.device("cpu"), 0)
    assert t.snapshot()["alloc"] == {
        "unavailable": "memory_stats unavailable on this backend"}
    t.close()


def _oracle_world(rng, n: int):
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0, 200, n)
    pos[:, 2] = rng.uniform(0, 200, n)
    pos[:8, 0] = 50.0  # ties on the reach
    pos[:8, 2] = 50.0 + np.arange(8) * 2.5
    alive = rng.random(n) < 0.9
    wr = rng.choice(np.float32([0.0, 5.0, 12.5, np.inf]), n)
    return pos, alive, wr


@pytest.mark.parametrize("q16", [False, True], ids=["f32", "q16"])
def test_cohort_oracle_and_judgment_match_the_reference(q16):
    rng = np.random.default_rng(6 + q16)
    n = 512
    pos, alive, wr = _oracle_world(rng, n)
    if q16:
        step, hi = GridSpec(radius=10.0, extent_x=200.0, extent_z=200.0,
                            precision="q16").quant_step, (1 << 15) - 1
        jq, tq = jaudit.quantize_host(pos, step, hi), \
            taudit.quantize_host(pos, step, hi)
        assert jq.tobytes() == tq.tobytes()
        assert not np.array_equal(tq, pos)
        pos = tq
    cohort = sorted(rng.choice(n, 64, replace=False).tolist()) + [0, 3]
    for r in (10.0, 12.5):
        for watch in (None, wr):
            assert jaudit.cohort_oracle(pos, alive, r, cohort, watch) == \
                taudit.cohort_oracle(pos, alive, r, cohort, watch)
    # a judgment with some interest sets wrong on purpose
    rows = taudit.cohort_oracle(pos, alive, 10.0, cohort, wr)
    owner = {i: f"e{i:05d}" for i in range(n)}
    interest = {owner[i]: {owner[j] for j in rows[i]} for i in cohort}
    for i in cohort[:5]:
        interest[owner[i]].add(owner[(i + 1) % n])
    planes = []
    for mod in (jaudit, taudit):
        ap = mod.AuditPlane(uniq("planes-audit"), sample_every=2, cohort=8)
        ap.submit(lambda ap=ap: ap.judge_sample(
            tick=4, pos=pos, alive=alive, watch_radius=wr, radius=10.0,
            cohort_slots=cohort, owner=owner, interest=interest))
        ap.drain()
        ap.skip_sample("overflow", 6)
        ap.note_probe(8, 1)
        planes.append(ap)
    ja, ta = planes
    assert ja.oracle_stats == ta.oracle_stats
    assert ta.oracle_stats["mismatches"] > 0
    assert ja.snapshot(tick=9) == ta.snapshot(tick=9)
    slots = list(range(0, 40, 3))
    assert [ja.next_cohort(slots) for _ in range(4)] == \
        [ta.next_cohort(slots) for _ in range(4)]
    # the SnapshotChain scrub was refused until freeze was ported: both
    # planes now walk a directory without chain files alike
    for ap in planes:
        ap.scrub_snapshots(".", 1, 0)
    assert ja.scrub_stats == ta.scrub_stats == {
        "walks": 1, "files": 0, "corrupt": 0, "last_error": None}
    for ap in planes:
        ap.close()


def test_entity_ledger_event_script_matches_the_reference():
    ledgers = [jaudit.EntityLedger(uniq("planes-ledger"), grace_ticks=3),
               taudit.EntityLedger(uniq("planes-ledger"), grace_ticks=3)]
    script = [
        ("on_create", "a", "Mob", 0), ("on_create", "b", "Mob", 0),
        ("on_create", "c", "Player", 1), ("on_create", "a", "Mob", 1),
        ("on_destroy", "b", 2), ("on_destroy", "zz", 2),
        ("next_seq", "c"), ("stamp_migrate_out", "c", 3, 2),
        ("on_migrate_in", "c", "Player", 2, 4),
        ("stamp_migrate_out", "a", 5, 9),
        ("on_migrate_in", "q", "Mob", 7, 6),
        ("on_migrate_in", "q", "Mob", 7, 6),
        ("stamp_migrate_out", "ghost", 7),
        ("on_migrate_in", "a", "Mob", 1, 8),
        ("resync", {"a": "Mob", "r": "Mob"}, 9),
    ]
    got = [[], []]
    for step in script:
        for led, out in zip(ledgers, got):
            out.append(getattr(led, step[0])(*step[1:]))
    assert got[0] == got[1]
    ja, ta = ledgers
    assert ja.snapshot(tick=12, eids=True) == ta.snapshot(tick=12,
                                                          eids=True)
    assert ja.census() == ta.census()
    assert ja.incident_context() == ta.incident_context()
    assert ja.take_violation() == ta.take_violation()
    snaps = [ja.snapshot(tick=12), ta.snapshot(tick=4)]
    for games in (snaps, snaps[:1], []):
        assert jaudit.conservation_verdict(games) == \
            taudit.conservation_verdict(games)
    assert taudit.crc_fold(["b", "a"]) == jaudit.crc_fold(["a", "b"])
    assert taudit.first_divergent_eid(["a", "b"], ["b", "c"]) == \
        jaudit.first_divergent_eid(["a", "b"], ["b", "c"]) == "a"


def test_quantiles_slo_and_histograms_match_the_reference():
    rng = np.random.default_rng(2)
    edges = list(jmetrics.DEFAULT_MS_BUCKETS)
    assert tuple(edges) == tmetrics.DEFAULT_MS_BUCKETS
    for _ in range(20):
        counts = rng.integers(0, 5, len(edges) + 1).tolist()
        for q in (0.5, 0.9, 0.99):
            for fn in ("hist_quantile", "hist_quantile_interp"):
                a = getattr(jdevprof, fn)(edges, counts, q)
                b = getattr(tdevprof, fn)(edges, counts, q)
                assert a == b or (a != a and b != b)
        assert jdevprof.slo_from_histogram(edges, counts, 16.0) == \
            tdevprof.slo_from_histogram(edges, counts, 16.0)
    assert jdevprof.slo_from_histogram(edges, [0] * 16) == \
        tdevprof.slo_from_histogram(edges, [0] * 16)
    jh = jmetrics.Histogram((0.0, 1.0, 4.0))
    th = tmetrics.Histogram((0.0, 1.0, 4.0))
    for h in (jh, th):
        for v in (0.0, 0.5, 1.0, 9.0):
            h.observe(v)
        h.observe_n(2.0, 3)
        h.add_counts([1, 2, 3, 4], 7.5)
    assert jh.snapshot() == th.snapshot()
    with pytest.raises(ValueError):
        th.add_counts([1, 2])
    name = uniq("planes_hist")
    tmetrics.histogram(name, buckets=(1.0, 2.0), kind="x").observe(1.5)
    snap = tmetrics.REGISTRY.histogram_snapshot(name)
    assert snap == [({"kind": "x"}, {"buckets": [(1.0, 0), (2.0, 1)],
                                     "inf": 0, "sum": 1.5, "count": 1})]


CFG = WorldConfig(capacity=128, grid=GridSpec(
    radius=20.0, extent_x=160.0, extent_z=160.0, k=16, cell_cap=8,
    row_block=128, skin=4.0))


def _populated(**kw):
    w = tent.World(CFG, device="cpu", **kw)
    w.register_entity("Mob", tent.Entity)
    w.register_space("Arena", tent.Space)
    w.create_nil_space()
    arena = w.create_space("Arena", eid="arena.planes.tst")
    rng = np.random.default_rng(12)
    for i in range(90):
        arena.create_entity("Mob", pos=(float(rng.uniform(0, 160)), 0.0,
                                        float(rng.uniform(0, 160))),
                            eid=f"mob.planes.{i:05d}", moving=i % 3 > 0)
    return w


def test_world_defaults_run_the_planes_and_keep_the_carry_resident():
    w = _populated(residency_sample_every=2, audit_sample_every=3,
                   audit_cohort=16)
    assert (w.telemetry_live, w.resident) == (True, True)
    assert w.residency is not None and w.audit is not None
    assert w.audit.sample_every == 3 and w.audit.cohort == 16
    ptrs = {name: t.data_ptr() for name, t in tres._state_lanes(w.state)}
    for _ in range(7):
        w.tick()
    w.audit.drain()
    census = w.residency.census_snapshot()
    assert census["samples"] == 3 and census["realloc"] == []
    assert census["skipped_deleted"] == 0 and census["opaque"] == []
    assert len(census["aliased"]) == len(ptrs) and "aoi_cache.cand" in ptrs
    assert ptrs == {name: t.data_ptr()
                    for name, t in tres._state_lanes(w.state)}
    assert w.audit.oracle_stats["samples"] == 3
    assert w.audit.oracle_stats["mismatches"] == 0
    lanes = w._telem_lanes
    assert sum(lanes["rebuilt"]["counts"]) == 7
    assert lanes["occupancy"]["per_tile"] == [90]
    assert "skin_slack" in lanes
    assert w.workload_signature()["ticks"] == 7
    assert w.window_signature() is None
    assert w.sync_age_anchor[0] == 6
    snap = tdevprof.snapshot(analyze=True)
    assert "world.tick" in snap["providers"]
    # the provider's report was refused until cost_report was ported:
    # it now serves the step's report, without an error
    rep = snap["reports"]["world.tick"]
    assert "error" not in rep and rep["name"] == "world.tick"
    assert rep["key"] == w.cost_report().key


def test_resident_and_replaced_carries_give_the_same_bits():
    worlds = [_populated(resident=r, audit=False) for r in (True, False)]
    for _ in range(5):
        for w in worlds:
            w.tick()
        a, b = ([(name, t.numpy().tobytes())
                 for name, t in tres._state_lanes(w.state)]
                for w in worlds)
        assert a == b
        assert worlds[0]._telem_lanes == worlds[1]._telem_lanes
    assert worlds[0].residency.census_snapshot()["realloc"] == []


@pytest.mark.parametrize("knob", ["residency_sample_every",
                                  "audit_sample_every", "audit_cohort"])
def test_bad_sampling_knobs_fail_loudly(knob):
    with pytest.raises(ValueError, match=knob):
        tent.World(CFG, device="cpu", **{knob: 0})
