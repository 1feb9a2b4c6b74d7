"""The port's self-healing rebalance plane against the JAX package's, on
the CPU.

Each case of ``tests/test_rebalance.py`` runs here on both packages
(``goworld_tpu.rebalance`` and ``goworld_tpu_torch.rebalance``, the
port's Worlds on ``device="cpu"``, its cluster tools and soak from
``goworld_tpu_torch.tools``) and holds the port to the JAX package's
outcome: the policy's hold-run hysteresis, plan-window cancellation
and pair cooldown, the burst-aware conservation grace, the handoff
executor on real Worlds, the ``/rebalance`` endpoint, the
``rebalance_action`` trigger, the config knobs, the cluster scrapers'
lines and the in-process soak. Tolerance is exact: decision logs
compare as bytes, censuses and ledgers as values.

Across the packages: ``RebalancePolicy.replay`` gives each package's
log from the other's inputs; ``plan_cohort`` picks the same cohort; a
clean handoff and a timeout abort leave equal censuses and ledgers;
``run_rebalance`` (n 96, the soak's size; the JAX side from
``tools/chaos_soak.py``) gives equal reports and decision logs. Entity
ids are one seeded sequence on each side, so the packages mint the
same ids.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import goworld_tpu.rebalance as jrebalance
import goworld_tpu_torch.rebalance as trebalance
from goworld_tpu import config as jconfig
from goworld_tpu import entity as jent
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.entity import manager as jmanager
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.utils import audit as jaudit
from goworld_tpu.utils import debug_http as jdebug_http
from goworld_tpu.utils import flightrec as jflightrec
from goworld_tpu.utils import ids as jids
from goworld_tpu.utils import metrics as jmetrics
from goworld_tpu.utils import overload as joverload
from goworld_tpu_torch import config as tconfig
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.entity import manager as tmanager
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.tools import chaos_soak as tsoak
from goworld_tpu_torch.tools import obs_aggregate as tobs
from goworld_tpu_torch.tools import scrape_metrics as tscrape
from goworld_tpu_torch.utils import audit as taudit
from goworld_tpu_torch.utils import debug_http as tdebug_http
from goworld_tpu_torch.utils import flightrec as tflightrec
from goworld_tpu_torch.utils import ids as tids
from goworld_tpu_torch.utils import metrics as tmetrics
from goworld_tpu_torch.utils import overload as toverload

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = SimpleNamespace(name="jax", rb=jrebalance, ent=jent, mgr=jmanager,
                    audit=jaudit, http=jdebug_http, flightrec=jflightrec,
                    metrics=jmetrics, overload=joverload, config=jconfig,
                    ids=jids, Config=JConfig, Grid=JGrid, kw={},
                    obs=None, scrape=None, soak=None)
T = SimpleNamespace(name="port", rb=trebalance, ent=tent, mgr=tmanager,
                    audit=taudit, http=tdebug_http, flightrec=tflightrec,
                    metrics=tmetrics, overload=toverload, config=tconfig,
                    ids=tids, Config=TConfig, Grid=TGrid,
                    kw={"device": "cpu"}, obs=tobs, scrape=tscrape,
                    soak=tsoak)
PKGS = (J, T)

pytestmark = pytest.mark.rebalance


def _tools(p):
    """The package's cluster tools: the repo's ``tools/`` for the JAX
    package, ``goworld_tpu_torch.tools`` for the port."""
    if p.obs is None:
        p.obs = _load_tool("obs_aggregate")
        p.scrape = _load_tool("scrape_metrics")
        p.soak = _load_tool("chaos_soak")
    return p


@pytest.fixture(autouse=True)
def _fresh_registries():
    for p in PKGS:
        p.metrics.REGISTRY.reset()
        p.rb.reset()
    yield
    for p in PKGS:
        p.metrics.REGISTRY.reset()
        p.rb.reset()


@pytest.fixture
def seeded(monkeypatch):
    """``gen_entity_id`` on both packages: one seeded sequence each."""
    for mod in (jids, tids):
        seq = itertools.count()
        monkeypatch.setattr(
            mod, "gen_entity_id",
            lambda seq=seq, mod=mod: mod.gen_fixed_id(f"rb.{next(seq)}"))


def both(fn):
    """``fn`` on each package; the port's result must be the JAX
    package's."""
    got = [fn(p) for p in PKGS]
    assert got[0] == got[1], (got[0], got[1])
    return got[0]


def _obs(e1, e2, s1="NORMAL", s2="NORMAL", p1=True, p2=True):
    return {
        "game1": {"stage": s1, "entities": e1, "present": p1},
        "game2": {"stage": s2, "entities": e2, "present": p2},
    }


HOT = _obs(100, 10, s1="DEGRADED")
COLD = _obs(100, 10)


def _policy(p, **kw):
    return p.rb.RebalancePolicy(**kw)


# =======================================================================
# policy: hold-run hysteresis and the plan->commit window
# =======================================================================
def test_state_rank_orders_states_and_tolerates_unknown():
    got = both(lambda p: [p.overload.state_rank(s) for s in (
        "NORMAL", "DEGRADED", "SHEDDING", "REJECTING", "WAT")])
    assert got == [0, 1, 2, 3, 0]


def test_canonical_observation_sorts_and_defaults():
    canon = both(lambda p: p.rb.canonical_observation(
        {"game2": {"entities": "7"},
         "game1": {"stage": "DEGRADED", "entities": 3}}))
    assert list(canon) == ["game1", "game2"]
    assert canon["game2"] == {"stage": "NORMAL", "entities": 7,
                              "present": True}
    assert canon["game1"]["stage"] == "DEGRADED"


def test_policy_validates_knobs_loudly():
    def run(p):
        msgs = []
        for kw in (dict(hold_windows=0), dict(batch=0),
                   dict(cooldown_windows=0)):
            with pytest.raises(ValueError) as ei:
                p.rb.RebalancePolicy(**kw)
            msgs.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            p.rb.HandoffExecutor(object(), game_id=1, batch=0)
        return msgs + [str(ei.value)]

    both(run)


def test_one_noisy_window_resets_the_hold_run():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=4)
        outs = [pol.observe(o) for o in (HOT, HOT, COLD, HOT, HOT)]
        planned_before = pol.planned
        outs.append(pol.observe(HOT))
        return outs, planned_before, pol.planned, pol.committed, \
            pol.log.dump()

    outs, before, planned, committed, _ = both(run)
    assert outs == [None] * 6 and before == 0
    assert (planned, committed) == (1, 0)


def test_commit_fires_one_window_after_plan():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=4)
        for _ in range(3):
            assert pol.observe(HOT) is None
        return pol.observe(HOT), pol.committed, pol.log.dump()

    action, committed, _ = both(run)
    assert action == {"frm": "game1", "to": "game2", "batch": 8,
                      "reason": "sustained_DEGRADED", "window": 4}
    assert committed == 1


def test_donor_recovery_during_planning_cancels_the_move():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=4)
        for _ in range(3):
            pol.observe(HOT)
        cancel = pol.observe(COLD)
        counts = (pol.cancelled, pol.committed)
        for _ in range(3):
            pol.observe(HOT)
        return cancel, counts, pol.observe(HOT), pol.log.dump()

    cancel, counts, action, dump = both(run)
    assert cancel is None and counts == (1, 0) and action is not None
    assert b"cancel cause=donor_recovered" in dump


def test_target_losing_headroom_during_planning_cancels():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=4)
        for _ in range(3):
            pol.observe(HOT)
        return pol.observe(_obs(100, 95, s1="DEGRADED")), \
            pol.cancelled, pol.log.dump()

    action, cancelled, dump = both(run)
    assert action is None and cancelled == 1
    assert b"cancel cause=target_unfit" in dump


def test_target_vanishing_during_planning_cancels():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=4)
        for _ in range(3):
            pol.observe(HOT)
        return pol.observe(_obs(100, 10, s1="DEGRADED", p2=False)), \
            pol.cancelled, pol.log.dump()

    assert both(run)[:2] == (None, 1)


def test_no_target_without_strict_improvement():
    def run(p):
        pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=4)
        near = _obs(100, 96, s1="DEGRADED")
        for _ in range(3):
            pol.observe(near)
        return pol.planned, pol.log.dump()

    planned, dump = both(run)
    assert planned == 0 and b"\nno_target" in dump


def test_absent_game_is_never_hot_and_never_a_target():
    def run(p):
        pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=4)
        for _ in range(4):
            pol.observe(_obs(100, 10, s1="DEGRADED", p1=False))
        first = pol.planned
        for _ in range(4):
            pol.observe(_obs(100, 10, s1="DEGRADED", p2=False))
        return first, pol.planned, pol.log.dump()

    assert both(run)[:2] == (0, 0)


# =======================================================================
# policy: ping-pong suppression
# =======================================================================
def test_alternating_load_commits_at_most_one_move_per_cooldown():
    def run(p):
        pol = _policy(p, hold_windows=3, batch=8, cooldown_windows=8)
        commits = []
        for w in range(1, 33):
            if (w - 1) // 4 % 2 == 0:
                obs = _obs(100, 10, s1="DEGRADED")
            else:
                obs = _obs(10, 100, s2="DEGRADED")
            if pol.observe(obs) is not None:
                commits.append(w)
        return commits, pol.log.dump()

    commits, dump = both(run)
    assert commits
    for a, b in zip(commits, commits[1:]):
        assert b - a >= 8, commits
    assert b"\ncooldown" in dump


def test_cooldown_suppresses_the_reverse_move():
    def run(p):
        pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=10)
        for _ in range(2):
            pol.observe(HOT)
        first = pol.observe(HOT)
        rev = _obs(10, 100, s2="DEGRADED")
        later = [pol.observe(rev) for _ in range(5)]
        return first, later, pol.committed, pol.log.dump()

    first, later, committed, dump = both(run)
    assert first is not None and later == [None] * 5 and committed == 1
    assert b"cooldown frm=game2 to=game1" in dump


def test_abort_feedback_rearms_the_pair_cooldown():
    def run(p):
        pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=6)
        for _ in range(2):
            pol.observe(HOT)
        first = pol.observe(HOT)
        pol.feedback("abort", cause="timeout", frm="game1", to="game2",
                     restored=8)
        later = [pol.observe(HOT) for _ in range(5)]
        return first, later, pol.committed, pol.log.dump()

    first, later, committed, dump = both(run)
    assert first is not None and later == [None] * 5 and committed == 1
    assert b"cause=timeout" in dump


# =======================================================================
# policy: byte-identical replay, across the packages too
# =======================================================================
def _replay_seq(p):
    pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=5)
    for obs in [HOT, HOT, HOT, COLD, HOT, HOT,
                _obs(100, 95, s1="DEGRADED"), HOT, HOT, HOT]:
        pol.observe(obs)
    pol.feedback("abort", cause="timeout", frm="game1", to="game2",
                 restored=8)
    for obs in (HOT, COLD, HOT):
        pol.observe(obs)
    return pol


def test_decision_log_replays_byte_identical():
    """Each package's log replays byte for byte through its own
    ``RebalancePolicy.replay`` and through the other package's."""
    def run(p):
        pol = _replay_seq(p)
        for q in PKGS:
            assert pol.log.dump() == q.rb.RebalancePolicy.replay(
                pol.log.inputs, hold_windows=2, batch=8,
                cooldown_windows=5)
        return pol.log.dump(), pol.snapshot()

    both(run)


def test_replay_diverges_for_different_knobs():
    def run(p):
        pol = _policy(p, hold_windows=2, batch=8, cooldown_windows=5)
        for _ in range(4):
            pol.observe(HOT)
        other = p.rb.RebalancePolicy.replay(
            pol.log.inputs, hold_windows=4, batch=8, cooldown_windows=5)
        assert pol.log.dump() != other
        return other

    both(run)


# =======================================================================
# burst-aware conservation grace
# =======================================================================
def _ledger_snap(tick, in_flight, ins=(), live=0, created=0,
                 destroyed=0):
    return {"kind": "game", "entities": live, "created": created,
            "destroyed": destroyed, "tick": tick,
            "in_flight": list(in_flight), "in_records": list(ins),
            "violations_total": {}}


def _verdict(snaps):
    return both(lambda p: p.audit.conservation_verdict(snaps))


def test_rate_limited_batch_straddling_verdict_stays_green():
    recs = [{"eid": f"B{i:03d}", "seq": 2, "target": 2,
             "tick": 93 + i // 8, "age_ticks": 57} for i in range(64)]
    v = _verdict([_ledger_snap(100, recs, live=36, created=100)])
    assert v["ok"], v["problems"]
    assert v["in_flight"] == 64 and v["lost"] == []


def test_genuinely_old_record_in_a_fresh_batch_is_still_named():
    recs = [{"eid": f"B{i:03d}", "seq": 2, "target": 2, "tick": 99,
             "age_ticks": 0} for i in range(8)]
    recs.append({"eid": "LOST0", "seq": 3, "target": 2, "tick": 80,
                 "age_ticks": 0})
    v = _verdict([_ledger_snap(100, recs, live=91, created=100)])
    assert not v["ok"]
    assert any("LOST0" in pr for pr in v["problems"])
    assert all("B00" not in pr for pr in v["problems"])


def test_verdict_falls_back_to_precomputed_age_without_tick():
    rec = {"eid": "X1", "seq": 2, "target": 2, "age_ticks": 50}
    v = _verdict([_ledger_snap(100, [rec], live=99, created=100)])
    assert not v["ok"] and any("X1" in pr for pr in v["problems"])


def test_cross_game_out_matched_by_in_record_is_not_outstanding():
    out = _ledger_snap(
        100, [{"eid": "M1", "seq": 4, "target": 2, "tick": 50,
               "age_ticks": 50}], live=9, created=10)
    tgt = _ledger_snap(100, [], ins=[{"eid": "M1", "seq": 4,
                                      "tick": 52}], live=1, created=0)
    v = _verdict([out, tgt])
    assert v["ok"], v["problems"]
    assert v["in_flight"] == 0


# =======================================================================
# executor on real worlds, both packages
# =======================================================================
@pytest.fixture
def worlds(seeded):
    made = []

    def make(p, game_id, n=12, seed=31):
        class Mob(p.ent.Entity):
            ATTRS = {"hp": "allclients hot:0"}

        cfg = p.Config(
            capacity=64,
            grid=p.Grid(radius=30.0, extent_x=200.0, extent_z=200.0),
            input_cap=64,
        )
        w = p.ent.World(cfg, n_spaces=1, game_id=game_id, audit=True,
                        **p.kw)
        w.register_entity("Mob", Mob)
        w.register_space("Arena", p.ent.Space)
        w.create_nil_space()
        sp = w.create_space("Arena")
        rng = np.random.default_rng(seed)
        ents = []
        for _ in range(n):
            x, z = rng.uniform(20.0, 180.0, 2)
            ents.append(sp.create_entity(
                "Mob", pos=(float(x), 0.0, float(z))))
        made.append((p, w))
        return w, sp, ents

    yield make
    for p, w in made:
        p.audit.unregister(f"game{w.game_id}")
        if w.audit is not None:
            w.audit.close()


def _census(w):
    out = {e.id for e in w.entities.values() if not e.destroyed}
    if w.nil_space is not None:
        out.discard(w.nil_space.id)
    return out


def _ledger(w):
    w.audit.drain()
    snap = w.audit.ledger.snapshot(tick=w.tick_count, eids=True)
    return snap


def _pair_verdict(p, a, b):
    for w in (a, b):
        w.audit.drain()
    return p.audit.conservation_verdict([
        a.audit.snapshot(tick=a.tick_count),
        b.audit.snapshot(tick=b.tick_count)])


def test_plan_cohort_is_sorted_space_affine_and_capped(worlds):
    def run(p):
        donor, dsp, ents = worlds(p, 941)
        agent = p.rb.HandoffExecutor(donor, game_id=941, batch=4)
        sid, eids = agent.plan_cohort()
        assert sid == dsp.id
        assert eids == sorted(e.id for e in ents)[:4]
        _, all_eids = agent.plan_cohort(batch=64)
        assert all_eids == sorted(e.id for e in ents)
        return sid, eids, all_eids

    both(run)


def test_clean_handoff_partitions_census_and_counts_moves(worlds):
    """The clean handoff on both packages: equal censuses, ledgers and
    move counters on both sides, mid-batch and after."""
    def run(p):
        donor, dsp, _ents = worlds(p, 941)
        recv, rsp, _ = worlds(p, 942, n=0)
        agent = p.rb.HandoffExecutor(donor, game_id=941, batch=6)
        acked = []

        def send(eid, data):
            recv.restore_from_migration(data, space=rsp)
            agent.ack(eid)
            acked.append(eid)

        original = _census(donor)
        rbase = _census(recv)
        n = agent.start(942, "sustained_DEGRADED", send, batch=6,
                        rate=3)
        assert n == 6 and agent.busy
        assert not donor.admission_allowed(dsp.id)
        assert agent.pump() == 3 and agent.busy
        mid = _pair_verdict(p, donor, recv)
        assert mid["ok"], mid["problems"]
        assert agent.pump() == 3
        assert not agent.busy and agent.completed == 1
        moved = _census(recv) - rbase
        assert len(moved) == 6 == len(acked)
        assert (_census(donor) | moved) == original
        assert not (_census(donor) & moved)
        assert donor.admission_allowed(dsp.id)
        res = agent.take_result()
        assert res == {"kind": "done", "cause": "", "target": 942,
                       "restored": 0, "moved": 6}
        assert agent.take_result() is None
        assert agent.snapshot()["moves_total"] == {
            "game941->game942:sustained_DEGRADED": 6}
        end = _pair_verdict(p, donor, recv)
        assert end["ok"], end["problems"]
        return (sorted(_census(donor)), sorted(moved), acked, mid, end,
                _ledger(donor), _ledger(recv), agent.snapshot(),
                agent.take_action_note())

    both(run)


def test_timeout_abort_restores_every_unacked_entity(worlds):
    """The target-kill abort on both packages: equal censuses, ledgers,
    verdicts and action notes."""
    def run(p):
        donor, _dsp, _ = worlds(p, 943)
        agent = p.rb.HandoffExecutor(donor, game_id=943, batch=6)
        limbo = []
        original = _census(donor)
        n = agent.start(9, "sustained_SHEDDING",
                        send=lambda eid, data: limbo.append(eid),
                        batch=6, rate=6, timeout_windows=2)
        assert n == 6 and agent.pump() == 6
        assert len(_census(donor)) == len(original) - 6
        donor.audit.drain()
        v1 = p.audit.conservation_verdict(
            [donor.audit.snapshot(tick=donor.tick_count)])
        assert v1["ok"], v1["problems"]
        for _ in range(3):
            agent.pump()
        assert not agent.busy and agent.aborted == 1
        assert agent.aborts_total == {"timeout": 1}
        assert _census(donor) == original
        donor.audit.drain()
        v2 = p.audit.conservation_verdict(
            [donor.audit.snapshot(tick=donor.tick_count)])
        assert v2["ok"], v2["problems"]
        res = agent.take_result()
        assert res["kind"] == "abort" and res["cause"] == "timeout"
        assert res["restored"] == 6 and res["moved"] == 0
        note = agent.take_action_note()
        assert note is not None and "abort" in note
        return (limbo, v1, v2, res, note, sorted(_census(donor)),
                _ledger(donor))

    both(run)


def test_admission_pause_blocks_creates_until_abort(worlds):
    def run(p):
        donor, dsp, _ = worlds(p, 944)
        agent = p.rb.HandoffExecutor(donor, game_id=944, batch=4)
        agent.start(9, "manual", send=lambda *a: None, batch=4, rate=2)
        with pytest.raises(p.mgr.AdmissionPausedError) as ei:
            dsp.create_entity("Mob", pos=(50.0, 0.0, 50.0))
        agent.abort("operator")
        e = dsp.create_entity("Mob", pos=(50.0, 0.0, 50.0))
        assert e.id in _census(donor)
        return str(ei.value), agent.aborts_total, e.id

    assert both(run)[1] == {"operator": 1}


def test_start_refuses_to_interleave_handoffs(worlds):
    def run(p):
        donor, _dsp, _ = worlds(p, 945)
        agent = p.rb.HandoffExecutor(donor, game_id=945, batch=4)
        agent.start(9, "manual", send=lambda *a: None, batch=4)
        with pytest.raises(RuntimeError) as ei:
            agent.start(8, "manual", send=lambda *a: None, batch=4)
        agent.abort("operator")
        return str(ei.value)

    both(run)


# =======================================================================
# live two-world controller drive
# =======================================================================
def test_live_controller_hands_off_once_and_donor_recovers(worlds):
    def run(p):
        donor, _dsp, _ = worlds(p, 947, n=12)
        recv, rsp, _ = worlds(p, 948, n=0)
        policy = p.rb.RebalancePolicy(hold_windows=2, batch=4,
                                      cooldown_windows=6)
        agent = p.rb.HandoffExecutor(donor, game_id=947, batch=4)
        mailbox = []
        ctl = p.rb.RebalanceController(
            policy, agents={"game947": agent},
            transport=lambda action: (
                lambda eid, data: mailbox.append((eid, data))),
            rate=2)
        original = _census(donor)
        rbase = _census(recv)
        hot = len(original) - 2
        commits, stages = [], []
        for w_i in range(1, 15):
            arriving, mailbox[:] = mailbox[:], []
            for eid, data in arriving:
                recv.restore_from_migration(data, space=rsp)
                agent.ack(eid)
            d_stage = ("DEGRADED" if len(_census(donor)) >= hot
                       else "NORMAL")
            stages.append(d_stage)
            obs = {
                "game947": {"stage": d_stage,
                            "entities": len(_census(donor)),
                            "present": True},
                "game948": {"stage": "NORMAL",
                            "entities": len(_census(recv) - rbase),
                            "present": True},
            }
            if ctl.step(obs) is not None:
                commits.append(w_i)
        assert commits == [3]
        moved = _census(recv) - rbase
        assert len(moved) == 4
        assert (_census(donor) | moved) == original
        assert not (_census(donor) & moved)
        assert "NORMAL" in stages[3:]
        assert agent.completed == 1 and agent.aborted == 0
        assert policy.log.dump() == p.rb.RebalancePolicy.replay(
            policy.log.inputs, hold_windows=2, batch=4,
            cooldown_windows=6)
        v = _pair_verdict(p, donor, recv)
        assert v["ok"], v["problems"]
        return commits, stages, sorted(moved), policy.log.dump(), \
            ctl.snapshot()["actions"]

    both(run)


# =======================================================================
# scraped observations, /rebalance endpoint, flightrec trigger
# =======================================================================
def test_scraped_observation_takes_worst_governor_state():
    def run(p):
        row = p.rb.scraped_observation(
            "game3",
            {"governors": {"aoi": {"state": "NORMAL"},
                           "tick": {"state": "SHEDDING"}}},
            {"entities": 42})
        gone = p.rb.scraped_observation("game4", None, None,
                                        present=False)
        return row, gone

    row, gone = both(run)
    assert row == {"name": "game3", "stage": "SHEDDING",
                   "entities": 42, "present": True}
    assert gone == {"name": "game4", "stage": "NORMAL", "entities": 0,
                    "present": False}


def test_rebalance_endpoint_serves_snapshot_and_handoff_action(worlds):
    def run(p):
        donor, _dsp, _ = worlds(p, 946)
        p.rb.register("game946",
                      p.rb.HandoffExecutor(donor, game_id=946, batch=4))
        calls = []
        p.rb.set_handoff_hook(
            lambda target, batch: (calls.append((target, batch))
                                   or {"status": "queued",
                                       "target": target}))
        srv = p.http.start(0, process_name="game946")
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(base + "/rebalance",
                                        timeout=5) as r:
                payload = json.loads(r.read())
            with urllib.request.urlopen(
                    base + "/rebalance?handoff=2&batch=8",
                    timeout=5) as r:
                poked = json.loads(r.read())
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/rebalance?handoff=nope",
                                       timeout=5)
            return payload, poked, calls, ei.value.code
        finally:
            srv.shutdown()

    payload, poked, calls, code = both(run)
    assert payload["agents"]["game946"]["busy"] is False
    assert payload["agents"]["game946"]["handoffs"] == 0
    assert poked == {"status": "queued", "target": 2}
    assert calls == [(2, 8)] and code == 400


def test_request_handoff_without_hook_is_an_honest_error():
    assert "error" in both(lambda p: p.rb.request_handoff(2, 8))


def test_rebalance_action_trigger_freezes_the_frame():
    def run(p):
        rec = p.flightrec.FlightRecorder(ring=8)
        assert rec.record({"tick": 1}) == []
        incidents = rec.record(
            {"tick": 2,
             "rebalance": "start to=game2 batch=4 space=S reason=manual"})
        return [(i["trigger"], i["detail"]) for i in incidents]

    got = both(run)
    assert [t for t, _ in got] == ["rebalance_action"]
    assert "start to=game2" in got[0][1]


# =======================================================================
# config knobs
# =======================================================================
def test_config_rebalance_knobs_default_off_and_parse(tmp_path):
    path = tmp_path / "goworld_tpu.ini"
    path.write_text("[deployment]\nrebalance = true\n"
                    "rebalance_hold_windows = 5\nrebalance_batch = 32\n"
                    "rebalance_cooldown_secs = 12.5\n")

    def run(p):
        d = p.config.ClusterConfig()
        c = p.config.load(str(path))
        keys = ("rebalance", "rebalance_hold_windows", "rebalance_batch",
                "rebalance_cooldown_secs")
        return [getattr(d, k) for k in keys], [getattr(c, k) for k in keys]

    assert both(run) == ([False, 3, 64, 30.0], [True, 5, 32, 12.5])


# =======================================================================
# cluster scrapers: obs_aggregate + scrape_metrics rebalance lines
# =======================================================================
_AGENT_SNAP = {
    "game": "game3", "busy": True,
    "job": {"target": "game5", "space_id": "sp1", "queued": 4,
            "unacked": 6, "sent": 18, "acked": 12, "windows": 2,
            "reason": "sustained_DEGRADED"},
    "handoffs": 2, "completed": 1, "aborted": 0,
    "moves_total": {"game3->game5:sustained_DEGRADED": 24},
    "aborts_total": {},
}


def test_obs_aggregate_rebalance_lines_render_agents_and_controller():
    agg = {"rebalance": {
        "agents": [
            {"source": "game3:game3", **_AGENT_SNAP},
            {"source": "game4:game4", "game": "game4", "busy": False,
             "job": None, "handoffs": 0, "completed": 0,
             "aborted": 0, "moves_total": {}, "aborts_total": {}},
        ],
        "controller": {"source": "dispatcher", "policy": {
            "window": 41, "committed": 2, "planned": 3,
            "pending": {"frm": "game3", "to": "game5"},
            "runs": {"game3": 2},
        }},
    }}
    lines = both(lambda p: _tools(p).obs.rebalance_lines(agg)
                 + _tools(p).obs.rebalance_lines({"rebalance": {}}))
    assert len(lines) == 2
    assert "rebalance game3 BUSY" in lines[0] and "12/18 acked" in lines[0]
    assert "controller (dispatcher)" in lines[1]


def test_scrape_metrics_rebalance_lines_per_process():
    scraped = {"game3": {"agents": {"game3": _AGENT_SNAP}},
               "game4": {"agents": {"game4": {
                   "game": "game4", "busy": False, "job": None,
                   "handoffs": 0, "completed": 0, "aborted": 0,
                   "moves_total": {}, "aborts_total": {}}}}}
    lines = both(lambda p: _tools(p).scrape.rebalance_lines(scraped))
    assert len(lines) == 1
    assert lines[0].startswith("game3: rebalance game3 BUSY")


def test_aggregate_rebalance_totals_from_live_endpoint():
    """Each package's ``aggregate_rebalance`` against its own live
    debug-http process."""
    class _StubAgent:
        def snapshot(self):
            return dict(_AGENT_SNAP)

    def run(p):
        _tools(p)
        p.rb.register("game3", _StubAgent())
        srv = p.http.start(0, process_name="rbtest")
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            agg = p.obs.aggregate_rebalance([("rbtest", base)])
            return ([a["source"] for a in agg["agents"]], agg["busy"],
                    agg["moves_total"], agg["aborts_total"])
        finally:
            srv.shutdown()

    assert both(run) == (["rbtest:game3"], 1, 24, 0)


# =======================================================================
# the in-process soak, both packages
# =======================================================================
def test_chaos_soak_wires_the_rebalance_scenario():
    """The port's soak module exposes the JAX soak's two rebalance
    entry points, and its CLI offers the scenario."""
    for p in PKGS:
        soak = _tools(p).soak
        assert callable(soak.run_rebalance)
        assert callable(soak._run_rebalance_variant)
    src = open(tsoak.__file__).read()
    assert '"rebalance"' in src.split('add_argument("--scenario"')[1]\
        .split(")")[0]


_KEYS = ("variant", "seed", "n", "batch", "windows", "converged",
         "hot_threshold", "handoff_fired", "commit_window", "committed",
         "entities_moved", "entities_lost", "entities_duplicated",
         "sends_dropped", "conservation_ok_all_windows",
         "max_in_flight_seen", "decision_log_replay_ok",
         "rebalance_action_triggers", "moves_total", "aborts_total",
         "killed_at_window", "acked_before_kill", "abort_cause",
         "entities_restored", "donor_recovery_windows")


def _plain(rep: dict) -> dict:
    """A variant report without what names a random space id: the
    decision log's observations and the action notes name games and
    counts only, so they stay."""
    return {k: rep.get(k) for k in _KEYS}


@pytest.fixture(scope="module")
def soaks():
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for p in PKGS:
            for mod in (jids, tids):
                seq = itertools.count()
                mp.setattr(mod, "gen_entity_id",
                           lambda seq=seq, mod=mod: mod.gen_fixed_id(
                               f"soak.{next(seq)}"))
            out[p.name] = _tools(p).soak.run_rebalance(77, **p.kw)
        yield out
    finally:
        mp.undo()


def test_chaos_soak_rebalance_scenario_converges(soaks):
    """``run_rebalance`` on both packages: both variants converge, and
    the reports — moves, restores, the abort's cause, the conservation
    verdict every window, the decision logs byte for byte — are
    equal."""
    for rep in soaks.values():
        clean, kill = rep["clean"], rep["target_kill"]
        assert clean.get("error") is None, clean
        assert kill.get("error") is None, kill
        assert clean["converged"] and kill["converged"], rep
        assert clean["entities_moved"] == clean["batch"]
        assert clean["max_in_flight_seen"] > 0
        assert kill["abort_cause"] == "timeout"
        assert kill["entities_restored"] == (kill["batch"]
                                             - kill["entities_moved"])
        assert rep["converged"]
    for variant in ("clean", "target_kill"):
        a, b = soaks["jax"][variant], soaks["port"][variant]
        assert _plain(a) == _plain(b), variant
        assert a["decision_log"] == b["decision_log"], variant
        assert a["lost_eids"] == b["lost_eids"] == []


def test_chaos_soak_rebalance_is_seed_deterministic(soaks, seeded):
    """Same seed, same decision log: the port's clean variant run twice
    more gives the JAX soak's log and commit window each time."""
    ref = soaks["jax"]["clean"]
    for _ in range(2):
        a = tsoak._run_rebalance_variant(77, kill_target=False,
                                         device="cpu")
        assert a.get("error") is None, a
        assert a["decision_log"] == ref["decision_log"]
        assert a["entities_moved"] == ref["entities_moved"]
        assert a["commit_window"] == ref["commit_window"]


def test_migrated_out_entity_stays_in_its_watchers_interest(worlds):
    """ROADMAP.md Queue C12, held to the JAX package: an entity that
    leaves its game by ``remove_for_migration`` (a handoff's send) stays
    in the interest sets of the entities that watched it, and their
    clients get no destroy for it: the World drops the host object
    before the leave events of its row are decoded. Both packages
    alike."""
    def run(p):
        w, sp, ents = worlds(p, 949, n=0)
        a = sp.create_entity("Mob", pos=(50.0, 0.0, 50.0))
        a.set_client(p.ent.GameClient(1, "c" * 16, w))
        m = sp.create_entity("Mob", pos=(55.0, 0.0, 50.0))
        w.tick()
        w.tick()
        assert m.id in a.interested_in
        w.client_messages.clear()
        w.get_migrate_data(m)
        w.remove_for_migration(m, target=3)
        w.tick()
        w.tick()
        return (m.id in a.interested_in, m.id in w.entities,
                [(msg["type"], msg.get("eid") == m.id)
                 for _g, _c, msg in w.client_messages])

    assert both(run) == (True, False, [])
