"""The port's kernel governor (``goworld_tpu_torch.autotune``) and
``World.apply_tick_config`` on the CPU, against the JAX package's.

The policy is the JAX package's pure Python: its tables, classifier and
a long seeded signature stream replay byte for byte. The warm set builds
each candidate's step and runs it once off the tick thread; a warmed
step equals a fresh one. The live swap: one scripted world with churn
(fixed entity ids, capacity 128, the bench's skin of 4) swaps through
``default -> skin=0 -> sweep=table,skin=0 -> sort=counting,skin=0 ->
default`` on the JAX World and the port's, and every tick's outputs,
state and interest sets agree; on the port, each swap's first tick
equals a fresh step at the target config on a clone of the carried
state. Then the governor's runtime: warm-gated commits, the regret
guard, the registry."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from goworld_tpu import autotune as jauto
from goworld_tpu import entity as jent
from goworld_tpu.autotune import governor as jgov
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.entity.manager import _make_local_tick as jlocal
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import autotune as tauto
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import interop
from goworld_tpu_torch.autotune import governor as tgov
from goworld_tpu_torch.autotune import policy as tpolicy
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.entity.manager import _make_local_tick as tlocal
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids, metrics

CAP = 128
GRID = dict(radius=25.0, extent_x=200.0, extent_z=200.0, k=16,
            cell_cap=16, row_block=CAP, topk_impl="sort", skin=4.0)
WORLD = dict(capacity=CAP, npc_speed=6.0, enter_cap=1024, leave_cap=1024,
             sync_cap=1024, attr_sync_cap=64, input_cap=64,
             delta_rows_cap=CAP)
SWAPS = ["skin=0", "sweep=table,skin=0", "sort=counting,skin=0",
         "default"]


def sig(churn="flock_like", rebuild_rate=0.1, density="exact",
        events="quiet", **extra):
    s = {"churn": churn, "rebuild_rate": rebuild_rate,
         "density": density, "events": events, "sig": f"churn={churn}"}
    s.update(extra)
    return s


TELE = sig(churn="teleport_like", rebuild_rate=0.95)
FLOCK = sig(churn="flock_like", rebuild_rate=0.05)


# ----------------------------------------------------------------------
# policy
# ----------------------------------------------------------------------
def _stream(seed: int, n: int) -> list:
    """A seeded signature stream over the classifier's whole grammar."""
    rng = np.random.default_rng(seed)
    pool = [TELE, FLOCK,
            sig(churn="teleport_like", rebuild_rate=0.55),
            sig(churn="skinless", events="heavy"),
            sig(churn="skinless", events="quiet"),
            sig(churn="skinless", events="low"),
            sig(density="over_k", over_k_frac=0.8),
            sig(density="over_cap", over_k_frac=0.0),
            {"error": "no samples"}, None, sig(churn="other")]
    out = []
    while len(out) < n:
        s = pool[int(rng.integers(len(pool)))]
        out += [s] * int(rng.integers(1, 6))
    return out[:n]


def test_policy_tables_and_classifier_match_jax():
    for name in ("DEFAULT_CANDIDATES", "CANDIDATE_GRID_KEYS",
                 "DEFAULT_TABLE", "SCENARIO_CLASS_MAP", "CHURN_HOLD_BAND",
                 "DENSITY_DUTY_MIN"):
        assert getattr(tpolicy, name) == getattr(jauto.policy, name), name
    assert tauto.seed_table() == jauto.seed_table()
    spec = "teleport_like:skin=0; density:sort=counting,skin=0"
    assert tauto.parse_table(spec) == jauto.parse_table(spec)
    for bad in ("nope:skin=0", "density", "density:nope"):
        with pytest.raises((ValueError, KeyError)):
            tauto.parse_table(bad)
    for s in _stream(1, 200):
        assert tauto.classify_signature(s) == jauto.classify_signature(s)
    for lbl, ov in tauto.DEFAULT_CANDIDATES:
        assert tauto.candidate_overrides(lbl) == \
            jauto.candidate_overrides(lbl)


@pytest.mark.parametrize("knobs", [
    dict(), dict(up_windows=3, down_windows=1, cooldown_windows=2),
    dict(up_windows=1, down_windows=4, cooldown_windows=0)])
def test_policy_replay_is_byte_identical_to_jax(knobs):
    """One seeded stream of 600 windows, with regret pins at fixed
    windows, through both policies: the same transition log, byte for
    byte, and the same snapshots."""
    ps = [tauto.GovernorPolicy(**knobs), jauto.GovernorPolicy(**knobs)]
    for w, s in enumerate(_stream(7, 600)):
        got = [p.observe(s) for p in ps]
        assert got[0] == got[1]
        if w % 97 == 50:
            for p in ps:
                p.pin("default", 5, f"regret(w{w})")
    assert ps[0].log_lines() == ps[1].log_lines()
    assert "\n".join(ps[0].log_lines()).encode() == \
        "\n".join(ps[1].log_lines()).encode()
    assert ps[0].snapshot() == ps[1].snapshot()
    assert len(ps[0].transitions) > 5


# ----------------------------------------------------------------------
# the scripted world on both packages
# ----------------------------------------------------------------------
def make_world(pkg: str, planes: bool = False):
    mod = jent if pkg == "jax" else tent
    if pkg == "jax":
        cfg = JConfig(grid=JGrid(sweep_impl="ranges", sort_impl="argsort",
                                 **GRID), **WORLD)
        kw = {}
    else:
        cfg = TConfig(grid=TGrid(sweep_impl="fused", sort_impl="pallas",
                                 **GRID), **WORLD)
        kw = dict(device="cpu")
    if not planes:
        kw.update(telemetry_live=False, residency=False, audit=False)
    w = mod.World(cfg, seed=3, **kw)
    w.register_entity("Npc", type("Npc", (mod.Entity,), {}))
    w.register_space("Arena", type("Arena", (mod.Space,), {}))
    w.create_nil_space()
    arena = w.create_space("Arena", eid=ids.gen_fixed_id("auto.arena"))
    rng = np.random.default_rng(11)
    ents = [w.create_entity(
        "Npc", space=arena, pos=(float(rng.uniform(5, 195)), 0.0,
                                 float(rng.uniform(5, 195))),
        moving=True, eid=ids.gen_fixed_id(f"auto.{i}"))
        for i in range(CAP - 24)]
    return w, arena, ents


def churn(w, arena, live: list, rng, t: int) -> None:
    w.destroy_entity(live.pop(int(rng.integers(len(live)))))
    live.append(w.create_entity(
        "Npc", space=arena, pos=(float(rng.uniform(5, 195)), 0.0,
                                 float(rng.uniform(5, 195))),
        moving=True, eid=ids.gen_fixed_id(f"auto.churn.{t}")))


def interest(ents) -> dict:
    return {e.id: frozenset(e.interested_in) for e in ents
            if not e.destroyed}


@pytest.fixture(scope="module")
def warm():
    """A port World and its warm set with every default candidate
    warmed (shared: each warm runs a step once)."""
    w, arena, ents = make_world("port", planes=True)
    ws = tauto.WarmSet(w.cfg, 1, w.policy, device="cpu")
    ws.warm_all()
    return w, arena, ents, ws


def _commit(w, e):
    w.apply_tick_config(e.cfg, e.step, telem_fold=e.fold,
                        telem_acc0=e.acc0, telem_skin_on=e.skin_on,
                        telem_half_skin=e.half_skin)


def test_warmset_warms_every_candidate_once(warm):
    _, _, _, ws = warm
    assert ws.warm_count == len(tauto.DEFAULT_CANDIDATES)
    for lbl in ws.labels():
        e = ws.entry(lbl)
        assert e.warm and e.warm_s > 0
        assert e.cfg.grid == tauto.candidate_config(
            ws.base_cfg, tauto.candidate_overrides(lbl)).grid
        assert e.skin_on == (e.cfg.grid.skin > 0)
        assert int(e.acc0.counts.sum()) == 0
    assert ws.ensure("skin=0") and ws.ensure("default", block=True)
    assert ws.warm_count == len(tauto.DEFAULT_CANDIDATES)
    snap = ws.snapshot()
    assert snap["warms"] == 4 and snap["skin=0"]["config"]["skin"] == 0.0
    with pytest.raises(KeyError):
        ws.ensure("not_a_candidate")
    with pytest.raises(ValueError, match="single-shard"):
        tauto.WarmSet(ws.base_cfg, 2, None, device="cpu")


def test_blocking_ensure_waits_out_the_inflight_warm(warm):
    w, _, _, _ = warm
    ws = tauto.WarmSet(w.cfg, 1, None, telemetry=False, device="cpu")
    assert ws.ensure("skin=0") is False or ws.is_warm("skin=0")
    assert ws.ensure("skin=0", block=True)
    assert ws.warm_count == 1


def test_swap_mid_churn_matches_jax_and_a_fresh_step():
    """Through every default candidate and back, with a destroy and a
    create staged each tick: the port's World and the JAX World give the
    same outputs, state and interest sets on every tick; on the port,
    the first tick after each swap equals a fresh step at the target
    config on a clone of the carried state, and the carry keeps its
    addresses (the dropped cache's lanes are not written)."""
    jw, ja, je = make_world("jax")
    tw, ta, te = make_world("port")
    ws = tauto.WarmSet(tw.cfg, 1, None, telemetry=False, device="cpu")
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    first = {}
    jbase, tbase = jw.cfg, tw.cfg

    def spy(state, inputs, policy):
        first["fresh"] = tlocal(tw.cfg, 1, "cpu", resident=False)(
            state.apply(torch.clone), inputs, policy)
        return tw._step_now(state, inputs, policy)

    for t in range(18):
        if t % 4 == 3 and t // 4 < len(SWAPS):
            lbl = SWAPS[t // 4]
            cfg_j = jauto.candidate_config(
                jbase, jauto.candidate_overrides(lbl))
            jw.apply_tick_config(cfg_j, jlocal(cfg_j, 1, donate=True))
            assert ws.ensure(lbl, block=True)
            _commit(tw, ws.entry(lbl))
            assert (tw.state.aoi_cache is None) == (lbl != "default")
            tw._step_now, tw._step = tw._step, spy
        churn(jw, ja, je, rngs[0], t)
        churn(tw, ta, te, rngs[1], t)
        jw.tick()
        tw.tick()
        if tw._step is spy:
            fs, fo = first.pop("fresh")
            got = interop.state_to_numpy(tw.state)
            ref = interop.state_to_numpy(fs)
            for k in ref:
                if not isinstance(ref[k], dict):
                    assert np.array_equal(got[k], ref[k]), (t, k)
            for f in dataclasses.fields(fo):
                assert np.array_equal(getattr(tw.last_outputs, f.name),
                                      getattr(fo, f.name).numpy()), \
                    (t, f.name)
            tw._step = tw._step_now
        got = interop.state_to_numpy(tw.state)
        for f in dataclasses.fields(jw.state):
            v = getattr(jw.state, f.name)
            if v is None or f.name == "aoi_cache":
                continue
            assert np.array_equal(got[f.name], np.asarray(v)), (t, f.name)
        for f in dataclasses.fields(jw.last_outputs):
            v = getattr(jw.last_outputs, f.name)
            if v is not None:
                assert np.array_equal(
                    getattr(tw.last_outputs, f.name), np.asarray(v)), \
                    (t, f.name)
        assert interest(te) == interest(je)
    assert tw.cfg == tbase and jw.cfg == jbase


def test_telemetry_lane_set_follows_the_swap(warm):
    w, _, _, ws = warm
    _commit(w, ws.entry("skin=0"))
    for _ in range(3):
        w.tick()
    s = w.workload_signature()
    assert s is not None and s["churn"] == "skinless"
    assert s["config"]["skin"] == 0.0 and s["window_ticks"] == 3
    _commit(w, ws.entry("default"))
    w.tick()
    assert int(ws.entry("default").acc0.counts.sum()) == 0
    assert w.workload_signature()["config"]["skin"] == 4.0


def test_several_spaces_refuse_the_swap():
    w = tent.World(TConfig(capacity=32, grid=TGrid(radius=25.0)),
                   n_spaces=2, device="cpu")
    with pytest.raises(ValueError, match="single-shard"):
        w.apply_tick_config(w.cfg, w._step)
    with pytest.raises(ValueError, match="single-shard"):
        tauto.KernelGovernor(w)


# ----------------------------------------------------------------------
# the governor runtime
# ----------------------------------------------------------------------
def test_governor_commits_warm_targets_and_counts(warm):
    w, _, _, ws = warm
    _commit(w, ws.entry("default"))
    g = tauto.KernelGovernor(w, name="tgov", up_windows=1,
                             cooldown_windows=0)
    g.warmset = ws
    ev = g.on_window(TELE, tick_ms_p90=5.0)
    assert ev is not None and ev["to"] == "skin=0"
    assert g.current == "skin=0" and w.cfg.grid.skin == 0.0
    assert metrics.counter("governor_swaps_total", **{
        "from": "default", "to": "skin=0", "reason": "policy"}).value >= 1
    w.tick()
    assert g.log_lines() == ["#1 default->skin=0 policy"]
    snap = g.snapshot()
    assert snap["current"] == "skin=0" and snap["regret_guard"]


def test_regret_guard_reverts_and_pins(warm):
    w, _, _, ws = warm
    _commit(w, ws.entry("default"))
    g = tauto.KernelGovernor(w, name="tregret", up_windows=1,
                             cooldown_windows=0, regret_pct=0.25,
                             regret_pin_windows=4)
    g.warmset = ws
    assert g.on_window(TELE, tick_ms_p90=5.0)["to"] == "skin=0"
    ev = g.on_window(TELE, tick_ms_p90=10.0)
    assert ev["to"] == "default" and ev["reason"] == "regret"
    assert ev["regret"]["post_p90_ms"] == 10.0
    assert w.cfg.grid.skin == 4.0
    # pinned: the teleport verdict does not swap again for 4 windows
    for _ in range(3):
        assert g.on_window(TELE, tick_ms_p90=5.0) is None
    w.tick()


def test_pending_until_warm_then_commit(warm):
    w, _, _, _ = warm
    g = tauto.KernelGovernor(w, name="tcold", up_windows=1,
                             cooldown_windows=0)
    g.warmset.telemetry = False
    ev = g.on_window(TELE, tick_ms_p90=5.0)
    if ev is None:
        assert g.pending == "skin=0"
        deadline = time.monotonic() + 60
        while not g.warmset.is_warm("skin=0") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        ev = g.on_window(TELE, tick_ms_p90=5.0)
    assert ev is not None and ev["to"] == "skin=0"
    w.tick()


def test_registry_matches_jax():
    tgov.reset()
    jgov.reset()
    assert tgov.snapshot() == jgov.snapshot()
    w, _, _ = make_world("port")
    g = tgov.register("treg", tauto.KernelGovernor(w, name="treg"))
    assert tgov.snapshot()["treg"]["current"] == "default"
    tgov.unregister("treg")
    assert "error" in tgov.snapshot()
    tgov.register("treg", g)
    del g
    import gc

    gc.collect()
    assert tgov.snapshot() == jgov.snapshot()
    tgov.reset()
