"""The port's scenario worlds against the JAX package's on the CPU: the
registry (a copy of the JAX ``scenarios/spec.py``) and the lanes it
draws, the phase schedule, 8 ticks of ``make_tick`` under each of the
registry's scenarios, the megaspace under the non-btree scenarios, and
``run_scenario`` through the serving World.

Tolerance is 0: bit for bit, floats included, each tick started from
the JAX state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.scenarios import behaviors as jbeh
from goworld_tpu.scenarios import spec as jspec
from goworld_tpu.scenarios.runner import run_scenario as jrun
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.scenarios import behaviors as tbeh
from goworld_tpu_torch.scenarios import spec as tspec
from goworld_tpu_torch.scenarios.runner import run_scenario as trun

import test_torch_behaviors as tb

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

NAMES = tspec.scenario_names()


def test_registry_matches_jax():
    assert tspec.scenario_names() == jspec.scenario_names()
    assert tspec.BEHAVIORS == jspec.BEHAVIORS
    assert tspec.bench_workloads() == jspec.bench_workloads()
    for name in NAMES:
        assert dataclasses.asdict(tspec.get_scenario(name)) == \
            dataclasses.asdict(jspec.get_scenario(name))
        for b in ("needs_policy", "needs_features", "uniform_radius",
                  "behavior_names"):
            assert getattr(tspec.get_scenario(name), b) == \
                getattr(jspec.get_scenario(name), b)
    for name in ("mlp", "btree", "random_walk", "hotspot", "mixed"):
        tb_, ts_ = tspec.resolve_bench_behavior(name)
        jb_, js_ = jspec.resolve_bench_behavior(name)
        assert tb_ == jb_ and (ts_ is None) == (js_ is None)
    with pytest.raises(ValueError) as te:
        tspec.resolve_bench_behavior("nope")
    with pytest.raises(ValueError) as je:
        jspec.resolve_bench_behavior("nope")
    assert str(te.value).split("(")[0] == str(je.value).split("(")[0]


@pytest.mark.parametrize("name", NAMES)
def test_created_lanes_match_jax(name):
    jcfg, tcfg = tb.configs(scenario=jspec.get_scenario(name))
    tcfg = dataclasses.replace(tcfg, scenario=tspec.get_scenario(name))
    js = jstate.create_state(jcfg, seed=3)
    ts = tstate.create_state(tcfg, seed=3, device="cpu")
    got = interop.state_to_numpy(ts)
    for lane in ("behavior_id", "aoi_radius"):
        assert tb._bits_differ(got[lane], np.asarray(getattr(js, lane))) \
            == 0, lane


@pytest.mark.parametrize("t", [0, 1, 9, 13, 599, 600, 601, 1799, 5000])
def test_scenario_context_matches_jax(t):
    spec = jspec.get_scenario("mixed")
    jcfg, tcfg = tb.configs()
    missed = 0
    for bounds in (None, (0.0, 0.0, 1234.0, 777.0)):
        ref = jax.jit(lambda tt: jbeh.scenario_context(
            spec, jcfg, tt, bounds))(jnp.asarray(t, jnp.int32))
        got = tbeh.scenario_context(tspec.get_scenario("mixed"), tcfg,
                                    tb._t(np.asarray(t, np.int32)), bounds)
        for key in ("attractor", "zone_r", "wind"):
            r = np.atleast_1d(np.asarray(ref[key], np.float32))
            g = np.atleast_1d(np.array([float(x) for x in (
                got[key] if isinstance(got[key], tuple)
                else (got[key],))], np.float32))
            missed += tb._bits_differ(g, r)
    assert missed == 0, missed


@pytest.mark.parametrize("name", NAMES)
def test_scenario_ticks_match_jax(name):
    jcfg, tcfg = tb.configs(scenario=jspec.get_scenario(name))
    tcfg = dataclasses.replace(tcfg, scenario=tspec.get_scenario(name))
    lanes, inputs = tb.bench_lanes(jcfg)
    st = jstate.create_state(jcfg, seed=1)
    lanes["behavior_id"] = np.asarray(st.behavior_id)
    lanes["aoi_radius"] = np.asarray(st.aoi_radius)
    diffs, gauges = tb.run_ticks(jcfg, tcfg, lanes, inputs)
    assert gauges["enter"] > 0 and gauges["sync"] > 0
    assert not diffs, diffs


# the members no registry scenario mixes: mlp and btree (a mix with a
# policy)
MEMBER_MIXES = {
    "npc_mix": (("mlp", 0.3), ("btree", 0.3), ("random_walk", 0.4)),
    "mlp_only": (("mlp", 1.0),),
    "btree_only": (("btree", 1.0),),
}


@pytest.mark.parametrize("case", sorted(MEMBER_MIXES))
def test_member_mix_ticks_match_jax(case):
    """The mlp member (a per-entity forward pass under vmap in JAX; the
    batched kernel here) and the btree member, 8 ticks from the JAX
    state each."""
    from goworld_tpu.models.npc_policy import init_policy as jinit

    from goworld_tpu_torch.models.npc_policy import init_policy

    mix = MEMBER_MIXES[case]
    jcfg, tcfg = tb.configs(scenario=jspec.ScenarioSpec(name=case, mix=mix))
    tcfg = dataclasses.replace(tcfg, scenario=tspec.ScenarioSpec(
        name=case, mix=mix))
    lanes, inputs = tb.bench_lanes(jcfg)
    lanes["behavior_id"] = np.asarray(
        jstate.create_state(jcfg, seed=1).behavior_id)
    pol = tcfg.scenario.needs_policy
    diffs, gauges = tb.run_ticks(
        jcfg, tcfg, lanes, inputs,
        jinit(jax.random.PRNGKey(5), 128) if pol else None,
        init_policy(5, 128, device="cpu") if pol else None)
    assert gauges["enter"] > 0
    assert not diffs, diffs


def test_teleport_trips_the_verlet_rebuild_on_its_tick():
    """A teleport overrides the integrated position before the sweep,
    so the skin's device gate rebuilds on that very tick."""
    from goworld_tpu_torch.core.step import TickInputs, make_tick
    from goworld_tpu_torch.ops.aoi import GridSpec

    spec = dataclasses.replace(tspec.get_scenario("teleport"),
                               teleport_prob=0.2, churn_rate=0.0)
    cfg = tstate.WorldConfig(
        capacity=256, scenario=spec,
        grid=GridSpec(radius=10.0, extent_x=200.0, extent_z=200.0, k=16,
                      cell_cap=16, skin=4.0))
    st = tstate.create_state(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(2)
    st = st.replace(
        pos=tb._t(np.stack([rng.uniform(0, 200, 256), np.zeros(256),
                            rng.uniform(0, 200, 256)], 1)
                  .astype(np.float32)),
        alive=tb._t(np.ones(256, bool)),
        npc_moving=tb._t(np.ones(256, bool)))
    tick = make_tick(cfg, device="cpu")
    inputs = TickInputs.empty(cfg, device="cpu")
    st, out = tick(st, inputs)
    rebuilt = []
    for _ in range(4):
        st, out = tick(st, inputs)
        rebuilt.append(int(out.aoi_rebuilt))
    assert rebuilt == [1, 1, 1, 1]


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if "btree" not in
                                  tspec.get_scenario(n).behavior_names])
def test_mega_scenario_ticks_match_jax(name):
    """The 2x2 megaspace under a scenario, 4 ticks from the JAX state
    each: the schedule on the world's bounds, the features from the
    summary lanes."""
    import test_torch_mega as tm

    from goworld_tpu.parallel.mesh import make_mesh
    from goworld_tpu.parallel.step import MultiTickInputs as JMulti

    jmc, tmc = tm._configs(True, "async")
    jmc = dataclasses.replace(jmc, cfg=dataclasses.replace(
        jmc.cfg, scenario=jspec.get_scenario(name)))
    tmc = dataclasses.replace(tmc, cfg=dataclasses.replace(
        tmc.cfg, scenario=tspec.get_scenario(name)))
    lanes, inputs = tm._mega_world(jmc)
    lanes["aoi_cache"] = None
    lanes["behavior_id"] = np.asarray(tm.jcreate(jmc, seed=2).behavior_id)
    js = tm._jax_state(jmc, lanes)
    ji = JMulti(base=JInputs(**{k: jnp.asarray(v)
                                for k, v in inputs["base"].items()}),
                migrate_target=jnp.asarray(inputs["migrate_target"]),
                migrate_tag=jnp.asarray(inputs["migrate_tag"]))
    ti = interop.multi_inputs_from_numpy(inputs, device="cpu")
    jtick = tm.jmake(jmc, make_mesh(jmc.n_dev))
    ttick = tm.make_mega_tick(tmc, device="cpu")
    for _ in range(4):
        ts = interop.state_from_numpy(tm._jax_lanes(js), device="cpu")
        js, jo = jtick(js, ji, None)
        ts, to = ttick(ts, ti)
        got, ref = interop.state_to_numpy(ts), tm._jax_lanes(js)
        for k in got:
            if not isinstance(got[k], dict):
                assert tb._bits_differ(got[k], ref[k]) == 0, k
        gout = interop.mega_outputs_to_numpy(to)
        rout = tm._jax_lanes(jo)
        for k, v in gout["base"].items():
            assert tb._bits_differ(v, np.asarray(getattr(jo.base, k))) \
                == 0, k
        for k, v in gout.items():
            if k != "base":
                assert tb._bits_differ(v, rout[k]) == 0, k


def test_run_scenario_mixed_matches_jax():
    """The serving World through ``run_scenario("mixed")``: the same
    gauges, and both exact against their oracles."""
    j = jrun("mixed", ticks=9, oracle_every=3)
    t = trun("mixed", ticks=9, oracle_every=3, device="cpu")
    assert t.gauges() == j.gauges()
    assert t.oracle_ok and j.oracle_ok
    assert t.oracle_ticks_checked == j.oracle_ticks_checked == 3


@pytest.mark.parametrize("name,spaces", [
    (n, s) for n in NAMES for s in (2, 3, 8)] + [
    (m, 8) for m in sorted(MEMBER_MIXES)])
def test_batched_scenario_ticks_match_jax_vmapped_step(name, spaces):
    """Every registry scenario at S = 2, 3 and 8 and every member mix at
    S = 8 on the batched tick, 512 rows a Space, 8 ticks, bit for bit
    against the JAX World's vmapped step: each Space splits its own key
    into per-entity keys and reads its own tick's phase, the
    ``behavior_id`` select, teleports, mixed watch radii, and the npc
    mix's one-row matvecs now ``[S, N]`` of them (summed in k order)."""
    from goworld_tpu.models.npc_policy import init_policy as jinit
    from test_torch_multispace import _run_both, stacked_bench

    from goworld_tpu_torch.models.npc_policy import init_policy

    if name in MEMBER_MIXES:
        jspec_ = jspec.ScenarioSpec(name=name, mix=MEMBER_MIXES[name])
        tspec_ = tspec.ScenarioSpec(name=name, mix=MEMBER_MIXES[name])
    else:
        jspec_, tspec_ = jspec.get_scenario(name), tspec.get_scenario(name)
    jcfg, tcfg = tb.configs(scenario=jspec_)
    tcfg = dataclasses.replace(tcfg, scenario=tspec_)
    lanes, inputs = stacked_bench(jcfg, spaces, scenario=True)
    pol = tspec_.needs_policy
    _, outs = _run_both(
        jcfg, tcfg, lanes, inputs, 8,
        jinit(jax.random.PRNGKey(5), 128) if pol else None,
        init_policy(5, 128, device="cpu") if pol else None)
    assert (outs[0]["enter_n"] > 0).all()
