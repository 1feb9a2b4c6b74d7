"""The port's NPC behaviors (BASELINE config 5) against the JAX
package's on the CPU: the bf16 MLP policy (``init_policy``, the forward
pass, the observation), the Monster behavior tree's features and
velocity, then whole ticks under ``behavior="btree"`` and ``"mlp"``
through ``make_tick``, the megaspace under mlp, and a served World
under mlp.

Tolerance is 0: bit for bit, floats included, the float orders of
XLA's CPU code generation among them (``ops/xla_order.py``; the rows
whose ``pos + vel * dt`` the reference contracts, ``core/step.py``
``contracted_rows``). Each tick starts both sides from the JAX state,
so one tick's miss never feeds the next.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.core.step import make_tick as jmake_tick
from goworld_tpu.models import behavior_tree as jbt
from goworld_tpu.models import npc_policy as jpol
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import interop, kernels
from goworld_tpu_torch.core.step import make_tick
from goworld_tpu_torch.models import behavior_tree as tbt
from goworld_tpu_torch.models import npc_policy as tpol
from goworld_tpu_torch.ops import mlp as tmlp
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.xla_order import dot_f32, dot_lanes, fma32, ftz
from goworld_tpu_torch.workload import slice_config

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 512
TICKS = 8


def _bits_differ(a, b) -> int:
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        a = a.view(np.uint32 if a.itemsize == 4 else np.uint16)
        b = b.view(a.dtype)
    return int((a != b).sum())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_policy_np(p) -> dict:
    return {k: np.asarray(getattr(p, k)) for k in
            ("w1", "b1", "w2", "b2", "w3", "b3")}


# ------------------------------------------------------------- the policy

@pytest.mark.parametrize("hidden", [128, 16])
@pytest.mark.parametrize("seed", [0, 5, 123])
def test_init_policy_matches_jax(seed, hidden):
    ref = _jax_policy_np(jpol.init_policy(jax.random.PRNGKey(seed), hidden))
    got = interop.policy_to_numpy(tpol.init_policy(seed, hidden,
                                                   device="cpu"))
    for name, r in ref.items():
        assert got[name].dtype == r.dtype and got[name].shape == r.shape
        assert _bits_differ(got[name], r) == 0, name


def test_normal_bf16_matches_jax_on_every_uniform():
    """A 512 x 512 draw reaches each of the 128 bf16 uniforms JAX can
    make, so every erfinv value the map takes is held here."""
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.normal(key, (512, 512), jnp.bfloat16)
                     .astype(jnp.float32))
    got = tpol.normal_bf16(prng.prng_key(11, "cpu"), (512, 512)).numpy()
    bits8 = (prng.random_bits32(prng.prng_key(11, "cpu"), (512, 512))
             & 0xFF) >> 1
    assert len(torch.unique(bits8)) == 128
    assert _bits_differ(got, ref) == 0


def test_policy_round_trips_through_interop():
    jp = jpol.init_policy(jax.random.PRNGKey(3), 16)
    arrays = _jax_policy_np(jp)
    words = {k: v.view(np.uint16) for k, v in arrays.items()}
    for src in (arrays, words, jp):
        back = interop.policy_to_numpy(interop.policy_from_numpy(
            src, device="cpu"))
        for k, v in arrays.items():
            assert _bits_differ(back[k], v) == 0, k


@pytest.mark.parametrize("rows", [1, 3, 5, 50, 51, 4096, 1 << 15])
@pytest.mark.parametrize("hidden", [128, 16])
def test_policy_accel_matches_jax(hidden, rows):
    rng = np.random.default_rng(rows + hidden)
    obs = (rng.standard_normal((rows, 10))
           * rng.choice([0.1, 1.0, 3.0], (rows, 10))).astype(np.float32)
    jp = jpol.init_policy(jax.random.PRNGKey(5), hidden)
    ref = np.asarray(jax.jit(jpol.policy_accel)(jp, obs))
    got = tpol.policy_accel(tpol.init_policy(5, hidden, device="cpu"),
                            _t(obs)).numpy()
    assert _bits_differ(got, ref) == 0


@pytest.mark.parametrize("shape", [(10, 128), (128, 128), (128, 3),
                                   (10, 16), (16, 16), (16, 3)])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 50, 51, 4096])
def test_dot_order_matches_xla(shape, rows):
    """XLA's CPU float32 dot of bf16 values: k order for wide outputs,
    under 4 rows, or at the observation layer up to 50 rows, else 4 (or
    2) interleaved partial sums."""
    k, m = shape
    rng = np.random.default_rng(k * m + rows)
    x = _t(rng.standard_normal((rows, k)).astype(np.float32)) \
        .to(torch.bfloat16).float()
    w = _t(rng.standard_normal((k, m)).astype(np.float32) * 0.3) \
        .to(torch.bfloat16).float()
    ref = np.asarray(jax.jit(lambda a, b: a @ b)(x.numpy(), w.numpy()))
    got = dot_f32(x, w, dot_lanes(rows, k, m)).numpy()
    assert _bits_differ(got, ref) == 0


def test_tanh_bf16_matches_xla_on_every_input():
    """``tanh_bf16``, and the kernel's table as the wrapper builds it and
    the kernel reads it (``|x|``, then the sign), equal XLA's bf16 tanh
    on all 65,536 inputs; ``tanh_bf16`` is odd on every input, so the
    magnitude table holds."""
    allb = torch.arange(65536, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    ref = np.asarray(jax.jit(lambda v: jnp.tanh(v).astype(jnp.bfloat16)
                             .astype(jnp.float32))(allb.numpy()))
    fin = np.isfinite(allb.numpy())
    for got in (tmlp.tanh_bf16(allb).numpy(),
                tmlp.tanh_by_table(allb).numpy()):
        assert _bits_differ(got[fin], ref[fin]) == 0
        assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert tmlp.tanh_table("cpu").shape == (32768,)
    pos = allb[:32768]
    odd = ~torch.isnan(pos)
    assert _bits_differ(tmlp.tanh_bf16(-pos)[odd].numpy(),
                        (-tmlp.tanh_bf16(pos))[odd].numpy()) == 0


def _bf16_at(rng, exps: np.ndarray) -> torch.Tensor:
    """bf16 values (as float32) with unbiased exponents ``exps`` (-133
    reaches the subnormals), random 7-bit significands and signs."""
    m = 1.0 + rng.integers(0, 128, exps.size) / 128.0
    v = m * np.exp2(exps.astype(np.float64)) * rng.choice([-1.0, 1.0],
                                                           exps.size)
    return torch.tensor(v).float().to(torch.bfloat16).float()


def test_fma_guard_is_sufficient():
    """Wherever ``fma_exact`` (the kernel's layer-2 guard) holds, one
    fused multiply-add gives the bits of the rounded product plus the
    add, both under flush-to-zero as XLA's CPU runtime runs them (every
    input and result flushed, ``ftz``), over bf16 pairs at every
    exponent sum from -160 to +130 with random float32 accumulators; at
    least one overflow and one underflow case differ, so the guard is
    needed on both sides."""
    rng = np.random.default_rng(10)
    overflow = underflow = guarded = 0
    for esum in range(-160, 131):
        ex = rng.integers(-133, 128, 2048)
        ew = esum - ex
        ok = (ew >= -133) & (ew <= 127)
        x, w = _bf16_at(rng, ex[ok]), _bf16_at(rng, ew[ok])
        acc = torch.tensor(rng.standard_normal(x.numel()) * np.exp2(
            rng.integers(-150, 128, x.numel()).astype(np.float64))).float()
        x, w, acc = ftz(x), ftz(w), ftz(acc)
        fused = fma32(x, w, acc)
        rounded = ftz(ftz(x * w) + acc)
        same = (fused.view(torch.int32) == rounded.view(torch.int32)) \
            | (torch.isnan(fused) & torch.isnan(rounded))
        exact = tmlp.fma_exact(x, w)
        assert bool(same[exact].all()), esum
        guarded += int(exact.sum())
        overflow += int((~same & torch.isinf(rounded)
                         & torch.isfinite(fused)).sum())
        underflow += int((~same & torch.isfinite(rounded)).sum())
    assert guarded > 100000 and overflow > 0 and underflow > 0


def test_underflow_case_needs_layer_2s_rounded_path():
    """``workload.mlp_underflow_case`` (observations near 2e-36, w2
    below 2^-9): some of its layer-2 products fall below 2^-126, outside
    ``fma_exact``, and a layer 2 summed by fused multiply-adds (which
    keep such a product until the sum) gives other outputs than the
    plain version, which flushes each product as XLA's CPU runtime
    does, so the kernel's guard must take its rounded path there
    (``chip_smoke.py`` [17] holds the kernel to the plain version on
    it)."""
    from goworld_tpu_torch.workload import mlp_underflow_case

    obs, ws = mlp_underflow_case(4096, 0, "cpu")
    got = tmlp.npc_mlp(obs, *ws)
    assert bool((got != 0).all())
    f = [ftz(w.float()) for w in ws]
    l1, l2, l3 = tmlp.layer_lanes(obs.shape[0], f[0].shape[1])
    h1 = tmlp.tanh_bf16(tmlp._bf(ftz(tmlp._bf(dot_f32(
        ftz(tmlp._bf(obs)), f[0], l1)) + f[1])))
    assert not bool(tmlp.fma_exact(h1[:, :, None], f[2][None]).all())
    acc = torch.zeros(obs.shape[0], f[2].shape[1])
    for k in range(f[2].shape[0]):
        acc = fma32(h1[:, k:k + 1], f[2][k], acc)
    h2 = tmlp.tanh_bf16(tmlp._bf(ftz(tmlp._bf(acc) + f[3])))
    fused = ftz(tmlp._bf(dot_f32(h2, f[4], l3)) + f[5])
    assert _bits_differ(fused.numpy(), got.numpy()) > 0


def test_npc_mlp_wrapper_takes_the_plain_version_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; a tensor elsewhere that is not a card raises (no
    fallback). Its launches on the card are counted by chip_smoke.py
    [17]."""
    pol = tpol.init_policy(5, 16, device="cpu")
    ws = [getattr(pol, k) for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    obs = torch.randn(64, 10, generator=torch.Generator().manual_seed(0))
    before = kernels.LAUNCHES["npc_mlp"]
    got = tmlp.npc_mlp(obs, *ws)
    assert kernels.LAUNCHES["npc_mlp"] == before
    assert torch.equal(got, tmlp.npc_mlp_plain(obs, *ws))
    with pytest.raises(ValueError, match="unsupported device"):
        tmlp.npc_mlp(obs.to("meta"), *[w.to("meta") for w in ws])
    with pytest.raises(TypeError):
        tmlp.npc_mlp(obs, ws[0].float(), *ws[1:])


# --------------------------------------------- features and observations

def _neighbors(k: int, seed: int = 0, n: int = 2048):
    rng = np.random.default_rng(seed + k)
    pos = (rng.random((n, 3)) * 300).astype(np.float32)
    pos[:, 1] = rng.random(n)
    cnt = rng.integers(0, k + 1, n).astype(np.int32)
    nbr = np.full((n, k), n, np.int32)
    for i in range(n):
        nbr[i, :cnt[i]] = np.sort(rng.choice(n, cnt[i], replace=False))
    hc = rng.random(n) < 0.2
    vel = (rng.standard_normal((n, 3)) * 3).astype(np.float32)
    vel[:, 1] = 0
    vel[rng.random(n) < 0.2] = 0
    mov = rng.random(n) < 0.9
    yaw = rng.uniform(-7.0, 7.0, n).astype(np.float32)
    return pos, nbr, cnt, hc, vel, mov, yaw


@pytest.mark.parametrize("k", [8, 16, 17, 18, 20, 23, 24, 32, 48])
def test_neighbor_mean_offset_and_obs_match_jax(k):
    pos, nbr, cnt, hc, vel, mov, yaw = _neighbors(k)
    n = pos.shape[0]
    ref = np.asarray(jax.jit(lambda p, nb, c: jpol.neighbor_mean_offset(
        p, p, nb, c, n))(pos, nbr, cnt))
    got = tpol.neighbor_mean_offset(_t(pos), _t(pos), _t(nbr), _t(cnt), n)
    assert _bits_differ(got.numpy(), ref) == 0
    ext = (300.0, 277.0)
    ref = np.asarray(jax.jit(lambda *a: jpol.build_obs(*a, ext))(
        pos, vel, yaw, nbr, cnt))
    got = tpol.build_obs(*map(_t, (pos, vel, yaw, nbr, cnt)), ext)
    assert _bits_differ(got.numpy(), ref) == 0
    ref = np.asarray(jax.jit(lambda *a: jpol.build_obs_from_features(
        *a, k, ext))(pos, vel, yaw, cnt, pos * 0.1))
    got = tpol.build_obs_from_features(*map(_t, (pos, vel, yaw, cnt)),
                                       _t(pos * 0.1), k, ext)
    assert _bits_differ(got.numpy(), ref) == 0


@pytest.mark.parametrize("k", [8, 16, 32, 48])
def test_btree_features_and_velocity_match_jax(k):
    pos, nbr, cnt, hc, vel, mov, yaw = _neighbors(k, seed=1)
    jf = jax.jit(jbt.features_from_neighbors)(pos, hc, nbr, cnt)
    tf = tbt.features_from_neighbors(*map(_t, (pos, hc, nbr, cnt)))
    for name in ("nbr_cnt", "client_cnt", "client_off", "mean_off"):
        assert _bits_differ(getattr(tf, name).numpy(),
                            np.asarray(getattr(jf, name))) == 0, name
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda k_, f, v, m: jbt.btree_velocity(
        k_, f, v, m, 5.0, 0.05))(key, jf, vel, mov))
    # features handed in whole (as the megaspace's summary lanes are)
    feats = dataclasses.replace(tf, mean_sum=None, mean_den=None)
    got, _ = tbt.btree_velocity(prng.prng_key(3, "cpu"), feats, _t(vel),
                                _t(mov), 5.0, 0.05)
    assert _bits_differ(got.numpy(), ref) == 0
    sref = jbt.features_from_summary(cnt, cnt // 2, pos)
    sgot = tbt.features_from_summary(_t(cnt), _t(cnt // 2), _t(pos))
    for name in ("nbr_cnt", "client_cnt", "client_off", "mean_off"):
        assert _bits_differ(getattr(sgot, name).numpy(),
                            np.asarray(getattr(sref, name))) == 0


def test_monster_tree_mask_algebra_matches_jax():
    """The tree evaluates to the same action masks in traversal order,
    first-emitted-wins."""
    rng = np.random.default_rng(4)
    active = rng.random(256) < 0.8
    conds = {"player_in_aoi": rng.random(256) < 0.3,
             "crowded": rng.random(256) < 0.4}
    _, jacts = jbt.eval_tree(jbt.monster_tree(), jnp.asarray(active),
                             {k: jnp.asarray(v) for k, v in conds.items()})
    _, tacts = tbt.eval_tree(tbt.monster_tree(), _t(active),
                             {k: _t(v) for k, v in conds.items()})
    assert [a for a, _ in jacts] == [a for a, _ in tacts]
    for (_, jm), (_, tm) in zip(jacts, tacts):
        assert np.array_equal(np.asarray(jm), tm.numpy())
    acts = {a: rng.standard_normal((256, 3)).astype(np.float32)
            for a, _ in jacts}
    ref = jbt.combine_actions(jacts, {k: jnp.asarray(v)
                                      for k, v in acts.items()}, (256, 3))
    got = tbt.combine_actions(tacts, {k: _t(v) for k, v in acts.items()},
                              torch.zeros(256, 3))
    assert _bits_differ(got.numpy(), ref) == 0


# ------------------------------------------------------------ whole ticks

def configs(n: int = N, **world):
    """The JAX config on its plain XLA sweep (ranges + argsort) and the
    port's slice config on the kernels' plain versions: the two paths
    are bit-identical by contract, and the plain XLA one keeps the test
    fast."""
    extent = float(int((n * 10000 / 12) ** 0.5))
    grid = dict(radius=50.0, extent_x=extent, extent_z=extent, k=32,
                cell_cap=12, row_block=256, topk_impl="sort", skin=0.0,
                precision="off")
    jcfg = jstate.WorldConfig(
        grid=JGrid(sweep_impl="ranges", sort_impl="argsort", **grid),
        capacity=n, npc_speed=5.0, enter_cap=65536, leave_cap=65536,
        sync_cap=65536, attr_sync_cap=4096, input_cap=4096,
        delta_rows_cap=65536, **world)
    tcfg = dataclasses.replace(slice_config(n, row_block=256), **world)
    return jcfg, tcfg


def bench_lanes(jcfg, seed: int = 0):
    """The bench layout from numpy: every slot an alive mover, 1% with
    a client (8 at least), headings in (-7, 7), 64 position syncs."""
    rng = np.random.default_rng(seed)
    n, g = jcfg.capacity, jcfg.grid
    st = jstate.create_state(jcfg, seed=1)
    lanes = {f.name: np.array(getattr(st, f.name))
             for f in dataclasses.fields(st)
             if getattr(st, f.name) is not None}
    lanes["pos"][:, 0] = rng.uniform(0, g.extent_x, n)
    lanes["pos"][:, 2] = rng.uniform(0, g.extent_z, n)
    lanes["yaw"][:] = rng.uniform(-7, 7, n)
    lanes["alive"][:] = True
    lanes["npc_moving"][:] = True
    lanes["has_client"][:] = rng.random(n) < 0.01
    lanes["has_client"][:8] = True
    ic = jcfg.input_cap
    idx = np.zeros(ic, np.int32)
    idx[:64] = rng.choice(n, 64, replace=False)
    vals = np.zeros((ic, 4), np.float32)
    vals[:64, 0] = rng.uniform(0, g.extent_x, 64)
    vals[:64, 2] = rng.uniform(0, g.extent_z, 64)
    vals[:64, 3] = rng.uniform(0, 6, 64)
    inputs = dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.asarray(64, np.int32))
    return lanes, inputs


def run_ticks(jcfg, tcfg, lanes, inputs, jpolicy=None, tpolicy=None,
              ticks: int = TICKS) -> tuple[dict, dict]:
    """``ticks`` ticks of JAX ``make_tick`` and the port's from the same
    state, the port restarted from the JAX state each tick. Returns the
    differing words of each lane summed over the ticks, and gauges."""
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()})
    ji = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    jtick, ttick = jmake_tick(jcfg), make_tick(tcfg, device="cpu")
    diffs: dict = {}
    gauges = {"enter": 0, "sync": 0, "rebuilt": 0}
    for _ in range(ticks):
        ts = interop.state_from_numpy(
            {f.name: np.array(getattr(js, f.name))
             for f in dataclasses.fields(js)
             if getattr(js, f.name) is not None}, device="cpu")
        js, jo = jtick(js, ji, jpolicy)
        ts, to = ttick(ts, ti, tpolicy)
        got = interop.state_to_numpy(ts)
        got.update({f"out.{k}": v
                    for k, v in interop.outputs_to_numpy(to).items()})
        for f in dataclasses.fields(js):
            if getattr(js, f.name) is None or f.name == "aoi_cache":
                continue
            diffs[f.name] = diffs.get(f.name, 0) + _bits_differ(
                got[f.name], np.asarray(getattr(js, f.name)))
        for f in dataclasses.fields(jo):
            if getattr(jo, f.name) is None:
                continue
            key = f"out.{f.name}"
            diffs[key] = diffs.get(key, 0) + _bits_differ(
                got[key], np.asarray(getattr(jo, f.name)))
        gauges["enter"] += int(to.enter_n)
        gauges["sync"] += int(to.sync_n)
        gauges["rebuilt"] += int(to.aoi_rebuilt)
    return {k: v for k, v in diffs.items() if v}, gauges


@pytest.mark.parametrize("case", ["btree", "mlp_h128", "mlp_h16"])
def test_behavior_ticks_match_jax(case):
    behavior = case.split("_")[0]
    hidden = int(case.split("_h")[1]) if "_h" in case else 0
    jcfg, tcfg = configs(behavior=behavior)
    lanes, inputs = bench_lanes(jcfg)
    jp = jpol.init_policy(jax.random.PRNGKey(5), hidden) if hidden \
        else None
    tp = tpol.init_policy(5, hidden, device="cpu") if hidden else None
    diffs, gauges = run_ticks(jcfg, tcfg, lanes, inputs, jp, tp)
    assert gauges["enter"] > 0 and gauges["sync"] > 0
    assert not diffs, diffs


def test_mega_mlp_ticks_match_jax():
    """The 2x2 megaspace under mlp, 4 ticks: the tiles' observations
    from the summary lanes, the mean offset computed at AOI time over
    local and ghost rows."""
    import test_torch_mega as tm

    from goworld_tpu.parallel.mesh import make_mesh
    from goworld_tpu.parallel.step import MultiTickInputs as JMulti

    jmc, tmc = tm._configs(True, "async")
    jmc = dataclasses.replace(jmc, cfg=dataclasses.replace(
        jmc.cfg, behavior="mlp"))
    tmc = dataclasses.replace(tmc, cfg=dataclasses.replace(
        tmc.cfg, behavior="mlp"))
    lanes, inputs = tm._mega_world(jmc)
    lanes["aoi_cache"] = None
    js = tm._jax_state(jmc, lanes)
    ji = JMulti(base=JInputs(**{k: jnp.asarray(v)
                                for k, v in inputs["base"].items()}),
                migrate_target=jnp.asarray(inputs["migrate_target"]),
                migrate_tag=jnp.asarray(inputs["migrate_tag"]))
    ts = interop.state_from_numpy(lanes, device="cpu")
    ti = interop.multi_inputs_from_numpy(inputs, device="cpu")
    jp = jpol.init_policy(jax.random.PRNGKey(5), 128)
    tp = tpol.init_policy(5, 128, device="cpu")
    jtick = tm.jmake(jmc, make_mesh(jmc.n_dev))
    ttick = tm.make_mega_tick(tmc, device="cpu")
    for t in range(4):
        js, jo = jtick(js, ji, jp)
        ts, to = ttick(ts, ti, tp)
        tm._compare(interop.state_to_numpy(ts), tm._jax_lanes(js),
                    f"state {t}")
        ref = tm._jax_lanes(jo)
        ref["base"] = tm._jax_lanes(jo.base)
        tm._compare(interop.mega_outputs_to_numpy(to), ref,
                    f"outputs {t}")
    assert float(np.abs(np.asarray(js.nbr_mean_off)).sum()) > 0


def _mlp_world(pkg, cfg, seed: int):
    """A World of ``cfg`` with 96 Mob movers at seeded positions."""
    w = pkg.World(cfg, seed=seed, **({"device": "cpu"}
                                     if "torch" in pkg.__name__
                                     else {}))

    class Mob(pkg.Entity):
        pass

    class Arena(pkg.Space):
        pass

    w.register_entity("Mob", Mob)
    w.register_space("Arena", Arena)
    w.create_nil_space()
    space = w.create_space("Arena", eid="arena00000000001")
    rng = np.random.default_rng(seed)
    for i in range(96):
        w.create_entity("Mob", space=space, moving=True,
                        eid=f"mob{i:013d}",
                        pos=(float(rng.uniform(0, 100)), 0.0,
                             float(rng.uniform(0, 100))))
    return w


def test_world_mlp_matches_jax():
    """The serving World under behavior='mlp': both Worlds draw the
    policy from their seed and step the same population bit for bit."""
    from goworld_tpu import entity as jent
    from goworld_tpu_torch import entity as tent
    from goworld_tpu_torch.core.state import WorldConfig as TConfig
    from goworld_tpu_torch.ops.aoi import GridSpec as TGrid

    grid = dict(radius=10.0, extent_x=100.0, extent_z=100.0, k=16,
                cell_cap=16)
    jw = _mlp_world(jent, jstate.WorldConfig(
        capacity=128, grid=JGrid(**grid), behavior="mlp"), 7)
    tw = _mlp_world(tent, TConfig(capacity=128, grid=TGrid(**grid),
                                  behavior="mlp"), 7)
    ref = _jax_policy_np(jw.policy)
    got = interop.policy_to_numpy(tw.policy)
    assert all(_bits_differ(got[k], ref[k]) == 0 for k in ref)
    for _ in range(4):
        jw.tick()
        tw.tick()
        for lane in ("pos", "vel", "nbr", "nbr_cnt", "alive"):
            assert _bits_differ(getattr(tw.state, lane).numpy(),
                                np.asarray(getattr(jw.state, lane))) == 0
        assert jw.op_stats["aoi_enter_events"] == \
            tw.op_stats["aoi_enter_events"]
    assert float(np.abs(tw.state.vel.numpy()).sum()) > 0


def test_mega_btree_ticks_match_jax():
    """The 2x2 megaspace under the btree, 4 ticks, each from the JAX
    state: the tree's features from the summary lanes (chase along the
    mean offset)."""
    import test_torch_mega as tm

    from goworld_tpu.parallel.mesh import make_mesh
    from goworld_tpu.parallel.step import MultiTickInputs as JMulti

    jmc, tmc = tm._configs(True, "async")
    jmc = dataclasses.replace(jmc, cfg=dataclasses.replace(
        jmc.cfg, behavior="btree"))
    tmc = dataclasses.replace(tmc, cfg=dataclasses.replace(
        tmc.cfg, behavior="btree"))
    lanes, inputs = tm._mega_world(jmc)
    lanes["aoi_cache"] = None
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
                assert _bits_differ(got[k], ref[k]) == 0, k
        for k, v in interop.outputs_to_numpy(to.base).items():
            assert _bits_differ(v, np.asarray(getattr(jo.base, k))) == 0, k


@pytest.mark.parametrize("hidden", [10, 20, 64])
def test_unmeasured_hidden_size_raises(hidden):
    """XLA's dot orders are read at hidden 16 and 128 only: the policy
    refuses another size rather than guess an order (ROADMAP C4)."""
    with pytest.raises(NotImplementedError, match="Queue C4"):
        tpol.init_policy(5, hidden, device="cpu")
    rng = np.random.default_rng(hidden)
    shapes = ((10, hidden), (hidden,), (hidden, hidden), (hidden,),
              (hidden, 3), (3,))
    pol = tpol.MLPPolicy(*(_t(rng.standard_normal(s).astype(np.float32))
                           .to(torch.bfloat16) for s in shapes))
    obs = _t(rng.standard_normal((8, 10)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="Queue C4"):
        tpol.policy_accel(pol, obs)
