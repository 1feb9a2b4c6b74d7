"""The port's precision="q16" plane against the JAX package's, on the
CPU: the counterparts of ``tests/test_precision.py``'s lattice, sweep,
Verlet and tick cases.

The lattice step is a power of two and the cell edge a power-of-two
multiple of it, so every equality here is exact: the snap, the packed
``(qx << 16) | qz`` plane, its distances (equal to the float32
distances over the snapped world), the 21-bit id triplets (the JAX
uint32 words, held by the port as int32 bits), the q16 sweep under
each sweep/sort pair the port runs, the q16 Verlet rebuild and reuse,
the tick's lattice dead band and its bfloat16 velocity lane, carried
through ``interop`` by its 16-bit pattern. Worlds of 500 entities, a
64-slot tick. (The delta-sync codec cases belong to the net stack,
which the port does not have yet.)
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.core.step import make_tick as jmake_tick
from goworld_tpu.ops import aoi as jaoi
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.core.step import TickInputs, make_tick
from goworld_tpu_torch.ops import aoi as taoi

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 500
EXTENT = 300.0
RADIUS = 25.0
SKIN = 7.5


def _world(seed=5):
    rng = np.random.default_rng(seed)
    pos = np.zeros((N, 3), np.float32)
    pos[:, 0] = rng.random(N) * EXTENT
    pos[:, 1] = rng.random(N)
    pos[:, 2] = rng.random(N) * EXTENT
    alive = rng.random(N) < 0.92
    fb = rng.integers(0, 4, N).astype(np.int32)
    pos2 = pos.copy()
    step = np.clip(rng.normal(0.0, 1.0, (N, 2)), -SKIN / 2 + 0.1,
                   SKIN / 2 - 0.1).astype(np.float32)
    pos2[:, 0] = np.clip(pos[:, 0] + step[:, 0], 0, EXTENT - 1e-3)
    pos2[:, 2] = np.clip(pos[:, 2] + step[:, 1], 0, EXTENT - 1e-3)
    return pos, pos2, alive, fb


POS, POS2, ALIVE, FB = _world()


def _kw(sweep_impl, precision="q16", skin=0.0, **kw):
    return dict(radius=RADIUS, extent_x=EXTENT, extent_z=EXTENT, k=64,
                cell_cap=28, row_block=256, sweep_impl=sweep_impl,
                skin=skin, verlet_cap=128, precision=precision, **kw)


def _specs(*a, **kw):
    return jaoi.GridSpec(**_kw(*a, **kw)), taoi.GridSpec(**_kw(*a, **kw))


def _eq(got, ref):
    """Bit for bit; uint32 words are compared as int32 bits, bfloat16
    lanes as their 16-bit patterns."""
    if isinstance(got, torch.Tensor):
        got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        got = got.numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    got, ref = (a.view(np.int32) if a.dtype == np.uint32 else
                a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a
                for a in (got, ref))
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    assert np.array_equal(np.atleast_1d(got).view(np.uint8),
                          np.atleast_1d(ref).view(np.uint8))


def _sets(nbr):
    nbr = np.asarray(nbr)
    return [set(r[r < N].tolist()) for r in nbr]


JQ, TQ = _specs("ranges")


def test_quant_step_is_power_of_two_and_covers_extent():
    for name in ("quant_step", "quant_cell_shift", "quant_bits",
                 "cell_size", "cells_x", "cells_z"):
        assert getattr(TQ, name) == getattr(JQ, name), name
    m, _e = math.frexp(TQ.quant_step)
    assert m == 0.5
    assert TQ.quant_step * (1 << 15) >= EXTENT
    assert TQ.quant_step <= RADIUS / 4.0
    assert TQ.cell_size >= TQ.radius + TQ.skin
    sk = _specs("ranges", skin=SKIN)
    assert sk[1].cell_size == sk[0].cell_size >= RADIUS + SKIN


def test_snap_is_idempotent_and_exact():
    snapped = taoi.quantize_positions(TQ, torch.tensor(POS))
    _eq(snapped, jaoi.quantize_positions(JQ, jnp.asarray(POS)))
    assert torch.equal(taoi.quantize_positions(TQ, snapped), snapped)
    assert torch.equal(snapped[:, 1], torch.tensor(POS[:, 1]))
    q = snapped[:, 0].numpy() / TQ.quant_step
    assert np.array_equal(q, np.round(q))
    off = taoi.GridSpec(**_kw("ranges", precision="off"))
    assert taoi.quantize_positions(off, snapped) is snapped


def test_packed_xz_plane_and_distance():
    """The packed plane equals JAX's, and its Chebyshev distances
    times the step equal the float32 distances over the snapped world,
    bitwise, for every pair."""
    qxz = taoi.quantize_xz_i32(TQ, torch.tensor(POS))
    _eq(qxz, jaoi.quantize_xz_i32(JQ, jnp.asarray(POS)))
    d = taoi._q16_dist(TQ, qxz[:, None], qxz[None, :])
    _eq(d, jaoi._q16_dist(JQ, jnp.asarray(qxz.numpy())[:, None],
                          jnp.asarray(qxz.numpy())[None, :]))
    sp = taoi.quantize_positions(TQ, torch.tensor(POS))
    d32 = torch.maximum((sp[:, None, 0] - sp[None, :, 0]).abs(),
                        (sp[:, None, 2] - sp[None, :, 2]).abs())
    assert torch.equal(d, d32)


@pytest.mark.parametrize("v", [1, 2, 3, 7, 48, 128])
def test_pack_ids21_round_trip_and_words_match_jax(v):
    rng = np.random.default_rng(v)
    ids = rng.integers(0, (1 << 21) - 1, (5, v)).astype(np.int32)
    ids[0, :] = (1 << 21) - 1          # every bit set: word 0's sign bit
    ids[1, : min(v, 3)] = 0
    words = taoi.pack_ids21(torch.tensor(ids), N)
    assert words.shape == (5, taoi.packed_cand_words(v)) == \
        (5, jaoi.packed_cand_words(v))
    _eq(words, jaoi.pack_ids21(jnp.asarray(ids), N))
    up = taoi.unpack_ids21(words)
    _eq(up, jaoi.unpack_ids21(jaoi.pack_ids21(jnp.asarray(ids), N)))
    assert np.array_equal(up[:, :v].numpy(), ids)
    assert bool((up[:, v:] == N).all())


def test_precision_validation_messages():
    with pytest.raises(ValueError, match=r"off\|q16"):
        taoi.GridSpec(**_kw("ranges", precision="fp8"))
    with pytest.raises(ValueError, match=r"origin-free"):
        taoi.GridSpec(radius=RADIUS, origin_x=10.0, extent_x=EXTENT,
                      extent_z=EXTENT, precision="q16")
    with pytest.raises(ValueError, match=r"radius/4"):
        taoi.GridSpec(radius=2.0, extent_x=1 << 18, extent_z=1 << 18,
                      precision="q16")


@pytest.mark.parametrize("sort_impl", ["argsort", "pallas"])
@pytest.mark.parametrize("sweep_impl", ["ranges", "fused", "shift",
                                        "cellrow", "approx"])
def test_q16_sweep_matches_jax(sweep_impl, sort_impl):
    """grid_neighbors_flags under q16 with the gauges: the port's lists,
    counts, flags and gauges equal JAX's, and the snapped oracle's."""
    kw = dict(sort_impl=sort_impl)
    if sweep_impl == "approx":
        sweep_impl, kw["topk_impl"] = "ranges", "approx"
    js, ts = _specs(sweep_impl, **kw)
    ref = jaoi.grid_neighbors_flags(
        js, jnp.asarray(POS), jnp.asarray(ALIVE),
        flag_bits=jnp.asarray(FB), with_stats=True)
    got = taoi.grid_neighbors_flags(
        ts, torch.tensor(POS), torch.tensor(ALIVE),
        flag_bits=torch.tensor(FB), with_stats=True)
    for g, r in zip(got[:3], ref[:3]):
        _eq(g, r)
    for g, r in zip(got[3], ref[3]):
        _eq(g, r)
    spos = taoi.quantize_positions(ts, torch.tensor(POS)).numpy()
    oracle = taoi.neighbors_oracle(spos, ALIVE, RADIUS)
    assert _sets(got[0]) == [o if a else set()
                             for o, a in zip(oracle, ALIVE)]


def test_q16_equals_f32_sweep_over_snapped_positions():
    """q16 on raw positions == q16 on pre-snapped ones (the snap is
    idempotent) == precision off over the snapped positions (another
    cell geometry, the same exact lists while no cap overflows)."""
    p = torch.tensor(POS)
    a, f = torch.tensor(ALIVE), torch.tensor(FB)
    q = taoi.grid_neighbors_flags(TQ, p, a, flag_bits=f, with_stats=True)
    sp = taoi.quantize_positions(TQ, p)
    s = taoi.grid_neighbors_flags(TQ, sp, a, flag_bits=f)
    off = taoi.GridSpec(**_kw("ranges", precision="off"))
    o = taoi.grid_neighbors_flags(off, sp, a, flag_bits=f)
    assert int(q[3][1]) == 0 and int(q[3][3]) == 0
    for x, y, z in zip(q[:3], s, o):
        assert torch.equal(x, y) and torch.equal(x, z)


def _verlet_pair(spec_j, spec_t, pos, alive, cj, ct):
    jo = jaoi.grid_neighbors_verlet(
        spec_j, jnp.asarray(pos), jnp.asarray(alive), cj,
        flag_bits=jnp.asarray(FB), with_stats=True)
    to = taoi.grid_neighbors_verlet(
        spec_t, torch.tensor(pos), torch.tensor(alive), ct,
        flag_bits=torch.tensor(FB), with_stats=True)
    for g, r in zip(to[:3], jo[:3]):
        _eq(g, r)
    for g, r in zip(to[3], jo[3]):
        _eq(g, r)
    for name in ("cand", "ref_x", "ref_z", "ref_alive", "ref_radius",
                 "age", "valid", "cell_max", "over_cap_cells",
                 "over_v_rows"):
        _eq(getattr(to[4], name), getattr(jo[4], name))
    _eq(to[5], jo[5])
    _eq(to[6], jo[6])
    return jo, to


@pytest.mark.parametrize("sort_impl", ["argsort", "counting"])
@pytest.mark.parametrize("sweep_impl", ["ranges", "fused", "shift",
                                        "cellrow"])
def test_q16_verlet_rebuild_and_reuse_exact(sweep_impl, sort_impl):
    """The packed-cand Verlet path under q16: a cold rebuild and a reuse
    tick equal JAX's in every output and cache lane and the snapped
    oracle; the reuse tick reused; the gauges stay zero."""
    js, ts = _specs(sweep_impl, skin=SKIN, sort_impl=sort_impl)
    cj, ct = jaoi.init_verlet_cache(js, N), \
        taoi.init_verlet_cache(ts, N, "cpu")
    assert ct.cand.dtype == torch.int32 and cj.cand.dtype == jnp.uint32
    _eq(ct.cand, cj.cand)
    jo, to = _verlet_pair(js, ts, POS, ALIVE, cj, ct)
    assert int(to[5]) == 1
    jo, to = _verlet_pair(js, ts, POS2, ALIVE, jo[4], to[4])
    assert int(to[5]) == 0
    assert int(to[3][1]) == 0 and int(to[3][3]) == 0
    spos = taoi.quantize_positions(ts, torch.tensor(POS2)).numpy()
    oracle = taoi.neighbors_oracle(spos, ALIVE, RADIUS)
    assert _sets(to[0]) == [o if a else set()
                            for o, a in zip(oracle, ALIVE)]


def test_q16_verlet_rebuild_triggers_still_fire():
    js, ts = _specs("ranges", skin=SKIN)
    jo, to = _verlet_pair(js, ts, POS, ALIVE,
                          jaoi.init_verlet_cache(js, N),
                          taoi.init_verlet_cache(ts, N, "cpu"))
    alive2 = ALIVE.copy()
    alive2[int(np.flatnonzero(ALIVE)[0])] = False
    jo, to = _verlet_pair(js, ts, POS, alive2, jo[4], to[4])
    assert int(to[5]) == 1
    pos3 = POS.copy()
    j = int(np.flatnonzero(alive2)[0])
    pos3[j, 0] = (pos3[j, 0] + EXTENT / 2) % EXTENT
    jo, to = _verlet_pair(js, ts, pos3, alive2, jo[4], to[4])
    assert int(to[5]) == 1


def _lanes(obj):
    out = {}
    for f in obj.__dataclass_fields__:
        v = getattr(obj, f)
        if v is None:
            continue
        if hasattr(v, "__dataclass_fields__"):
            out[f] = _lanes(v)
        else:
            out[f] = v
    return out


def _same_lanes(got: dict, ref: dict, what):
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for k, g in got.items():
        if isinstance(g, dict):
            _same_lanes(g, ref[k], f"{what}.{k}")
        else:
            _eq(g, ref[k])


def test_q16_tick_deadbands_sub_step_motion():
    """A mover under one lattice step a tick is clean (no sync record),
    a mover of four steps syncs; both packages agree on every lane of
    the state (the bfloat16 velocity included) and the outputs."""
    grid = dict(radius=30.0, extent_x=256.0, extent_z=256.0, k=16,
                cell_cap=32, precision="q16")
    world = dict(capacity=64, dt=1.0, adaptive_extract=True)
    jcfg = jstate.WorldConfig(grid=jaoi.GridSpec(**grid), **world)
    tcfg = tstate.WorldConfig(grid=taoi.GridSpec(**grid), **world)
    js = jstate.create_state(jcfg, seed=0)
    ts = tstate.create_state(tcfg, seed=0, device="cpu")
    assert ts.vel.dtype == torch.bfloat16 and js.vel.dtype == jnp.bfloat16
    for slot, kw in ((0, dict(pos=(100.0, 0.0, 100.0), has_client=True,
                              client_gate=1)),
                     (1, dict(pos=(105.0, 0.0, 100.0), npc_moving=True)),
                     (2, dict(pos=(200.0, 0.0, 200.0), has_client=True,
                              client_gate=1)),
                     (3, dict(pos=(205.0, 0.0, 200.0), npc_moving=True))):
        js = jstate.spawn(js, slot, **kw)
        ts = tstate.spawn(ts, slot, **kw)
    step = tcfg.grid.quant_step
    vel = np.zeros((64, 3), np.float32)
    vel[1, 0] = step / 8.0
    vel[3, 0] = step * 4.0
    js = js.replace(vel=jnp.asarray(vel).astype(jnp.bfloat16))
    ts = ts.replace(vel=torch.tensor(vel).to(torch.bfloat16))
    jtick, ttick = jmake_tick(jcfg), make_tick(tcfg, device="cpu")
    ji, ti = JInputs.empty(jcfg), TickInputs.empty(tcfg, device="cpu")
    for t in range(3):
        js, jo = jtick(js, ji, None)
        ts, to = ttick(ts, ti)
        _same_lanes(interop.state_to_numpy(ts), _lanes(js), f"state {t}")
        _same_lanes(interop.outputs_to_numpy(to), _lanes(jo),
                    f"outputs {t}")
    subs = set(to.sync_j[:int(to.sync_n)].tolist())
    assert 3 in subs and 1 not in subs
    assert ts.vel.dtype == torch.bfloat16


def test_bf16_vel_rounds_to_nearest_even_and_crosses_interop():
    """``.to(torch.bfloat16)`` rounds as JAX's ``astype`` (nearest,
    ties to even: the tie words are built on purpose), and a q16 state
    crosses ``interop`` both ways with its bfloat16 lane's bits."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 50, 4096).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:512] = (bits[:512] & 0xFFFF0000) | 0x8000     # exact ties
    bits[512:600] = (bits[512:600] & 0xFFFF0000) | 0x7FFF
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    got = torch.tensor(x).to(torch.bfloat16)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          ref.view(np.int16))
    grid = dict(radius=30.0, extent_x=256.0, extent_z=256.0, k=16,
                cell_cap=32, precision="q16", skin=2.0)
    jcfg = jstate.WorldConfig(capacity=64, grid=jaoi.GridSpec(**grid))
    js = jstate.create_state(jcfg, seed=2)
    js = js.replace(vel=jnp.asarray(x[:192].reshape(64, 3))
                    .astype(jnp.bfloat16))
    lanes = {k: v for k, v in _lanes(js).items()}
    lanes = {k: ({c: np.asarray(a) for c, a in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in lanes.items()}
    ts = interop.state_from_numpy(lanes, device="cpu")
    assert ts.vel.dtype == torch.bfloat16
    assert ts.aoi_cache.cand.dtype == torch.int32
    back = interop.state_to_numpy(ts)
    assert back["vel"].dtype == ml_dtypes.bfloat16
    assert back["aoi_cache"]["cand"].dtype == np.uint32
    _same_lanes(back, lanes, "round trip")


@pytest.mark.parametrize("case", ["skin0", "skin4", "spaces3"])
def test_q16_mlp_ticks_match_jax(case):
    """precision="q16" under the mlp policy (hidden 128), 6 ticks of 512
    rows a Space: the policy's float32 velocity stored into the
    bfloat16 carry as the JAX tick stores it, on one Space at skin 0
    and at skin 4 (the q16 Verlet cache), and on 3 Spaces' ``[S, ...]``
    lanes against the JAX World's vmapped step; every lane of the state
    (the cache included) and the outputs bit for bit."""
    import dataclasses

    import jax

    from goworld_tpu.entity.manager import _make_local_tick as jlocal
    from goworld_tpu.models import npc_policy as jpol
    from goworld_tpu_torch.models import npc_policy as tpol
    from test_torch_behaviors import bench_lanes, configs

    skin = 4.0 if case == "skin4" else 0.0
    spaces = 3 if case == "spaces3" else 0
    jcfg, tcfg = configs(512, behavior="mlp")
    jcfg, tcfg = (dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, precision="q16", skin=skin)) for c in (jcfg, tcfg))
    plain = dataclasses.replace(jcfg, grid=dataclasses.replace(
        jcfg.grid, skin=0.0))
    worlds = [bench_lanes(plain, seed=d) for d in range(max(spaces, 1))]
    if spaces:
        for d, (lanes, _) in enumerate(worlds):
            lanes["rng"] = np.array([0, d + 11], np.uint32)
        lanes = {k: np.stack([w[0][k] for w in worlds]) for k in worlds[0][0]}
        inputs = {k: np.stack([w[1][k] for w in worlds])
                  for k in worlds[0][1]}
        js = jstate.SpaceState(**{k: jnp.asarray(v)
                                  for k, v in lanes.items()})
        jtick = jlocal(jcfg, spaces)
    else:
        lanes, inputs = worlds[0]
        js = jstate.create_state(jcfg, seed=1).replace(
            **{k: jnp.asarray(v) for k, v in lanes.items()})
        jtick = jmake_tick(jcfg)
    assert js.vel.dtype == jnp.bfloat16
    ts = interop.state_from_numpy(
        {k: ({c: np.asarray(a) for c, a in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in _lanes(js).items()}, device="cpu")
    ji = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    ttick = make_tick(tcfg, device="cpu")
    jp = jpol.init_policy(jax.random.PRNGKey(5), 128)
    tp = tpol.init_policy(5, 128, device="cpu")
    for t in range(6):
        js, jo = jtick(js, ji, jp)
        ts, to = ttick(ts, ti, tp)
        _same_lanes(interop.state_to_numpy(ts), _lanes(js), f"state {t}")
        _same_lanes(interop.outputs_to_numpy(to), _lanes(jo),
                    f"outputs {t}")
    assert ts.vel.dtype == torch.bfloat16
    assert bool((ts.vel != 0).any())


def test_q16_aoi_view_snaps_the_rounded_integrate():
    """Under q16 XLA recomputes the integrate inside each fusion that
    snaps it (the sweep's lattice, the sync records, the moved test),
    where the moving select keeps the product ``vel * dt`` apart from
    the add, while the stored position contracts it: 512 random-walk
    movers at lattice edges ``x = B`` with a carried velocity of
    ``-60 * 2^-17`` (``vel * dt`` rounds to ``-2^-17``, half the ulp of
    x, a tie that rounds back to B, while the fused sum rounds below B)
    snap to other cells from the two, and the port equals JAX bit for
    bit over 2 ticks."""
    import dataclasses

    from test_torch_behaviors import bench_lanes, configs, run_ticks

    jcfg, tcfg = configs(512)
    jcfg, tcfg = (dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, precision="q16")) for c in (jcfg, tcfg))
    step, dt = jcfg.grid.quant_step, np.float32(jcfg.dt)
    lanes, inputs = bench_lanes(jcfg)
    rng = np.random.default_rng(1)
    x = (step * rng.integers(int(130 / step), int(250 / step), 512)) \
        .astype(np.float32)
    vx = np.float32(-60 * 2.0 ** -17)
    fused = (x.astype(np.float64) + float(vx) * float(dt)).astype(np.float32)
    rounded = x + np.float32(vx * dt)
    assert (np.floor(fused / step) != np.floor(rounded / step)).all()
    lanes["pos"][:, 0] = x
    lanes["vel"][:] = 0
    lanes["vel"][:, 0] = np.full(512, vx, np.float32) \
        .astype(ml_dtypes.bfloat16)
    inputs["pos_sync_n"] = np.asarray(0, np.int32)
    diffs, gauges = run_ticks(jcfg, tcfg, lanes, inputs, None, None, 2)
    assert gauges["enter"] > 0
    assert not diffs, diffs
