"""The port's ``make_multi_tick`` against the JAX package's on the CPU.

The JAX step runs each shard's ``tick_body`` under ``shard_map`` on the
8 simulated CPU devices (``tests/conftest.py``), then packs emigrants,
exchanges them with ``all_to_all`` and reduces ``alive`` with ``psum``.
The port runs the same shards on one device: batched without a skin,
one after another with one (each shard keeps its own Verlet cache), the
exchange a transpose of the stacked send buffers.

The same numpy-seeded shards go through both for 8 ticks, with
migration requests every tick, some into a shard kept full so that
``migrate_dropped`` is positive. Every state lane and every output lane
(``arr_tag``/``arr_slot``/``arr_n``, ``migrate_demand``,
``migrate_dropped`` and ``global_alive`` included) must be bit-exact,
floats included, at 2, 4 and 8 shards, under the random walk, the btree,
the mlp policy (hidden 16 and 128) and a scenario, at skin 0 and 4.

On this JAX (0.9) the reference's ``make_multi_tick`` does not trace
where the shard body branches (the skin's rebuild ``lax.cond``, a
scenario's ``lax.switch``): ``shard_map``'s replication check rejects
the branches' output types. Those cases hold the port to the
reference's shard body under ``shard_map`` with the check off
(``parallel/mesh.py`` ``shard_map_norep``, as the reference's async
halo runs), :func:`_jax_multi_norep`, line for line the reference's
``make_multi_tick``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.core.step import tick_body as jtick_body
from goworld_tpu.parallel import migrate as jmig
from goworld_tpu.parallel.mesh import SPACE_AXIS, shard_map_norep
from goworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from goworld_tpu.parallel.step import MultiTickOutputs as JOutputs
from goworld_tpu.parallel.step import MultiTickInputs as JMulti
from goworld_tpu.parallel.step import make_multi_tick as jmake_multi
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.parallel.mesh import make_mesh, shard_state
from goworld_tpu_torch.parallel.step import (
    MultiTickOutputs,
    batched_shards,
    make_multi_tick,
)

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 128
TICKS = 8
MCAP = 8
FULL = 1  # the shard kept full: arrivals there are dropped


def _configs(behavior="random_walk", skin=0.0, scenario=None,
             impl=("fused", "pallas")):
    """The JAX config on its plain XLA sweep (``ranges``/``argsort``:
    its Pallas kernels do not trace under ``shard_map`` on the CPU) and
    the port's on ``impl`` (the kernels' plain versions on the CPU):
    the two paths are bit-identical by contract."""
    extent = float(int((N * 10000 / 12) ** 0.5))
    grid = dict(radius=50.0, extent_x=extent, extent_z=extent, k=32,
                cell_cap=12, row_block=64, topk_impl="sort", skin=skin,
                precision="off")
    world = dict(capacity=N, npc_speed=5.0, enter_cap=1024,
                 leave_cap=1024, sync_cap=2048, attr_sync_cap=256,
                 input_cap=64, delta_rows_cap=N, behavior=behavior)
    jscn = tscn = None
    if scenario is not None:
        from goworld_tpu.scenarios.spec import get_scenario as jget
        from goworld_tpu_torch.scenarios.spec import get_scenario as tget
        jscn, tscn = jget(scenario), tget(scenario)
    jcfg = jstate.WorldConfig(
        grid=JGrid(sweep_impl="ranges", sort_impl="argsort", **grid),
        scenario=jscn, **world)
    tcfg = tstate.WorldConfig(
        grid=TGrid(sweep_impl=impl[0], sort_impl=impl[1], **grid),
        scenario=tscn, **world)
    return jcfg, tcfg


def _jax_lanes(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out[f.name] = _jax_lanes(v) if dataclasses.is_dataclass(v) \
            else np.array(v)
    return out


def _shards(jcfg, n_dev: int, seed: int = 0):
    """n_dev seeded shards, stacked: about 3/4 of each shard's slots
    alive movers (shard FULL all of them), 1% with a client, 16 position
    syncs each."""
    rng = np.random.default_rng(seed)
    g = jcfg.grid
    lanes, inputs = [], []
    for d in range(n_dev):
        st = _jax_lanes(jstate.create_state(jcfg, seed=d + 1))
        st["rng"] = np.array([0, d + 11], np.uint32)
        st["pos"][:, 0] = rng.uniform(0, g.extent_x, N)
        st["pos"][:, 2] = rng.uniform(0, g.extent_z, N)
        st["yaw"][:] = rng.uniform(-3, 3, N)
        alive = np.ones(N, bool) if d == FULL else rng.random(N) < 0.75
        st["alive"][:] = alive
        st["npc_moving"][:] = alive
        st["has_client"][:] = alive & (rng.random(N) < 0.01)
        st["has_client"][:2] = alive[:2]
        st["hot_attrs"][:] = rng.random((N, jcfg.attr_width))
        st["type_id"][:] = rng.integers(0, 5, N)
        lanes.append(st)
        ic = jcfg.input_cap
        idx = np.zeros(ic, np.int32)
        idx[:16] = rng.choice(np.flatnonzero(alive), 16, replace=False)
        vals = np.zeros((ic, 4), np.float32)
        vals[:16, 0] = rng.uniform(0, g.extent_x, 16)
        vals[:16, 2] = rng.uniform(0, g.extent_z, 16)
        vals[:16, 3] = rng.uniform(0, 6, 16)
        inputs.append(dict(pos_sync_idx=idx, pos_sync_vals=vals,
                           pos_sync_n=np.asarray(16, np.int32)))

    def stack(items):
        out = {}
        for k, v in items[0].items():
            out[k] = stack([x[k] for x in items]) if isinstance(v, dict) \
                else np.stack([x[k] for x in items])
        return out

    return stack(lanes), stack(inputs)


def _requests(rng, n_dev: int):
    """Migration requests of one tick: 6 slots a shard to another shard
    (one of them always to the full shard), tags unique."""
    tgt = np.full((n_dev, N), -1, np.int32)
    tag = np.full((n_dev, N), -1, np.int32)
    t = 0
    for d in range(n_dev):
        slots = rng.choice(N, 6, replace=False)
        for i, sl in enumerate(slots):
            dst = FULL if i == 0 and d != FULL else int(
                rng.integers(0, n_dev))
            if dst == d:
                continue
            tgt[d, sl] = dst
            tag[d, sl] = t
            t += 1
    return tgt, tag


def _bits_equal(got: dict, ref: dict, what):
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for name, g in got.items():
        r = ref[name]
        if isinstance(r, dict):
            _bits_equal(g, r, f"{what} {name}")
            continue
        assert g.shape == r.shape and g.dtype == r.dtype, (
            what, name, g.shape, r.shape, g.dtype, r.dtype)
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(r).view(np.uint8)), (
            what, name, int((g != r).sum()))


def _jax_multi_norep(cfg, mesh, migrate_cap):
    """The reference's ``make_multi_tick`` with ``shard_map``'s
    replication check off: the same shard body, line for line."""
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.devices.size

    def shard_fn(state, inputs, policy):
        state = jax.tree.map(lambda x: x[0], state)
        inputs = jax.tree.map(lambda x: x[0], inputs)
        state, outs = jtick_body(cfg, state, inputs.base, policy)
        fbuf, ibuf, departed, demand = jmig.pack_emigrants(
            state, inputs.migrate_target, inputs.migrate_tag,
            n_dev, migrate_cap)
        state = jmig.despawn_departed(state, departed)
        fbuf = jax.lax.all_to_all(fbuf, SPACE_AXIS, split_axis=0,
                                  concat_axis=0, tiled=True)
        ibuf = jax.lax.all_to_all(ibuf, SPACE_AXIS, split_axis=0,
                                  concat_axis=0, tiled=True)
        state, arr_tag, arr_slot, arr_n, dropped = jmig.insert_arrivals(
            state, fbuf, ibuf, nbr_sentinel=cfg.capacity,
            quarantine=departed)
        global_alive = jax.lax.psum(state.alive.sum().astype(jnp.int32),
                                    SPACE_AXIS)
        outputs = JOutputs(base=outs, arr_tag=arr_tag, arr_slot=arr_slot,
                           arr_n=arr_n, migrate_dropped=dropped,
                           migrate_demand=demand,
                           global_alive=global_alive)
        return (jax.tree.map(lambda x: x[None], state),
                jax.tree.map(lambda x: x[None], outputs))

    return jax.jit(shard_map_norep(
        shard_fn, mesh=mesh,
        in_specs=(P(SPACE_AXIS), P(SPACE_AXIS), P()),
        out_specs=(P(SPACE_AXIS), P(SPACE_AXIS))))


def _multi_outputs(o) -> dict:
    out = {f.name: np.array(getattr(o, f.name))
           for f in dataclasses.fields(o) if f.name != "base"}
    out["base"] = _jax_lanes(o.base)
    return out


CASES = [
    (2, "random_walk", 0.0, None, None),
    (2, "random_walk", 0.0, None, "ranges"),
    (4, "random_walk", 0.0, None, None),
    (8, "random_walk", 0.0, None, None),
    (4, "random_walk", 4.0, None, None),
    (8, "random_walk", 4.0, None, None),
    (2, "btree", 0.0, None, None),
    (4, "btree", 4.0, None, None),
    (2, "mlp", 0.0, 16, None),
    (2, "mlp", 0.0, 128, None),
    (4, "mlp", 4.0, 16, None),
    (4, "random_walk", 0.0, None, "mixed"),
]


@pytest.mark.parametrize(
    "n_dev,behavior,skin,hidden,scenario", CASES,
    ids=[f"d{c[0]}-{c[1]}{'' if c[3] is None else c[3]}"
         f"{'' if c[4] is None else '-' + c[4]}-skin{int(c[2])}"
         for c in CASES])
def test_multi_tick_matches_jax(n_dev, behavior, skin, hidden, scenario):
    impl = ("fused", "pallas")
    if scenario == "ranges":   # the port on its plain sweep and sort too
        scenario, impl = None, ("ranges", "argsort")
    jcfg, tcfg = _configs(behavior, skin, scenario, impl)
    lanes, inputs = _shards(jcfg, n_dev)
    if scenario is not None:
        st = [jstate.create_state(jcfg, seed=d + 1) for d in range(n_dev)]
        lanes["behavior_id"] = np.stack([np.asarray(s.behavior_id)
                                         for s in st])
        lanes["aoi_radius"] = np.stack([np.asarray(s.aoi_radius)
                                        for s in st])
    jp = tp = None
    if hidden is not None or (scenario is not None
                              and jcfg.scenario.needs_policy):
        from goworld_tpu.models import npc_policy as jpol
        from goworld_tpu_torch.models import npc_policy as tpol
        jp = jpol.init_policy(jax.random.PRNGKey(5), hidden or 16)
        tp = tpol.init_policy(5, hidden or 16, device="cpu")

    if skin == 0.0 and scenario is None:
        jstep = jmake_multi(jcfg, jmake_mesh(n_dev), migrate_cap=MCAP)
    else:
        jstep = _jax_multi_norep(jcfg, jmake_mesh(n_dev), MCAP)
    mesh = make_mesh(n_dev, device="cpu")
    tstep = make_multi_tick(tcfg, mesh, migrate_cap=MCAP)
    assert batched_shards(tcfg) == (skin == 0.0)

    def jlanes(d):
        return {k: (jstate.VerletCache(**{c: jnp.asarray(x)
                                         for c, x in v.items()})
                    if isinstance(v, dict) else jnp.asarray(v))
                for k, v in d.items()}

    js = jstate.SpaceState(**jlanes(lanes))
    ts = shard_state(interop.state_from_numpy(lanes, device="cpu"), mesh)
    jbase = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    tbase = interop.inputs_from_numpy(inputs, device="cpu")
    rng = np.random.default_rng(99)
    dropped = arrived = 0
    for t in range(TICKS):
        tgt, tag = _requests(rng, n_dev)
        js, jo = jstep(js, JMulti(base=jbase,
                                  migrate_target=jnp.asarray(tgt),
                                  migrate_tag=jnp.asarray(tag)), jp)
        ts, to = tstep(ts, interop.multi_inputs_from_numpy(
            dict(base=inputs, migrate_target=tgt, migrate_tag=tag),
            device="cpu"), tp)
        assert isinstance(to, MultiTickOutputs)
        _bits_equal(interop.state_to_numpy(ts), _jax_lanes(js),
                    f"state tick {t}")
        _bits_equal(interop.mega_outputs_to_numpy(to), _multi_outputs(jo),
                    f"outputs tick {t}")
        dropped += int(to.migrate_dropped.sum())
        arrived += int(to.arr_n.sum())
    assert dropped > 0 and arrived > 0
    assert int(to.global_alive[0]) == int(ts.alive.sum())
    assert bool((to.base.enter_n > 0).any())


def test_mesh_over_several_cards_raises():
    """Shards on several cards are not ported: a mesh naming two raises
    ``NotImplementedError`` naming ROADMAP.md; one card names all."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(2, devices=["cuda:0", "cuda:1"])
    m = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert m.devices.size == 3 and m.device == torch.device("cpu")
