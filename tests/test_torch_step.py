"""The port's whole tick against the JAX package's: the slice config
(fused sweep + counting sort, random walk, skin 0, precision off) at
capacity 1024, with the world carried across by the interop converter,
for 5 ticks of JAX make_tick against the port's make_tick on the CPU.

Every lane of the state and outputs (the rng key and the float lanes
included) must be bit-exact: the port's random walk computes XLA's cos
and sin (glibc's routine), and its integration rounds ``pos + vel*dt``
once, as XLA's fused multiply-add does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.core.step import TickInputs as JInputs
from goworld_tpu.core.step import make_tick as jmake_tick
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import interop
from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.core.step import TickInputs, make_tick
from goworld_tpu_torch.workload import slice_config

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

N = 1024
TICKS = 5


def _configs(n=N):
    """The JAX config as bench.py builds it (skin 0, fused + pallas) and
    the port's workload config; every field must agree."""
    extent = float(int((n * 10000 / 12) ** 0.5))
    grid = dict(radius=50.0, extent_x=extent, extent_z=extent, k=32,
                cell_cap=12, row_block=256, sweep_impl="fused",
                sort_impl="pallas", topk_impl="sort", skin=0.0,
                precision="off")
    world = dict(capacity=n, npc_speed=5.0, enter_cap=65536,
                 leave_cap=65536, sync_cap=65536, attr_sync_cap=4096,
                 input_cap=4096, delta_rows_cap=65536)
    jcfg = jstate.WorldConfig(grid=JGrid(**grid), **world)
    tcfg = slice_config(n, row_block=256)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _jax_lanes(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _bench_world(cfg, seed=0):
    """bench.py's layout from numpy: every slot an alive mover, 1% with
    a client, some dirty hot attrs; 64 position syncs to distinct
    slots in a 4096-record batch."""
    rng = np.random.default_rng(seed)
    n, g = cfg.capacity, cfg.grid
    lanes = _jax_lanes(jstate.create_state(cfg, seed=1))
    lanes["pos"][:, 0] = rng.uniform(0, g.extent_x, n)
    lanes["pos"][:, 2] = rng.uniform(0, g.extent_z, n)
    lanes["alive"][:] = True
    lanes["npc_moving"][:] = True
    lanes["has_client"][:] = rng.random(n) < 0.01
    lanes["has_client"][:8] = True
    lanes["hot_attrs"][:] = rng.random((n, cfg.attr_width))
    lanes["attr_dirty"][rng.random(n) < 0.05] = 0x80000005
    ic = cfg.input_cap
    idx = np.zeros(ic, np.int32)
    idx[:64] = rng.choice(n, 64, replace=False)
    vals = np.zeros((ic, 4), np.float32)
    vals[:64, 0] = rng.uniform(0, g.extent_x, 64)
    vals[:64, 2] = rng.uniform(0, g.extent_z, 64)
    vals[:64, 3] = rng.uniform(0, 6, 64)
    inputs = dict(pos_sync_idx=idx, pos_sync_vals=vals,
                  pos_sync_n=np.asarray(64, np.int32))
    return lanes, inputs


def _compare(got: dict, ref: dict, what):
    assert got.keys() <= ref.keys(), what
    for name, g in got.items():
        r = ref[name]
        assert g.shape == r.shape and g.dtype == r.dtype, (what, name)
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(r).view(np.uint8)), (what, name)


def test_slice_ticks_match_jax():
    jcfg, tcfg = _configs()
    lanes, inputs = _bench_world(jcfg)
    js = jstate.SpaceState(**{k: jnp.asarray(v) for k, v in lanes.items()})
    ji = JInputs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    ts = interop.state_from_numpy(lanes, device="cpu")
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    jtick, ttick = jmake_tick(jcfg), make_tick(tcfg, device="cpu")
    enters = []
    for t in range(TICKS):
        js, jo = jtick(js, ji, None)
        ts, to = ttick(ts, ti)
        _compare(interop.state_to_numpy(ts), _jax_lanes(js), f"state {t}")
        _compare(interop.outputs_to_numpy(to), _jax_lanes(jo),
                 f"outputs {t}")
        enters.append(int(to.enter_n))
    assert enters[0] > 0 and int(to.sync_n) > 0 and int(to.attr_n) == 0


def test_spawn_despawn_and_ticks_match_jax():
    jcfg, tcfg = _configs(256)
    js = jstate.create_state(jcfg, seed=5)
    ts = tstate.create_state(tcfg, seed=5, device="cpu")
    _compare(interop.state_to_numpy(ts), _jax_lanes(js), "created")
    spawns = [
        dict(slot=3, pos=(10.0, 1.0, 12.0), npc_moving=True),
        dict(slot=4, pos=(30.0, 0.0, 15.0), has_client=True,
             client_gate=2, yaw=1.5, type_id=7),
        dict(slot=9, pos=(12.0, 0.0, 40.0), aoi_radius=20.0,
             hot_attrs=np.arange(8, dtype=np.float32)),
        dict(slot=10, pos=(500.0, 0.0, 500.0), npc_moving=True),
    ]
    for kw in spawns:
        js = jstate.spawn(js, **kw)
        ts = tstate.spawn(ts, **kw)
    jtick, ttick = jmake_tick(jcfg), make_tick(tcfg, device="cpu")
    jin, tin = JInputs.empty(jcfg), TickInputs.empty(tcfg, device="cpu")
    for t in range(3):
        if t == 1:
            js, ts = jstate.despawn(js, 9), tstate.despawn(ts, 9)
        js, jo = jtick(js, jin, None)
        ts, to = ttick(ts, tin)
        _compare(interop.state_to_numpy(ts), _jax_lanes(js), f"state {t}")
        _compare(interop.outputs_to_numpy(to), _jax_lanes(jo),
                 f"outputs {t}")


@pytest.mark.parametrize("seed", [0, 3])
def test_state_round_trip(seed):
    jcfg, _ = _configs(128)
    lanes, inputs = _bench_world(jcfg, seed)
    lanes["rng"] = np.asarray(jax.random.PRNGKey(2**31 - 7 + seed))
    back = interop.state_to_numpy(
        interop.state_from_numpy(lanes, device="cpu"))
    assert back.keys() == {k for k, v in lanes.items() if v is not None}
    for name, a in back.items():
        assert a.dtype == lanes[name].dtype and a.shape == \
            lanes[name].shape, name
        assert np.array_equal(a, lanes[name]), name
    ti = interop.inputs_from_numpy(inputs, device="cpu")
    for name, a in inputs.items():
        assert np.array_equal(getattr(ti, name).numpy(), a)
    # the scenario lane was refused until scenario worlds were ported;
    # it now crosses both ways
    bid = np.arange(128, dtype=np.int32) % 3
    back = interop.state_to_numpy(interop.state_from_numpy(
        dict(lanes, behavior_id=bid), device="cpu"))
    assert back["behavior_id"].dtype == np.int32
    assert np.array_equal(back["behavior_id"], bid)
