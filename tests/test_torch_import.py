"""The port package stands alone: it imports neither JAX nor the JAX
package, its entry points run on the card unless asked for the CPU, and
configs it does not run yet are refused rather than substituted."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from goworld_tpu_torch.core import state as tstate
from goworld_tpu_torch.core.step import TickInputs, make_tick
from goworld_tpu_torch.models.npc_policy import init_policy
from goworld_tpu_torch.ops.aoi import GridSpec, grid_neighbors
from goworld_tpu_torch.parallel.megaspace import (
    MegaConfig,
    create_mega_state,
    make_mega_tick,
)
from goworld_tpu_torch.parallel.mesh import make_mesh
from goworld_tpu_torch.parallel.step import MultiTickInputs
from goworld_tpu_torch.scenarios.spec import get_scenario

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "goworld_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
)
# msgpack is not installed where the port runs: its payloads go through
# utils/mpack.py
FORBIDDEN = ("jax", "jaxlib", "flax", "goworld_tpu", "msgpack")


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'goworld_tpu', 'msgpack'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_import_alone_loads_and_builds_nothing():
    """``import goworld_tpu_torch`` imports none of its modules: no
    kernel build, no torch, no JAX."""
    res = _run(
        "import sys\n"
        "import goworld_tpu_torch\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('goworld_tpu_torch', 'torch',\n"
        "                                     'jax', 'goworld_tpu'))\n"
        "print(mods)\n"
        "sys.exit(0 if mods == ['goworld_tpu_torch'] else 1)\n")
    assert res.returncode == 0, res.stdout + res.stderr


def test_facade_resolution_leaves_jax_out_and_builds_nothing():
    """The lazy facade's names (``gw.run``, ``gw.Entity``, ``gw.config``,
    ``gw.net``, ``gw.storage``) resolve through the port alone: no JAX,
    no JAX package, no msgpack, and no kernel library loaded."""
    res = _run(
        "import sys\n"
        "import goworld_tpu_torch as gw\n"
        "assert callable(gw.run) and gw.Entity is gw.api.Entity\n"
        "gw.config, gw.net, gw.storage, gw.kvdb, gw.register_entity\n"
        "import goworld_tpu_torch.net.game, goworld_tpu_torch.net.gate\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'goworld_tpu', 'msgpack'))\n"
        "from goworld_tpu_torch import kernels\n"
        "built = kernels.lib.cache_info().currsize\n"
        "print(bad, built)\n"
        "sys.exit(1 if bad or built else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    [str(p.relative_to(ROOT)) for p in sorted(PKG.rglob("*.py"))]
    + ["chip_smoke.py", "examples/megaspace_demo/server_torch.py"],
)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


CFG = tstate.WorldConfig(capacity=64, grid=GridSpec(radius=10.0, k=8,
                                                    cell_cap=4))


def _mega(**world):
    cfg = tstate.WorldConfig(
        capacity=64, grid=GridSpec(radius=10.0, extent_x=80.0,
                                   extent_z=80.0, k=8, cell_cap=4),
        **world)
    return MegaConfig(cfg=cfg, n_dev=4, tile_w=60.0, mesh_shape=(2, 2),
                      tile_d=60.0, halo_impl="async")


@pytest.mark.parametrize("entry", ["create_state", "make_tick",
                                   "inputs_empty", "create_mega_state",
                                   "make_mega_tick", "multi_inputs_empty",
                                   "make_mesh"])
def test_entry_points_default_to_cuda_and_never_fall_back(entry,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "create_state": lambda **kw: tstate.create_state(CFG, **kw),
        "make_tick": lambda **kw: make_tick(CFG, **kw),
        "inputs_empty": lambda **kw: TickInputs.empty(CFG, **kw),
        "create_mega_state": lambda **kw: create_mega_state(_mega(), **kw),
        "make_mega_tick": lambda **kw: make_mega_tick(_mega(), **kw),
        "multi_inputs_empty": lambda **kw: MultiTickInputs.empty(
            CFG, 4, **kw),
        "make_mesh": lambda **kw: make_mesh(4, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    call(device="cpu")  # the CPU only when asked for


@pytest.mark.parametrize("change", [
    dict(grid=GridSpec(radius=10.0, skin=2.0)),
    dict(grid=GridSpec(radius=10.0, precision="q16")),
    dict(grid=GridSpec(radius=10.0, sweep_impl="table")),
    dict(grid=GridSpec(radius=10.0, sweep_impl="cellrow")),
    dict(grid=GridSpec(radius=10.0, sweep_impl="shift")),
    dict(grid=GridSpec(radius=10.0, topk_impl="approx")),
    dict(behavior="mlp"),
    dict(behavior="btree"),
    dict(scenario=get_scenario("mixed")),
    dict(grid=GridSpec(radius=10.0, precision="q16"), behavior="mlp"),
    dict(capacity=1 << 21),
], ids=["skin", "q16", "table", "cellrow", "shift", "approx", "mlp",
        "btree", "scenario", "q16_mlp", "wide_id"])
def test_unported_configs_raise_not_implemented(change):
    """Each config the port does not run raises NotImplementedError
    naming ROADMAP: the wide-id sweep (capacity >= 2^21), refused by the
    first stage every sweep impl shares, so each impl raises. The
    Verlet skin, precision=q16, the table, cellrow and shift sweeps, the
    approx top-k, the mlp and btree behaviors, scenario worlds and q16
    with the mlp policy were refused until they were ported; their cases
    now hold that both entry points take them and that a tick runs."""
    if change.get("capacity", 0) >= 1 << 21:
        n = change["capacity"]
        for impl in ("ranges", "fused", "table", "cellrow", "shift"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                grid_neighbors(GridSpec(radius=10.0, sweep_impl=impl),
                               torch.zeros(n, 3),
                               torch.ones(n, dtype=torch.bool))
        return
    cfg = tstate.WorldConfig(capacity=64, **change)
    st = tstate.create_state(cfg, device="cpu")
    pol = init_policy(5, 16, device="cpu") \
        if cfg.behavior == "mlp" else None
    st, out = make_tick(cfg, device="cpu")(
        st, TickInputs.empty(cfg, device="cpu"), pol)
    assert int(out.aoi_rebuilt) == 1 and int(st.tick) == 1
    assert (st.behavior_id is None) == (cfg.scenario is None)


@pytest.mark.parametrize("case", ["scenario", "mlp", "btree", "devices",
                                  "q16"])
@pytest.mark.parametrize("entry", ["create_mega_state", "make_mega_tick"])
def test_unported_megaspace_configs_raise_not_implemented(case, entry):
    kw = {}
    if case == "q16":
        mc = _mega()
        mc = dataclasses.replace(mc, cfg=dataclasses.replace(
            mc.cfg, grid=dataclasses.replace(mc.cfg.grid,
                                             precision="q16")))
    elif case == "scenario":
        mc = _mega(scenario=get_scenario("flock"))
    elif case == "devices":
        mc = _mega()
        kw = dict(devices=["cuda:0", "cuda:1"])
    else:
        mc = _mega(behavior=case)
    fn = create_mega_state if entry == "create_mega_state" \
        else make_mega_tick
    if case in ("scenario", "mlp", "btree"):
        # refused until the behaviors were ported: both entry points now
        # take them and a tick runs
        st = create_mega_state(mc, device="cpu")
        pol = init_policy(5, 16, device="cpu") if case == "mlp" else None
        st, _ = make_mega_tick(mc, device="cpu")(
            st, MultiTickInputs.empty(mc.cfg, mc.n_dev, device="cpu"), pol)
        assert int(st.tick[0]) == 1
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(mc, device="cpu", **kw)


def test_stacked_spaces_raise_not_implemented():
    """Stacked Spaces were refused until the batched step was ported;
    the case now holds that a stacked state ticks in one call with
    ``[S]`` outputs, that a state stacked in one lane only is rejected,
    and that the skin is refused on a batched state (the World clears
    it, as the JAX package's vmapped step does)."""
    from goworld_tpu_torch.parallel.mesh import create_multi_state
    from goworld_tpu_torch.parallel.step import MultiTickInputs

    st = create_multi_state(CFG, 2, device="cpu")
    inputs = MultiTickInputs.empty(CFG, 2, device="cpu").base
    st2, out = make_tick(CFG, device="cpu")(st, inputs)
    assert tuple(out.enter_n.shape) == (2,)
    assert st2.tick.tolist() == [1, 1]
    one = tstate.create_state(CFG, device="cpu")
    with pytest.raises(RuntimeError):
        make_tick(CFG, device="cpu")(
            one.replace(pos=one.pos[None].repeat(2, 1, 1)),
            TickInputs.empty(CFG, device="cpu"))
    skin = dataclasses.replace(CFG, grid=dataclasses.replace(
        CFG.grid, skin=2.0))
    with pytest.raises(ValueError, match="skin"):
        make_tick(skin, device="cpu")(st, inputs)


# modules the tick runs; none may make the host wait on the card
TICK_MODULES = ["core/step.py", "models/random_walk.py", "ops/aoi.py",
                "ops/batch.py", "ops/delta.py", "ops/extract.py", "ops/integrate.py",
                "ops/prng.py", "ops/sort.py", "ops/sync.py",
                "parallel/halo.py", "parallel/migrate.py",
                "parallel/megaspace.py", "parallel/mesh.py",
                "parallel/step.py", "ops/telemetry.py"]
# host-side helpers outside the tick (the telemetry lanes' init and
# drain and its numpy recompute)
EXEMPT = {"neighbors_oracle", "prng_key", "telemetry_init",
          "telemetry_drain", "host_histogram"}
SYNCING = {"item", "cpu", "numpy", "tolist", "nonzero", "tensor"}


@pytest.mark.parametrize("path", TICK_MODULES)
def test_tick_modules_never_wait_on_the_card(path):
    tree = ast.parse((PKG / path).read_text())
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name in EXEMPT:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                assert node.func.attr not in SYNCING, (
                    path, fn.name, node.func.attr, node.lineno)


@pytest.mark.parametrize("kept, whole", [
    ([], False),
    ([True], False),
    ([True, True], True),                       # calls with no device work
    ([True, True, False, False, True], True),   # nothing lost
    ([True, False, False, True], True),         # part of the lead lost
    ([False, False, True], False),              # the lead and a call lost
    ([True, False, False], False),              # the last marker lost
    ([True, False, True, False], True),         # a side stream's late event
    ([True, False, True, False, True], False),  # a marker amid the calls
])
def test_profiled_read_keeps_only_whole_sessions(kept, whole):
    """``kernels.device_ms`` keeps a profiler session only where the lead
    markers absorbed any loss at its start and the last marker shows."""
    from goworld_tpu_torch import kernels
    assert kernels.whole_session(kept) is whole
