"""The port's pipelined decode (``World(pipeline_decode=True)``) on the
CPU: the decode of tick N runs after the step of tick N + 1, so host
events arrive one tick late but none is lost. After a final
``flush_pending_outputs()`` the pipelined World equals the eager one in
sinks, hooks, interest sets and state; tick by tick it equals the JAX
package's pipelined World under the same script (explicit entity ids).
Capacity 96 (48 for the churn), one Space and two."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from goworld_tpu import entity as jent
from goworld_tpu.core.state import WorldConfig as JConfig
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu_torch import entity as tent
from goworld_tpu_torch import interop
from goworld_tpu_torch.core.state import WorldConfig as TConfig
from goworld_tpu_torch.ops.aoi import GridSpec as TGrid
from goworld_tpu_torch.utils import ids

GRID = dict(radius=12.0, extent_x=200.0, extent_z=200.0, k=16,
            cell_cap=32, topk_impl="sort")


def _config(pkg: str, n: int, spaces: int = 1):
    world = dict(capacity=n, npc_speed=20.0, turn_prob=0.3, enter_cap=2048,
                 leave_cap=2048, sync_cap=2048, attr_sync_cap=64,
                 input_cap=n, delta_rows_cap=n)
    if pkg == "jax":
        return JConfig(grid=JGrid(row_block=n, sweep_impl="ranges",
                                  sort_impl="argsort", **GRID), **world)
    return TConfig(grid=TGrid(row_block=n, sweep_impl="fused",
                              sort_impl="pallas", **GRID), **world)


def build(pkg: str, pipeline: bool, n: int = 96, spaces: int = 1,
          planes: bool = False):
    """A World of ``spaces`` Arenas, ``n - 16`` movers a Space, every
    ninth with a client; returns (world, entities, sent messages, hook
    log). Entity ids are fixed, so the two packages' Worlds agree."""
    mod = jent if pkg == "jax" else tent
    log: list = []

    class Npc(mod.Entity):
        ATTRS = {"name": "allclients"}

        def OnEnterAOI(self, other):
            log.append(("enter", self.id, other.id))

        def OnLeaveAOI(self, other):
            log.append(("leave", self.id, other.id))

    class Arena(mod.Space):
        pass

    kw = {} if pkg == "jax" else dict(device="cpu")
    if not planes:
        kw.update(telemetry_live=False, residency=False, audit=False)
    world = mod.World(_config(pkg, n), n_spaces=spaces, seed=5,
                      pipeline_decode=pipeline, **kw)
    sent: list = []
    world.client_sink = lambda g, c, m: sent.append(
        (c, m["type"], m.get("eid")))
    world.register_space("Arena", Arena)
    world.register_entity("Npc", Npc)
    world.create_nil_space()
    rng = np.random.default_rng(4)
    ents = []
    for s in range(spaces):
        arena = world.create_space(
            "Arena", eid=ids.gen_fixed_id(f"pipe.arena.{s}"))
        pts = rng.uniform(20, 180, size=(n - 16, 2))
        for i in range(n - 16):
            client = mod.GameClient(1, f"CL{s:02d}{i:08d}", world) \
                if i % 9 == 0 else None
            ents.append(world.create_entity(
                "Npc", space=arena, pos=(pts[i, 0], 0.0, pts[i, 1]),
                moving=True, client=client,
                eid=ids.gen_fixed_id(f"pipe.{s}.{i}")))
    return world, ents, sent, log


def interest(ents) -> dict:
    return {e.id: (frozenset(e.interested_in), frozenset(e.interested_by))
            for e in ents if not e.destroyed}


def churn(world, ents, ticks: int, seed: int = 9) -> list:
    """Destroys and creates a tick on a small World, so slots are
    reused; returns the live entities."""
    rng = np.random.default_rng(seed)
    alive = list(ents)
    for t in range(ticks):
        if len(alive) > 8:
            world.destroy_entity(alive.pop(int(rng.integers(len(alive)))))
        alive.append(world.create_entity(
            "Npc", space=alive[0].space,
            pos=(float(rng.uniform(20, 180)), 0.0,
                 float(rng.uniform(20, 180))),
            moving=True, eid=ids.gen_fixed_id(f"pipe.churn.{seed}.{t}")))
        world.tick()
    return alive


@pytest.mark.parametrize("spaces", [1, 2])
def test_pipelined_equals_eager_after_drain(spaces):
    wa, ea, sa, la = build("port", False, spaces=spaces)
    wb, eb, sb, lb = build("port", True, spaces=spaces)
    for _ in range(12):
        wa.tick()
        wb.tick()
    wb.flush_pending_outputs()
    assert wb._pending_outs is None
    assert interest(ea) == interest(eb)
    assert sorted(sa) == sorted(sb) and sorted(la) == sorted(lb)
    a, b = interop.state_to_numpy(wa.state), interop.state_to_numpy(wb.state)
    for k in a:
        if not isinstance(a[k], dict):
            assert np.array_equal(a[k], b[k]), k


def test_pipeline_lags_exactly_one_tick():
    """A pipelined World one step ahead of an eager twin has decoded
    exactly what the twin has, every tick."""
    wa, ea, sa, _ = build("port", False)
    wb, eb, sb, _ = build("port", True)
    n0 = len(sb)
    wb.tick()
    assert wb._pending_outs is not None and wb.last_outputs is None
    assert all(not e.interested_in for e in eb) and len(sb) == n0
    for _ in range(4):
        wa.tick()
        wb.tick()
        assert interest(eb) == interest(ea) and sorted(sb) == sorted(sa)
    wb.flush_pending_outputs()
    wa.tick()
    assert interest(eb) == interest(ea) and sorted(sb) == sorted(sa)


@pytest.mark.parametrize("spaces", [1, 2])
def test_pipelined_sinks_match_jax_pipelined(spaces):
    """Tick by tick: the same client messages in the same order, the
    same hooks and interest sets as the JAX pipelined World."""
    wj, ej, sj, lj = build("jax", True, spaces=spaces)
    wt, et, st, lt = build("port", True, spaces=spaces)
    for _ in range(8):
        wj.tick()
        wt.tick()
        assert st == sj and lt == lj
        assert interest(et) == interest(ej)
    wj.flush_pending_outputs()
    wt.flush_pending_outputs()
    assert st == sj and lt == lj and interest(et) == interest(ej)


def test_pipelined_churn_with_slot_reuse_matches_eager_and_jax():
    """Destroys and creates every tick on 48 slots: a destroyed entity's
    slot must not free before its leave events decode, one tick later
    under pipelining."""
    out = {}
    for key, pkg, pipe in (("eager", "port", False),
                           ("pipe", "port", True),
                           ("jax", "jax", True)):
        w, ents, sent, log = build(pkg, pipe, n=48)
        alive = churn(w, ents, 16)
        w.flush_pending_outputs()
        out[key] = (interest(alive), sorted(sent), sorted(log))
    assert out["pipe"] == out["eager"] == out["jax"]


def test_outputs_are_not_carry_lanes():
    """The resident carry writes the state's lanes in place each tick;
    the pipelined copy of a tick's outputs must never read one of them
    (no output lane shares storage with a state lane), and the carry
    keeps every lane's address under pipelining."""
    w, _, _, _ = build("port", True)
    w.tick()
    carry = set()

    def ptrs(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            if dataclasses.is_dataclass(v):
                ptrs(v)
            else:
                carry.add(v.untyped_storage().data_ptr())

    ptrs(w.state)
    before = set(carry)
    _, outs = w._step(w.state, w._flush_staging(), w.policy)
    for f in dataclasses.fields(outs):
        v = getattr(outs, f.name)
        if v is not None:
            assert v.untyped_storage().data_ptr() not in carry, f.name
    w.tick()
    carry.clear()
    ptrs(w.state)
    assert carry == before


def test_pipelined_world_at_defaults_skips_audit_samples():
    """The planes at their defaults under pipelining: the audit records
    a ``pipeline_decode`` skip for every sample tick, the telemetry
    lanes drain one tick late and the anchor follows the outputs."""
    w, _, _, _ = build("port", True, planes=True)
    w.audit.sample_every = 2
    for _ in range(6):
        w.tick()
    w.audit.drain()
    assert w.audit.oracle_stats["skipped"].get("pipeline_decode") == 3
    assert w._telem_lanes is not None
    assert w.sync_age_anchor[0] == w.tick_count - 2


def test_pipelining_turned_on_and_off_between_ticks():
    """The knob is read each tick: a World eager for 3 ticks, pipelined
    for 4, drained and eager for 3 more ends where an eager twin does."""
    wa, ea, sa, la = build("port", False)
    wb, eb, sb, lb = build("port", False)
    for t in range(10):
        if t == 3:
            wb.pipeline_decode = True
        if t == 7:
            wb.flush_pending_outputs()
            wb.pipeline_decode = False
        wa.tick()
        wb.tick()
    assert interest(ea) == interest(eb)
    assert sorted(sa) == sorted(sb) and sorted(la) == sorted(lb)
    a, b = interop.state_to_numpy(wa.state), interop.state_to_numpy(wb.state)
    for k in a:
        if not isinstance(a[k], dict):
            assert np.array_equal(a[k], b[k]), k
