"""The mlp policy's speed cap and the subnormal flush against the JAX
package's jitted tick on the CPU (ROADMAP.md Queue C4; helpers from
``tests/test_torch_behaviors.py``, a file of its own so that a test
worker takes it beside that one's).

The cap: XLA computes ``speed / sqrt(s)`` as ``speed * rsqrt(s)`` with
``vrsqrtps``'s table estimate and two Newton steps
(``ops/xla_order.py`` ``rsqrt_x86``), held on a million values and
through 4 ticks with the cap binding. The flush: the underflow case,
bit for bit, with the port's CPU tick under ``utils/fpenv.py``'s
flush-to-zero scope, at 512 rows and at 16,384 on the intra-op pool;
then under mlp and under the random walk with that scope replaced by a
null context, so that the explicit flushes of the behavior and
integrate stages (``ops/xla_order.py`` ``ftz``, ``round_ftz``, the ops
the card runs too) alone give the JAX bits; and the flush helpers on
float32's edge words against numpy under the scope."""

import contextlib


import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.core import state as jstate
from goworld_tpu.models import npc_policy as jpol
from goworld_tpu_torch.models import npc_policy as tpol

from test_torch_behaviors import (N, _bits_differ, _t, bench_lanes,
                                  configs, run_ticks)

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)


def test_rsqrt_matches_xla_on_random_and_edge_inputs():
    """``rsqrt_x86`` (the CPU's vrsqrtps estimate by table, two Newton
    steps with its fused multiply-adds) inside the speed cap's fusion,
    ``min(1, 5 / sqrt(s + 1e-12))``, against the jitted reference on a
    million values over 42 decades and on edge inputs."""
    from goworld_tpu_torch.ops.xla_order import rsqrt_x86

    rng = np.random.default_rng(0)
    s = (rng.random(1 << 20) * 10.0 ** rng.uniform(-12, 30, 1 << 20)) \
        .astype(np.float32)
    s[:6] = [0.0, 1.0, 4.0, np.inf, 3.4e38, 1e-30]
    ref = np.asarray(jax.jit(
        lambda v: jnp.minimum(1.0, 5.0 / jnp.sqrt(v + 1e-12)))(s))
    x = _t(s) + 1e-12
    got = torch.clamp_max(rsqrt_x86(x) * 5.0, 1.0).numpy()
    assert _bits_differ(got, ref) == 0


@pytest.mark.parametrize("case", ["mlp", "hotspot", "flock", "npc_mix",
                                  "mlp_only"])
def test_speed_cap_binding_matches_jax(case):
    """Speeds at 0.9-1.1 times ``npc_speed`` from the first tick, so the
    cap binds on about half the rows, through the jitted JAX tick and
    the port's CPU tick (the mlp cap through XLA's table rsqrt)."""
    import dataclasses as dc

    from goworld_tpu.scenarios import spec as jspec
    from goworld_tpu_torch.scenarios import spec as tspec

    mixes = {"npc_mix": (("mlp", 0.3), ("btree", 0.3),
                         ("random_walk", 0.4)), "mlp_only": (("mlp", 1.0),)}
    if case == "mlp":
        jcfg, tcfg = configs(behavior="mlp")
    else:
        js_, ts_ = ((jspec.ScenarioSpec(name=case, mix=mixes[case]),
                     tspec.ScenarioSpec(name=case, mix=mixes[case]))
                    if case in mixes else (jspec.get_scenario(case),
                                           tspec.get_scenario(case)))
        jcfg, tcfg = configs(scenario=js_)
        tcfg = dc.replace(tcfg, scenario=ts_)
    lanes, inputs = bench_lanes(jcfg)
    if case != "mlp":
        st = jstate.create_state(jcfg, seed=1)
        lanes["behavior_id"] = np.asarray(st.behavior_id)
        lanes["aoi_radius"] = np.asarray(st.aoi_radius)
    rng = np.random.default_rng(7)
    ang = rng.uniform(0, 2 * np.pi, N)
    mag = rng.uniform(0.9, 1.1, N) * jcfg.npc_speed
    lanes["vel"][:, 0] = (mag * np.cos(ang)).astype(np.float32)
    lanes["vel"][:, 2] = (mag * np.sin(ang)).astype(np.float32)
    pol = case in ("mlp", "npc_mix", "mlp_only")
    diffs, _ = run_ticks(
        jcfg, tcfg, lanes, inputs,
        jpol.init_policy(jax.random.PRNGKey(5), 128) if pol else None,
        tpol.init_policy(5, 128, device="cpu") if pol else None, 4)
    assert not diffs, diffs


def _underflow_data(n: int, behavior: str = "mlp"):
    """``workload.mlp_underflow_case``'s weights as the policy of an mlp
    world of ``n`` rows whose observations are near 1e-38 (positions,
    headings and velocities scaled down; w1's rows of cos(yaw) and the
    neighbor count zeroed): (configs, lanes, inputs, weights); the same
    lanes under ``behavior``."""
    from goworld_tpu_torch import workload

    jcfg, tcfg = configs(n, behavior=behavior)
    lanes, inputs = bench_lanes(jcfg)
    rng = np.random.default_rng(3)
    tiny = np.float32(1e-35)
    for c in (0, 2):
        lanes["pos"][:, c] = rng.uniform(0.1, 0.2, n).astype(np.float32) \
            * tiny
    lanes["yaw"][:] = rng.uniform(0.1, 0.2, n).astype(np.float32) \
        * np.float32(1e-38)
    lanes["vel"][:] = rng.uniform(0.1, 0.2, (n, 3)).astype(np.float32) \
        * np.float32(1e-37)
    inputs["pos_sync_n"] = np.asarray(0, np.int32)
    _, ws = workload.mlp_underflow_case(4, 0, device="cpu")
    ws = list(ws)
    ws[0] = ws[0].clone()
    ws[0][6:8] = 0
    return jcfg, tcfg, lanes, inputs, ws


def _underflow_diffs(n: int, behavior: str = "mlp") -> dict:
    """4 ticks of the jitted JAX tick against the port's on the
    underflow case: the differing words of each lane."""
    jcfg, tcfg, lanes, inputs, ws = _underflow_data(n, behavior)
    if behavior != "mlp":
        return run_ticks(jcfg, tcfg, lanes, inputs, None, None, 4)[0]
    jp = jpol.MLPPolicy(*(jnp.asarray(w.float().numpy())
                          .astype(jnp.bfloat16) for w in ws))
    diffs, _ = run_ticks(jcfg, tcfg, lanes, inputs, jp,
                         tpol.MLPPolicy(*ws), 4)
    return diffs


def test_underflow_world_is_the_tests_data():
    """``workload.underflow_world``, which ``chip_smoke.py`` runs on the
    card against the CPU port, builds this file's underflow case: the
    same config, lanes, inputs and weights, bit for bit."""
    from goworld_tpu_torch import interop, workload

    _, tcfg, lanes, inputs, ws = _underflow_data(N)
    cfg, st, ti, pol = workload.underflow_world(N, device="cpu")
    assert cfg == tcfg
    rcfg, rst, rti, rpol = workload.underflow_world(N, device="cpu",
                                                    behavior="random_walk")
    assert rcfg == dataclasses.replace(tcfg, behavior="random_walk")
    assert rpol is None
    for name, want in interop.state_to_numpy(rst).items():
        assert _bits_differ(want, interop.state_to_numpy(st)[name]) == 0
    for name in inputs:
        assert torch.equal(getattr(rti, name), getattr(ti, name))
    got = interop.state_to_numpy(st)
    for name, want in lanes.items():
        assert _bits_differ(got[name], want) == 0, name
    for name, want in inputs.items():
        assert np.array_equal(getattr(ti, name).numpy(), want), name
    for a, b in zip((pol.w1, pol.b1, pol.w2, pol.b2, pol.w3, pol.b3), ws):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_underflow_case_through_tick_matches_jax():
    """The underflow case at 512 rows: XLA's CPU runtime flushes
    subnormal results and inputs to zero in every float op of the tick,
    and so does the port's CPU tick (``utils/fpenv.py``)."""
    diffs = _underflow_diffs(N)
    assert not diffs, diffs


def _subnormals_kept() -> int:
    """How many of 2^20 products ``1.5e-38 * 0.5`` stay nonzero: every
    one where the threads that compute them keep subnormals."""
    y = torch.full((1 << 20,), 1.5e-38, dtype=torch.float32) * 0.5
    return int((y != 0).sum())


def _on_fresh_thread(fn, threads: int = 1):
    """``fn()``'s result, run on a new thread: one whose intra-op pool
    of ``threads`` threads has not started yet (libgomp keeps a pool a
    master thread)."""
    import threading

    out: dict = {}

    def run():
        try:
            out["v"] = fn()
        except BaseException as exc:  # raised again below
            out["e"] = exc

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=600)
    finally:
        torch.set_num_threads(before)
    assert not t.is_alive()
    if "e" in out:
        raise out["e"]
    return out["v"]


@pytest.mark.parametrize("pool", ["started_before", "started_inside"])
def test_underflow_case_16k_rows_on_the_pool_matches_jax(pool):
    """The underflow case at 16,384 rows, so that ATen splits the
    elementwise ops over the intra-op pool's threads: the flush reaches
    each of them, whether a parallel op started the pool before the
    tick's scope or the scope starts it. After the scope every thread
    keeps subnormals again, as the JAX package and numpy expect."""
    def body():
        if pool == "started_before":
            assert _subnormals_kept() == 1 << 20
        diffs = _underflow_diffs(16384)
        return diffs, _subnormals_kept()

    diffs, kept = _on_fresh_thread(body, threads=4)
    assert not diffs, diffs
    assert kept == 1 << 20


def test_flush_scope_is_scoped():
    """Inside ``fpenv.flushed()`` every thread of the pool flushes; on
    exit the caller, its pool and numpy keep subnormals as before."""
    from goworld_tpu_torch.utils import fpenv

    def body():
        before = _subnormals_kept()
        with fpenv.flushed():
            inside = _subnormals_kept()
            with fpenv.flushed("cpu"):
                nested = _subnormals_kept()
            after_nested = _subnormals_kept()
        a = np.full(1 << 10, 1.5e-38, np.float32) * np.float32(0.5)
        return before, inside, nested, after_nested, \
            _subnormals_kept(), int((a != 0).sum())

    assert _on_fresh_thread(body, threads=4) == \
        (1 << 20, 0, 0, 0, 1 << 20, 1 << 10)


@pytest.mark.parametrize("rows", [N, 16384])
@pytest.mark.parametrize("behavior", ["mlp", "random_walk"])
@pytest.mark.parametrize("scope", ["fpenv", "null"])
def test_underflow_world_flushes_explicitly(scope, behavior, rows,
                                            monkeypatch):
    """``workload.underflow_world`` and its random-walk twin, 4 ticks,
    bit for bit against the jitted JAX tick: under ``fpenv.flushed`` as
    the tick runs, and with that scope replaced by a null context, so
    that the behavior and integrate stages' explicit flushes alone (the
    ops the card runs) give XLA's flushed bits."""
    from goworld_tpu_torch.core import step

    if scope == "null":
        monkeypatch.setattr(step, "flushed",
                            lambda *a: contextlib.nullcontext())
    diffs = _on_fresh_thread(lambda: _underflow_diffs(rows, behavior))
    assert not diffs, diffs


def _edge_words() -> np.ndarray:
    """float32 edge words: +-2^-126, the largest and smallest subnormal
    of each sign, +-0.0, NaN, +-inf, the largest finite and a few
    ordinary values."""
    bits = np.array([0x00800000, 0x80800000, 0x007FFFFF, 0x807FFFFF,
                     0x00000001, 0x80000001, 0x00400000, 0x0, 0x80000000,
                     0x7FC00000, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
                     0x3F800000, 0xBF000001, 0x00800001], np.uint32)
    return bits.view(np.float32)


def test_flush_helpers_on_edge_words():
    """``ftz`` on float32's edge words equals numpy's ``x * 1`` under the
    flush scope (DAZ reads a subnormal as a zero of its sign); products
    and quotients by ``mul32``/``div32`` and ``round_ftz`` of float64
    values equal numpy's float32 ops under the scope, at the tininess
    edge too: an exact value just below 2^-126 that rounds up to it is
    kept (x86 detects tininess after rounding), one that rounds to the
    float32 below it is flushed; signs kept."""
    from goworld_tpu_torch.ops import xla_order as xo
    from goworld_tpu_torch.utils import fpenv

    x = _edge_words()
    tiny = np.float32(2.0 ** -126)
    # products whose exact value sits at the edge: (1 - 2^-24) * 2^-126
    # rounds to 2^-126 - 2^-150 (flushed); (1 - 2^-25) * 2^-126 is the
    # tie, which rounds to 2^-126 (kept); just above and below it
    a = np.array([1 - 2.0 ** -24, 1 - 2.0 ** -25, 1 - 2.0 ** -25
                  + 2.0 ** -48, 1 - 2.0 ** -25 - 2.0 ** -48, 0.75, 1.5],
                 np.float64)
    pa = np.float32(1 + 2.0 ** -23) * np.ones(6, np.float32)
    pb = (a / (1 + 2.0 ** -23) * 2.0 ** -126).astype(np.float32)
    d64 = np.concatenate([a * 2.0 ** -126, -a * 2.0 ** -126,
                          [2.0 ** -126 - 2.0 ** -151,
                           2.0 ** -126 - 2.0 ** -151 - 2.0 ** -170]])

    def body():
        with fpenv.flushed():
            got = (xo.ftz(torch.from_numpy(x)).numpy(),
                   xo.mul32(torch.from_numpy(pa), torch.from_numpy(pb))
                   .numpy(),
                   xo.div32(torch.from_numpy(pb), torch.from_numpy(pa))
                   .numpy(),
                   xo.round_ftz(torch.from_numpy(d64)).numpy(),
                   xo.mul32(torch.from_numpy(-pa), torch.from_numpy(pb))
                   .numpy())
        return got

    got = _on_fresh_thread(body)
    with np.errstate(all="ignore"):
        # numpy's own float32 ops under the processor's flush mode
        with _numpy_flushed():
            want = (x * np.float32(1.0), pa * pb, pb / pa,
                    d64.astype(np.float32), -pa * pb)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
    # the edge itself: kept at the tie, flushed below it
    r = got[3]
    assert r[1] == tiny and r[0] == 0 and r[-2] == tiny and r[-1] == 0
    assert np.signbit(got[0][[1, 3, 5, 8]]).all()
    assert (got[0][[2, 3, 4, 5, 6]] == 0).all()


@contextlib.contextmanager
def _numpy_flushed():
    """FTZ and DAZ on the calling thread, for numpy's float ops."""
    from goworld_tpu_torch.utils import fpenv

    _, libm, _ = fpenv._libs()
    import ctypes

    saved = ctypes.create_string_buffer(fpenv._FENV_BYTES)
    assert libm.fegetenv(saved) == 0
    flush = ctypes.create_string_buffer(fpenv._flushing(saved.raw),
                                        fpenv._FENV_BYTES)
    assert libm.fesetenv(flush) == 0
    try:
        yield
    finally:
        libm.fesetenv(saved)
