"""The port's tick ops against the JAX package's on the same numpy
inputs, exactly: input scatter (repeated slots included), integration
(against the jitted reference, whose pos + vel*dt is one fused
multiply-add), the random walk and its cos and sin (every heading it
can draw), interest deltas and pair extraction, sync records and attr
deltas, including counts past their caps."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.ops import delta as jdelta
from goworld_tpu.ops import extract as jextract
from goworld_tpu.models import random_walk as jwalk
from goworld_tpu.ops import integrate as jint
from goworld_tpu.ops import sync as jsync
from goworld_tpu_torch.models import random_walk as twalk
from goworld_tpu_torch.ops import delta as tdelta
from goworld_tpu_torch.ops import extract as textract
from goworld_tpu_torch.ops import integrate as tint
from goworld_tpu_torch.ops import sync as tsync

N, K = 300, 8


def _eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    else:
        assert np.array_equal(got, ref)


def _nbr_lists(rng, rows=N, fill=0.6):
    """Sorted, sentinel-padded (N), duplicate-free neighbor rows."""
    out = np.full((rows, K), N, np.int32)
    for i in range(rows):
        m = rng.binomial(K, fill)
        out[i, :m] = np.sort(rng.choice(N, m, replace=False))
    return out


@pytest.mark.parametrize("n_inputs", [0, 17, 40, 64])
def test_apply_pos_inputs(n_inputs):
    rng = np.random.default_rng(n_inputs)
    pos = rng.uniform(0, 100, (N, 3)).astype(np.float32)
    yaw = rng.uniform(0, 6, N).astype(np.float32)
    idx = rng.choice(N, 64, replace=False).astype(np.int32)
    idx[3] = -5       # out-of-range records are dropped
    idx[9] = N + 2
    vals = rng.uniform(0, 100, (64, 4)).astype(np.float32)
    n_in = np.asarray(n_inputs, np.int32)
    ref = jint.apply_pos_inputs(jnp.asarray(pos), jnp.asarray(yaw),
                                jnp.asarray(idx), jnp.asarray(vals),
                                jnp.asarray(n_in))
    got = tint.apply_pos_inputs(torch.tensor(pos), torch.tensor(yaw),
                                torch.tensor(idx), torch.tensor(vals),
                                torch.tensor(n_in))
    for g, r in zip(got, ref):
        _eq(g, r)


def test_apply_pos_inputs_keeps_the_last_of_repeated_slots():
    """4096 records onto 512 slots: every slot named ~8 times, records
    past n_inputs and out-of-range slots among them; the last valid
    record of each slot wins, as in the JAX scatter on the CPU."""
    n, ic = 512, 4096
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    yaw = rng.uniform(0, 6, n).astype(np.float32)
    idx = rng.integers(-16, n + 16, ic).astype(np.int32)
    vals = rng.uniform(0, 100, (ic, 4)).astype(np.float32)
    for n_in in (4096, 3000):
        args = (pos, yaw, idx, vals, np.asarray(n_in, np.int32))
        ref = jint.apply_pos_inputs(*map(jnp.asarray, args))
        got = tint.apply_pos_inputs(*map(torch.tensor, args))
        for g, r in zip(got, ref):
            _eq(g, r)
        last = {}
        for i in range(n_in):
            if 0 <= idx[i] < n:
                last[int(idx[i])] = i
        slots = np.array(sorted(last))
        assert np.array_equal(got[0].numpy()[slots],
                              vals[[last[s] for s in slots], :3])
        assert len(slots) < n_in


def test_integrate_clamps_to_the_world():
    """Bit for bit against the jitted reference: XLA contracts
    pos + vel*dt into one fused multiply-add, rounded once."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 101, (N, 3)).astype(np.float32)
    vel = rng.uniform(-50, 50, (N, 3)).astype(np.float32)
    moving = rng.random(N) < 0.7
    args = (1.0 / 60, (0.0, -1e9, 0.0), (100.0, 1e9, 100.0))
    ref = jax.jit(jint.integrate, static_argnums=(3, 4, 5))(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(moving), *args)
    got = tint.integrate(torch.tensor(pos), torch.tensor(vel),
                         torch.tensor(moving), *args)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


@pytest.mark.parametrize("dt", [1.0 / 60, 0.05])
def test_integrate_is_one_rounding_at_scale(dt):
    """2^16 random rows, 90% moving, positions across a bench-sized
    world: every word equals the jitted reference's."""
    n = 1 << 16
    rng = np.random.default_rng(12)
    pos = rng.uniform(-1, 9363, (n, 3)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    moving = rng.random(n) < 0.9
    args = (dt, (0.0, -1e9, 0.0), (9362.0, 1e9, 9362.0))
    ref = jax.jit(jint.integrate, static_argnums=(3, 4, 5))(
        pos, vel, moving, *args)
    got = tint.integrate(torch.tensor(pos), torch.tensor(vel),
                         torch.tensor(moving), *args)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


def _headings() -> np.ndarray:
    """Every heading random_walk_step can draw: the 2^23 uniforms of
    jax.random (k * 2^-23) times float32(2*pi)."""
    u = (np.arange(1 << 23, dtype=np.float64) * 2.0 ** -23) \
        .astype(np.float32)
    return u * np.float32(2.0 * math.pi)


@pytest.mark.parametrize("domain", ["headings", "wide"])
def test_cos_sin_are_xla_bits(domain):
    """The port's cos and sin against jax.jit(jnp.cos / jnp.sin) on the
    CPU: all 2^23 headings, and 2^22 uniform floats in [0, 100)."""
    if domain == "headings":
        h = _headings()
    else:
        h = np.random.default_rng(13).uniform(0, 100, 1 << 22) \
            .astype(np.float32)
    c, s = twalk.cos_sin(torch.from_numpy(h))
    _eq(c, jax.jit(jnp.cos)(h))
    _eq(s, jax.jit(jnp.sin)(h))


@pytest.mark.parametrize("still", [False, True])
def test_random_walk_step_is_bit_exact(still):
    """The jitted reference step on 2^14 movers (or still ones, which
    all draw a heading)."""
    n = 1 << 14
    rng = np.random.default_rng(14)
    key = jax.random.PRNGKey(21)
    vel = np.zeros((n, 3), np.float32) if still else \
        rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    moving = rng.random(n) < 0.9
    ref = jax.jit(jwalk.random_walk_step, static_argnums=(3, 4))(
        key, vel, moving, 5.0, 0.05)
    tkey = torch.tensor(np.asarray(key).astype(np.int64))
    got = twalk.random_walk_step(tkey, torch.tensor(vel),
                                 torch.tensor(moving), 5.0, 0.05)
    _eq(got, ref)


@pytest.mark.parametrize("caps", [(4096, 4096, N), (64, 32, 16)],
                         ids=["roomy", "over_cap"])
def test_interest_pairs(caps):
    rng = np.random.default_rng(2)
    old = _nbr_lists(rng)
    new = old.copy()
    for i in rng.choice(N, 60, replace=False):
        new[i] = _nbr_lists(rng, 1)[0]
    ref = jdelta.interest_pairs(jnp.asarray(old), jnp.asarray(new), N,
                                *caps)
    got = tdelta.interest_pairs(torch.tensor(old), torch.tensor(new), N,
                                *caps)
    for g, r in zip(got, ref):
        _eq(g, r)
    if caps[0] == 64:
        assert int(got[2]) > 64 and int(got[6]) > 16


@pytest.mark.parametrize("cap", [2000, 37])
def test_interest_delta_and_masked_pairs(cap):
    rng = np.random.default_rng(3)
    old, new = _nbr_lists(rng), _nbr_lists(rng)
    jm = jdelta.interest_delta(jnp.asarray(old), jnp.asarray(new), N)
    tm = tdelta.interest_delta(torch.tensor(old), torch.tensor(new), N)
    for g, r in zip(tm, jm):
        _eq(g, r)
    ref = jdelta.masked_pairs(jm[0], jnp.asarray(new), cap)
    got = tdelta.masked_pairs(tm[0], torch.tensor(new), cap)
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("cap", [5000, 100])
def test_bounded_extract(cap):
    mask = np.random.default_rng(4).random((N, K)) < 0.3
    for jf, tf in ((jextract.bounded_extract, textract.bounded_extract),
                   (jextract.bounded_extract_rows,
                    textract.bounded_extract_rows)):
        for g, r in zip(tf(torch.tensor(mask), cap),
                        jf(jnp.asarray(mask), cap)):
            _eq(g, r)


@pytest.mark.parametrize("cap", [4096, 50])
@pytest.mark.parametrize("with_flags", [True, False])
def test_collect_sync(cap, with_flags):
    rng = np.random.default_rng(5)
    nbr = _nbr_lists(rng)
    dirty = rng.random(N) < 0.4
    has_client = rng.random(N) < 0.3
    pos = rng.uniform(0, 100, (N, 3)).astype(np.float32)
    yaw = rng.uniform(0, 6, N).astype(np.float32)
    nbr_dirty = np.where(nbr < N, dirty[np.minimum(nbr, N - 1)], False)
    ref = jsync.collect_sync(
        jnp.asarray(nbr), jnp.asarray(dirty), jnp.asarray(has_client),
        jnp.asarray(pos), jnp.asarray(yaw), cap,
        nbr_dirty=jnp.asarray(nbr_dirty) if with_flags else None)
    got = tsync.collect_sync(
        torch.tensor(nbr), torch.tensor(dirty), torch.tensor(has_client),
        torch.tensor(pos), torch.tensor(yaw), cap,
        nbr_dirty=torch.tensor(nbr_dirty) if with_flags else None)
    for g, r in zip(got, ref):
        _eq(g, r)
    if cap == 50:
        assert int(got[3]) > cap


@pytest.mark.parametrize("cap", [4096, 30])
def test_collect_attr_deltas(cap):
    rng = np.random.default_rng(6)
    hot = rng.random((N, 8)).astype(np.float32)
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    bits[rng.random(N) < 0.7] = 0
    bits[0] = 0x80000001   # the top bit survives the int32 carry
    ref = jsync.collect_attr_deltas(jnp.asarray(hot), jnp.asarray(bits),
                                    cap)
    got = tsync.collect_attr_deltas(torch.tensor(hot),
                                    torch.tensor(bits.view(np.int32)), cap)
    for g, r in zip(got, ref):
        _eq(g, r)
