"""The port's threefry PRNG gives jax.random's bits exactly: keys,
splits and float32 uniforms, in the live threefry mode of the installed
jax."""

import jax
import numpy as np
import pytest
import torch

from goworld_tpu_torch.ops import prng

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]


def test_pinned_to_the_partitionable_threefry_mode():
    # the port implements jax_threefry_partitionable=True only; if the
    # installed jax changes its default, this test says so first
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    ref = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    assert np.array_equal(prng.prng_key(seed, "cpu").numpy(), ref)


@pytest.mark.parametrize("num", [2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.prng_key(seed, "cpu"), num).numpy()
    assert np.array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [
    ((7,), 0.0, 1.0),
    ((1000,), 0.0, 2.0 * np.pi),
    ((3, 5), -3.5, 11.25),
    ((1025,), -1000.0, 1e-3),
    ((64, 3), 0.0, 29560.0),
])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_float32_bits(seed, shape, lo, hi):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    ref = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    tkey = prng.split(prng.prng_key(seed, "cpu"))[1]
    got = prng.uniform(tkey, shape, lo, hi).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
