"""The port's counting sort (the plain version its CUDA kernel is held
to) against the JAX package's counting_sort_cells_pallas, run in
interpret mode through both kernel bodies, and against a stable
argsort: bit for bit, including the dump bin and heavy duplicates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.ops.sort import counting_sort_cells_pallas
from goworld_tpu.ops.sort import row_starts as jax_row_starts
from goworld_tpu_torch.ops.sort import (
    counting_sort_cells,
    counting_sort_cells_cuda,
    row_starts,
)

CASES = [
    # (n, n_rows, chunk, dead_frac, distinct keys): duplicate-heavy, one
    # bin, n not a multiple of the chunk, chunk past n, many dead slots
    (1000, 37, 128, 0.1, 37),
    (777, 500, 100, 0.3, 500),
    (640, 1, 256, 0.0, 1),
    (1536, 3000, 512, 0.5, 4),
    (96, 9, 2048, 0.9, 9),
]


def _keys(n, n_rows, dead_frac, distinct, seed):
    rng = np.random.default_rng(seed)
    pick = rng.choice(n_rows, min(distinct, n_rows), replace=False)
    srow = pick[rng.integers(0, len(pick), n)].astype(np.int32)
    srow[rng.random(n) < dead_frac] = n_rows
    return srow


@pytest.mark.parametrize("lowering", ["vector", "serial"])
@pytest.mark.parametrize("n,n_rows,chunk,dead,distinct", CASES)
def test_plain_matches_jax_pallas_and_argsort(n, n_rows, chunk, dead,
                                              distinct, lowering):
    srow = _keys(n, n_rows, dead, distinct, n + n_rows)
    ref = np.argsort(srow, kind="stable").astype(np.int32)
    jo, js = counting_sort_cells_pallas(jnp.asarray(srow), n_rows, chunk,
                                        interpret=True, lowering=lowering)
    to, ts = counting_sort_cells(torch.tensor(srow), n_rows, chunk)
    assert to.dtype == torch.int32 and ts.dtype == torch.int32
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(to.numpy(), ref)
    assert np.array_equal(ts.numpy(), srow[ref])


@pytest.mark.parametrize("n,n_rows,chunk,dead,distinct", CASES)
def test_wrapper_takes_the_plain_version_on_cpu(n, n_rows, chunk, dead,
                                                distinct):
    srow = _keys(n, n_rows, dead, distinct, 7 * n)
    ref = np.argsort(srow, kind="stable").astype(np.int32)
    order, sorted_row = counting_sort_cells_cuda(torch.tensor(srow),
                                                 n_rows)
    assert np.array_equal(order.numpy(), ref)
    assert np.array_equal(sorted_row.numpy(), srow[ref])
    assert np.array_equal(row_starts(torch.tensor(srow), n_rows).numpy(),
                          np.asarray(jax_row_starts(jnp.asarray(srow),
                                                    n_rows)))


@pytest.mark.parametrize("bad", ["int64", "2d", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    srow = torch.zeros(64, dtype=torch.int32)
    arg = {"int64": srow.long(), "2d": srow.reshape(8, 8),
           "strided": torch.zeros(128, dtype=torch.int32)[::2]}[bad]
    with pytest.raises((TypeError, ValueError)):
        counting_sort_cells_cuda(arg, 4)
