"""The port's counting sort (the plain version its CUDA kernel is held
to) against the JAX package's counting_sort_cells_pallas, run in
interpret mode through both kernel bodies, and against a stable
argsort: bit for bit, including the dump bin and heavy duplicates. The
CUDA kernel's digit plan (``radix_plan``) for every key width, and a
torch model of its one-sweep passes (tiles, per-tile digit counts, the
look-back's exclusive prefix, ranks among equal digits) against a
stable argsort."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goworld_tpu.ops.sort import counting_sort_cells_pallas
from goworld_tpu.ops.sort import row_starts as jax_row_starts
from goworld_tpu_torch.ops.sort import (
    RADIX_MAX_DIGIT_BITS,
    counting_sort_cells,
    counting_sort_cells_cuda,
    radix_plan,
    row_starts,
)

# one intra-op thread a test process: parallel test workers' pools
# would otherwise oversubscribe the host's cores
torch.set_num_threads(1)

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
    """Since the sort took a Space axis, a 2-D ``[S, n]`` tensor is S
    Spaces; the "2d" case now holds that a batch whose Space-major keys
    ``s * (n_rows + 1) + row`` pass 31 bits is refused (a 3-D tensor
    too)."""
    srow = torch.zeros(64, dtype=torch.int32)
    arg, n_rows = {"int64": (srow.long(), 4),
                   "2d": (srow.reshape(8, 8), 2**29),
                   "strided": (torch.zeros(128, dtype=torch.int32)[::2],
                               4)}[bad]
    with pytest.raises((TypeError, ValueError)):
        counting_sort_cells_cuda(arg, n_rows)
    if bad == "2d":
        with pytest.raises(ValueError):
            counting_sort_cells_cuda(srow.reshape(2, 4, 8), 4)


# the kernel's limits (csrc/counting_sort.cu): digits of 1-8 bits, a
# digit table of passes x bins <= 4096 entries, shifts below 32
KERNEL_MAX_DIGIT_BITS = 8
KERNEL_MAX_TABLE = 4096


@pytest.mark.parametrize("bits", range(1, 32))
def test_radix_plan_covers_every_key_width(bits):
    passes, digit_bits = radix_plan(bits)
    assert 1 <= digit_bits <= RADIX_MAX_DIGIT_BITS <= KERNEL_MAX_DIGIT_BITS
    assert passes * digit_bits >= bits          # every key bit is sorted
    assert (passes - 1) * digit_bits < bits     # and no pass is wasted
    assert passes == -(-bits // RADIX_MAX_DIGIT_BITS)  # fewest passes
    assert passes * (1 << digit_bits) <= KERNEL_MAX_TABLE
    assert (passes - 1) * digit_bits <= 31


def test_radix_plan_at_the_bench_width_and_its_limits():
    assert radix_plan(19) == (3, 7)             # n_rows = 352,836
    assert radix_plan(21) == (3, 7)
    assert radix_plan(31) == (4, 8)
    assert radix_plan(1) == (1, 1)
    for bad in (0, 32):
        with pytest.raises(ValueError):
            radix_plan(bad)


def _onesweep_model(keys, plan, tile):
    """The kernel's passes in torch ops: per pass, each tile's digit
    counts, their exclusive prefix over earlier tiles (what the
    look-back returns), the digit offsets from the histogram of all
    keys, and each key's rank among equal digits earlier in its tile."""
    passes, dbits = plan
    bins = 1 << dbits
    n = keys.shape[0]
    cur_k, cur_v = keys.clone(), torch.arange(n, dtype=torch.int64)
    offsets = []
    for p in range(passes):  # the histogram kernel, all passes at once
        d = (keys >> (p * dbits)) & (bins - 1)
        cnt = torch.bincount(d, minlength=bins)
        offsets.append(torch.cumsum(cnt, 0) - cnt)
    for p in range(passes):
        d = (cur_k >> (p * dbits)) & (bins - 1)
        tiles = -(-n // tile)
        t_of = torch.arange(n) // tile
        counts = torch.zeros(tiles, bins, dtype=torch.int64)
        counts.index_put_((t_of, d), torch.ones(n, dtype=torch.int64),
                          accumulate=True)
        excl = torch.cumsum(counts, 0) - counts      # look-back prefix
        onehot = torch.nn.functional.one_hot(d, bins)
        rank = torch.zeros(n, dtype=torch.int64)
        for t in range(tiles):
            sl = slice(t * tile, min((t + 1) * tile, n))
            c = torch.cumsum(onehot[sl], 0) - onehot[sl]
            rank[sl] = c.gather(1, d[sl, None])[:, 0]
        dst = offsets[p][d] + excl[t_of, d] + rank
        nk, nv = torch.empty_like(cur_k), torch.empty_like(cur_v)
        nk[dst], nv[dst] = cur_k, cur_v
        cur_k, cur_v = nk, nv
    return cur_v, cur_k


def _radix_keys(n, bits, kind, seed):
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1 if bits < 31 else 2**31 - 2
    if kind == "random":
        return rng.integers(0, top + 1, n)
    # skewed: a few heavy keys, then the dump bin (the top key) for 30%
    heavy = rng.integers(0, top + 1, 5)
    out = heavy[rng.integers(0, 5, n)]
    out[rng.random(n) < 0.3] = top
    return out


@pytest.mark.parametrize("kind", ["random", "skewed"])
@pytest.mark.parametrize("bits", [1, 7, 10, 19, 21, 31])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_onesweep_model_equals_stable_argsort(n, bits, kind):
    keys = torch.tensor(_radix_keys(n, bits, kind, n * 31 + bits),
                        dtype=torch.int64)
    ref = torch.argsort(keys, stable=True)
    # the shipped plan, and one pass a bit
    for plan in {radix_plan(bits), (bits, 1)}:
        order, sorted_keys = _onesweep_model(keys, plan, tile=64)
        assert torch.equal(order, ref)
        assert torch.equal(sorted_keys, keys[ref])
