"""The port's halo exchange against the JAX package's, bit for bit: the
port's ``exchange_halo`` / ``exchange_halo_2d`` on stacked tiles (the
ship kernel's plain version on the CPU) against JAX's under
``shard_map`` on 8 CPU devices, with both ``halo_impl`` values (JAX's
async Pallas ship in interpret mode); 1D strips of 8 tiles and 2D 4x2
tiles, across dirty and alive fractions and ``halo_cap`` overflow. Also
the strip pack round trip, the ship's ring semantics and the
``meta_gid_bound`` guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from goworld_tpu.core.state import WorldConfig as JWorld
from goworld_tpu.ops.aoi import GridSpec as JGrid
from goworld_tpu.parallel import halo as jhalo
from goworld_tpu.parallel.megaspace import MegaConfig as JMega
from goworld_tpu.parallel.mesh import SPACE_AXIS, make_mesh, shard_map_norep
from goworld_tpu_torch.core.state import WorldConfig
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel import halo as thalo
from goworld_tpu_torch.parallel.megaspace import MegaConfig

N_DEV = 8
N = 64
TILE_W = TILE_D = 100.0
RADIUS = 25.0
NAMES = ("gpos", "gyaw", "gdirty", "gvalid", "ggid", "strip_demand")


def _world(seed, dirty_frac, alive_frac, two_d):
    """Per-tile arrays in global coordinates, leading [n_dev] axis."""
    rng = np.random.default_rng(seed)
    tz = 2 if two_d else 1
    pos = np.zeros((N_DEV, N, 3), np.float32)
    for d in range(N_DEV):
        ix, iz = d // tz, d % tz
        pos[d, :, 0] = ix * TILE_W + rng.uniform(0, TILE_W, N)
        pos[d, :, 1] = rng.uniform(-3, 3, N)
        pos[d, :, 2] = (iz * TILE_D if two_d else 0.0) \
            + rng.uniform(0, TILE_D, N)
    yaw = rng.uniform(-np.pi, np.pi, (N_DEV, N)).astype(np.float32)
    dirty = rng.random((N_DEV, N)) < dirty_frac
    alive = rng.random((N_DEV, N)) < alive_frac
    return pos, yaw, dirty, alive


def _jax(impl, two_d, halo_cap, world):
    mesh = make_mesh(N_DEV)

    def fn(pos, yaw, dirty, alive):
        pos, yaw, dirty, alive = pos[0], yaw[0], dirty[0], alive[0]
        if two_d:
            out = jhalo.exchange_halo_2d(
                SPACE_AXIS, (4, 2), N, pos, yaw, dirty, alive, TILE_W,
                TILE_D, RADIUS, halo_cap, impl=impl)
        else:
            out = jhalo.exchange_halo(
                SPACE_AXIS, N_DEV, pos, yaw, dirty, alive, TILE_W, RADIUS,
                halo_cap, impl=impl)
        return jax.tree.map(lambda x: x[None], out)

    mapped = shard_map_norep(fn, mesh=mesh, in_specs=(P(SPACE_AXIS),) * 4,
                             out_specs=P(SPACE_AXIS))
    out = jax.jit(mapped)(*map(jnp.asarray, world))
    out = [np.asarray(x) for x in out]
    out[-1] = out[-1].reshape(N_DEV)   # per-tile scalar demand
    return out


def _port(impl, two_d, halo_cap, world):
    pos, yaw, dirty, alive = map(torch.tensor, world)
    if two_d:
        out = thalo.exchange_halo_2d((4, 2), N, pos, yaw, dirty, alive,
                                     TILE_W, TILE_D, RADIUS, halo_cap,
                                     impl=impl)
    else:
        out = thalo.exchange_halo(N_DEV, pos, yaw, dirty, alive, TILE_W,
                                  RADIUS, halo_cap, impl=impl)
    return [o.numpy() for o in out]


def _assert_bits(got, ref):
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, (
            name, g.dtype, r.dtype, g.shape, r.shape)
        if r.dtype.kind == "f":
            g, r = g.view(np.int32), r.view(np.int32)
        assert np.array_equal(g, r), (
            f"{name}: {(g != r).sum()} of {r.size} lanes differ")


@pytest.mark.parametrize("impl", ["ppermute", "async"])
@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("dirty_frac,alive_frac", [
    (0.0, 1.0), (1.0, 1.0), (0.4, 0.7)], ids=["clean", "all-dirty",
                                              "mixed"])
def test_exchange_matches_jax(impl, two_d, dirty_frac, alive_frac):
    world = _world(3, dirty_frac, alive_frac, two_d)
    ref = _jax(impl, two_d, 32, world)
    got = _port(impl, two_d, 32, world)
    _assert_bits(got, ref)
    assert got[3].any()          # ghosts were shipped


@pytest.mark.parametrize("impl", ["ppermute", "async"])
@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_exchange_matches_jax_under_overflow(impl, two_d):
    world = _world(7, 0.5, 1.0, two_d)
    cap = 4
    ref = _jax(impl, two_d, cap, world)
    got = _port(impl, two_d, cap, world)
    _assert_bits(got, ref)
    assert (got[-1] > cap).any()


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_port_impls_bit_identical(two_d):
    world = _world(11, 0.3, 0.8, two_d)
    _assert_bits(_port("async", two_d, 16, world),
                 _port("ppermute", two_d, 16, world))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_round_trip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h = 50
    gpos = rng.normal(0, 1e4, (3, h, 3)).astype(np.float32)
    gpos[0, 0] = [-0.0, np.inf, -np.inf]
    gyaw = rng.normal(0, 3, (3, h)).astype(np.float32)
    gdirty = rng.random((3, h)) < 0.5
    gvalid = rng.random((3, h)) < 0.5
    ggid = rng.integers(-1, thalo.meta_gid_bound() + 1, (3, h),
                        dtype=np.int64).astype(np.int32)
    ggid[0, :2] = [-1, thalo.meta_gid_bound()]
    lanes = (gpos, gyaw, gdirty, gvalid, ggid)
    buf = thalo._pack_strip(*map(torch.tensor, lanes))
    ref = np.stack([np.asarray(jhalo._pack_strip(*map(jnp.asarray,
                                                      [x[d] for x in lanes])))
                    for d in range(3)])
    assert buf.dtype == torch.int32 and np.array_equal(buf.numpy(), ref)
    for a, b in zip(thalo._unpack_strip(buf), lanes):
        a = a.numpy()
        assert a.dtype == b.dtype
        if b.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bool])
def test_ship_ring_plain_is_the_ring(n_dev, dtype):
    rng = np.random.default_rng(n_dev)
    bufs = torch.tensor(rng.integers(1, 100, (n_dev, 6, 5))).to(dtype)
    for shift in range(-n_dev, n_dev + 1):
        ok = [bool(b) for b in rng.random(n_dev) < 0.6]
        out = thalo.ship_ring_plain(bufs, shift, ok)
        for t in range(n_dev):
            want = bufs[(t - shift) % n_dev] if ok[t] \
                else torch.zeros_like(bufs[0])
            assert torch.equal(out[t], want)
        if dtype == torch.int32:
            assert torch.equal(thalo.ship_ring_cuda(bufs, shift, ok), out)
    assert thalo.ship_ring_plain(bufs, 1, [True] * n_dev).dtype == dtype


@pytest.mark.parametrize("bad", ["float", "2d", "strided", "recv_ok"])
def test_ship_ring_cuda_rejects_what_the_kernel_does_not_take(bad):
    bufs = torch.zeros((4, 8, 5), dtype=torch.int32)
    arg, ok = {
        "float": (bufs.float(), [True] * 4),
        "2d": (bufs.reshape(4, 40), [True] * 4),
        "strided": (torch.zeros((4, 8, 10), dtype=torch.int32)[..., ::2],
                    [True] * 4),
        "recv_ok": (bufs, [True] * 3),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        thalo.ship_ring_cuda(arg, 1, ok)


def test_meta_gid_bound_guard_matches_jax():
    assert thalo.meta_gid_bound() == jhalo.meta_gid_bound()
    cap = (thalo.meta_gid_bound() // 2) + 1   # 2 tiles -> gids past bound
    grid = dict(radius=10.0, extent_x=120.0, extent_z=100.0, k=8,
                cell_cap=16, row_block=1024)
    for mega, world, gs in ((MegaConfig, WorldConfig, GridSpec),
                            (JMega, JWorld, JGrid)):
        with pytest.raises(ValueError, match="29-bit"):
            mega(cfg=world(capacity=cap, grid=gs(**grid)), n_dev=2,
                 tile_w=100.0, halo_impl="async")
        mega(cfg=world(capacity=cap, grid=gs(**grid)), n_dev=2,
             tile_w=100.0, halo_impl="ppermute")
