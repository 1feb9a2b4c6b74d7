"""The port's halo exchange against the JAX package's, bit for bit: the
port's ``exchange_halo`` / ``exchange_halo_2d`` on stacked tiles (the
ship kernel's plain version on the CPU) against JAX's under
``shard_map`` on 8 CPU devices, with both ``halo_impl`` values (JAX's
async Pallas ship in interpret mode); 1D strips of 8 tiles and 2D 4x2
tiles, across dirty and alive fractions and ``halo_cap`` overflow. Also
the strip pack round trip, the ring semantics, the phase wrapper
``ship_phase`` (its plain version on the CPU) against the parent
composition (gather, pack, ring, unpack, cat) in every parity case,
what the wrapper rejects, and the ``meta_gid_bound`` guard."""

import zlib

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
        ring = thalo.Ring(shift, tuple(ok))
        assert ring.mask == sum(1 << t for t in range(n_dev) if ok[t])
    assert thalo.ship_ring_plain(bufs, 1, [True] * n_dev).dtype == dtype


# ---- the phase: ship_phase (its plain version on the CPU) against the
# parent's composition: gather, pack, ring, unpack, cat

H = 16
M = 40
# (n_dev, rings, col0, ghost columns G): both 2D phases at 2x2 and 4x2,
# the 1D phase of 8 tiles, and one tile sending to itself (shift 0)
LAYOUTS = {
    "2x2-x": (4, thalo.rings_2d(2, 2)[0], 0, 4 * H),
    "2x2-z": (4, thalo.rings_2d(2, 2)[1], 2 * H, 4 * H),
    "4x2-x": (8, thalo.rings_2d(4, 2)[0], 0, 4 * H),
    "4x2-z": (8, thalo.rings_2d(4, 2)[1], 2 * H, 4 * H),
    "1d8": (8, thalo.rings_1d(8), 0, 2 * H),
    "one-tile": (1, (thalo.Ring(1, (True,)), thalo.Ring(-1, (True,))), 0,
                 2 * H),
    "one-tile-z": (1, (thalo.Ring(1, (True,)), thalo.Ring(-1, (True,))),
                   2 * H, 4 * H),
}


def _odd_f32(rng, shape):
    """f32 words with NaN payloads, -0.0 and infinities among them."""
    x = rng.normal(0, 1e3, shape).astype(np.float32)
    bits = x.reshape(-1).view(np.uint32)
    special = np.array([0x7FC01234, 0xFFA00001, 0x80000000, 0x7F800000,
                        0xFF800000, 0x00000001], np.uint32)
    at = rng.choice(bits.size, min(bits.size, 3 * special.size),
                    replace=False)
    bits[at] = np.resize(special, at.size)
    return x


def _phase_inputs(layout, recv, counts, seed):
    """(src, strips, out) as numpy-made tensors: own lanes of M rows, a
    ghost block whose columns [0, col0) hold an earlier phase's rows,
    flat rows drawn from both segments with garbage past each count."""
    n_dev, rings, col0, g = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    bound = thalo.meta_gid_bound()

    def lanes(rows, with_valid):
        gid = rng.integers(0, bound + 1, (n_dev, rows)).astype(np.int32)
        gid.reshape(-1)[:2] = [bound, 0]
        out = [_odd_f32(rng, (n_dev, rows, 3)), _odd_f32(rng, (n_dev, rows)),
               rng.random((n_dev, rows)) < 0.5]
        if with_valid:
            out.append(rng.random((n_dev, rows)) < 0.7)
        return [torch.tensor(x) for x in (*out, gid)]

    src = lanes(M, False)
    out = lanes(g, True)
    if recv != "layout":
        rings = tuple(thalo.Ring(r.shift, (recv == "all",) * n_dev)
                      for r in rings)
    strips = []
    for ring in rings:
        cnt = {"random": rng.integers(0, 3 * H // 2, n_dev),
               "zero": np.zeros(n_dev, np.int64),
               "full": np.full(n_dev, H),
               "over": rng.integers(H + 1, M + col0 + 1, n_dev)}[counts]
        # extraction's layout: rows of H + 1 words, the first H used
        flat = rng.integers(-5, 10 ** 6, (n_dev, H + 1)).astype(np.int32)
        for t in range(n_dev):
            take = min(int(cnt[t]), H)
            flat[t, :take] = np.sort(rng.choice(M + col0, take,
                                                replace=False))
        strips.append((ring, torch.tensor(flat)[:, :H],
                       torch.tensor(cnt.astype(np.int32))))
    return src, tuple(strips), out, col0


def _parent_phase(src, strips, out, col0):
    """The parent's ship of one phase: each direction's strip gathered
    from the own rows and the earlier ghost columns, packed, shipped,
    unpacked, its gid normalised, then concatenated into the block."""
    pos, yaw, dirty, gid = (
        torch.cat([s, o[:, :col0]], dim=1)
        for s, o in zip(src, (out[0], out[1], out[2], out[4])))
    m = pos.shape[1]
    parts = []
    for ring, flat, count in strips:
        valid = torch.arange(H) < torch.clamp_max(count, H)[:, None]
        slots = torch.where(valid, flat, m - 1).long()
        sel_dirty = torch.gather(dirty, 1, slots) & valid
        sel_pos = torch.gather(pos, 1, slots[..., None].expand(-1, -1, 3))
        pack = (torch.where(valid[..., None], sel_pos, 0.0),
                torch.where(sel_dirty, torch.gather(yaw, 1, slots), 0.0),
                sel_dirty, valid,
                torch.where(valid, torch.gather(gid, 1, slots), -1))
        shipped = list(thalo._unpack_strip(thalo.ship_ring_plain(
            thalo._pack_strip(*pack), ring.shift, list(ring.recv_ok))))
        shipped[4] = torch.where(shipped[3], shipped[4], 0)
        parts.append(shipped)
    end = col0 + 2 * H
    return [torch.cat([o[:, :col0], parts[0][i], parts[1][i], o[:, end:]],
                      dim=1) for i, o in enumerate(out)]


def _same_bits(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"lane {i}: {(g != w).sum()} words differ"


@pytest.mark.parametrize("counts", ["random", "zero", "full", "over"])
@pytest.mark.parametrize("recv", ["layout", "all", "none"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ship_phase_matches_parent_composition(layout, recv, counts):
    seed = zlib.crc32(f"{layout}/{recv}/{counts}".encode())
    src, strips, out, col0 = _phase_inputs(layout, recv, counts, seed)
    want = _parent_phase(src, strips, out, col0)
    got = [o.clone() for o in out]
    thalo.ship_phase(src, strips, got, col0)
    _same_bits(got, want)
    block = got[3][:, col0:col0 + 2 * H]
    if recv == "none" or counts == "zero":
        assert not block.any()
    elif recv == "all" and counts in ("full", "over"):
        assert block.all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_exchange_async_equals_ppermute_on_random_worlds(seed, two_d):
    world = _world(100 + seed, 0.5, 0.8, two_d)
    cap = [3, 8, 16, 64][seed]
    _assert_bits(_port("async", two_d, cap, world),
                 _port("ppermute", two_d, cap, world))


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_exchange_ships_one_phase_call_a_phase(two_d, monkeypatch):
    calls = []
    ship = thalo.ship_phase

    def counted(src, strips, out, col0):
        calls.append(col0)
        ship(src, strips, out, col0)

    monkeypatch.setattr(thalo, "ship_phase", counted)
    _port("async", two_d, 16, _world(5, 0.5, 0.8, two_d))
    assert calls == ([0, 32] if two_d else [0])


def _bad_phase(bad):
    src, strips, out, col0 = _phase_inputs("2x2-z", "layout", "random", 1)
    src, out, strips = list(src), list(out), [list(s) for s in strips]
    if bad == "pos-f64":
        src[0] = src[0].double()
    elif bad == "dirty-u8":
        src[2] = src[2].to(torch.uint8)
    elif bad == "gid-i64":
        out[4] = out[4].long()
    elif bad == "strided-yaw":
        src[1] = torch.zeros((4, 2 * M))[:, ::2]
    elif bad == "strided-gpos":
        out[0] = torch.zeros((4, 4 * H, 6))[..., ::2]
    elif bad == "flat-i64":
        strips[0][1] = strips[0][1].long()
    elif bad == "flat-shape":
        strips[1][1] = strips[1][1][:, :H - 1]
    elif bad == "flat-column":
        strips[0][1] = torch.zeros((4, H, 2), dtype=torch.int32)[..., 0]
    elif bad == "count-shape":
        strips[0][2] = strips[0][2][:3]
    elif bad == "recv-length":
        strips[1][0] = thalo.Ring(1, (True,) * 3)
    elif bad == "too-many-tiles":
        n = thalo.MAX_SHIP_TILES + 1
        src = [torch.zeros((n, M, 3)), torch.zeros((n, M)),
               torch.zeros((n, M), dtype=torch.bool),
               torch.zeros((n, M), dtype=torch.int32)]
        out = [torch.zeros((n, 4 * H, 3)), torch.zeros((n, 4 * H)),
               torch.zeros((n, 4 * H), dtype=torch.bool),
               torch.zeros((n, 4 * H), dtype=torch.bool),
               torch.zeros((n, 4 * H), dtype=torch.int32)]
        strips = [[thalo.Ring(1, (True,) * n),
                   torch.zeros((n, H), dtype=torch.int32),
                   torch.zeros(n, dtype=torch.int32)] for _ in range(2)]
    elif bad == "columns":
        col0 = 2 * H + 1
    elif bad == "one-strip":
        strips = strips[:1]
    return src, strips, out, col0


@pytest.mark.parametrize("bad", [
    "pos-f64", "dirty-u8", "gid-i64", "strided-yaw", "strided-gpos",
    "flat-i64", "flat-shape", "flat-column", "count-shape", "recv-length",
    "too-many-tiles", "columns", "one-strip"])
def test_ship_phase_rejects_what_the_kernel_does_not_take(bad):
    src, strips, out, col0 = _bad_phase(bad)
    with pytest.raises((TypeError, ValueError)):
        thalo.ship_phase(src, strips, out, col0)


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
