"""The port's workloads, made from a numpy seed.

* The single-Space bench world (``bench.py`` ``build(n,
  client_frac=0.01)``) under the configuration that runs the sweep and
  sort kernels: every slot holds an alive mover at a uniform position in
  a square world sized for about 12 Chebyshev neighbors at radius 50, 1%
  of them own a client, and every tick carries 4096 client position
  syncs to distinct slots.
* The megaspace bench world (``bench.py`` ``build_mega(n_total)``): the
  same density over one square world cut into the most-square grid of
  ``n_dev`` tiles, each tile's movers uniform inside it, with a
  tile-local client-sync stream per tile; it runs all three kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goworld_tpu_torch.core.state import WorldConfig, create_state
from goworld_tpu_torch.core.step import TickInputs
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel.megaspace import MegaConfig, create_mega_state
from goworld_tpu_torch.parallel.step import MultiTickInputs

CLIENT_FRAC = 0.01


def slice_config(n: int, **grid_kw) -> WorldConfig:
    """bench.py's world at capacity ``n`` with skin 0, the fused sweep
    and the counting sort (``grid_kw`` overrides GridSpec fields)."""
    extent = float(int((n * 10000 / 12) ** 0.5))
    kw = dict(radius=50.0, extent_x=extent, extent_z=extent, k=32,
              cell_cap=12, row_block=65536, sweep_impl="fused",
              sort_impl="pallas", topk_impl="sort", skin=0.0,
              precision="off")
    kw.update(grid_kw)
    return WorldConfig(
        capacity=n, grid=GridSpec(**kw), npc_speed=5.0,
        enter_cap=65536, leave_cap=65536, sync_cap=65536,
        attr_sync_cap=4096, input_cap=4096, delta_rows_cap=65536,
    )


def bench_world(cfg: WorldConfig, seed: int, device="cuda"):
    """(state, inputs) of the bench world on ``device``."""
    n, g = cfg.capacity, cfg.grid
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0, g.extent_x, n)
    pos[:, 2] = rng.uniform(0, g.extent_z, n)
    st = create_state(cfg, seed=1, device=device)
    dev = st.device
    st = st.replace(
        pos=torch.tensor(pos, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        npc_moving=torch.ones(n, dtype=torch.bool, device=dev),
        has_client=torch.tensor(rng.random(n) < CLIENT_FRAC, device=dev),
        client_gate=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    ic = min(cfg.input_cap, n)
    vals = np.zeros((cfg.input_cap, 4), np.float32)
    vals[:ic, 0] = rng.uniform(0, g.extent_x, ic)
    vals[:ic, 2] = rng.uniform(0, g.extent_z, ic)
    idx = np.zeros(cfg.input_cap, np.int32)
    idx[:ic] = rng.choice(n, ic, replace=False)
    inputs = TickInputs(
        pos_sync_idx=torch.tensor(idx, device=dev),
        pos_sync_vals=torch.tensor(vals, device=dev),
        pos_sync_n=torch.tensor(ic, dtype=torch.int32, device=dev),
    )
    return st, inputs


def mega_factor(n_dev: int) -> tuple[int, int]:
    """Most-square (tx, tz) tiling of n_dev (8 -> 4x2, 4 -> 2x2; primes
    give 1D x strips), as ``bench.py`` ``_mega_factor``."""
    tz = max(d for d in range(1, int(n_dev ** 0.5) + 1) if n_dev % d == 0)
    return n_dev // tz, tz


def _alive_per(n_total: int, n_dev: int) -> int:
    """Alive rows of each tile of ``build_mega(n_total)``."""
    return max(64, n_total // n_dev)


def mega_config(n_total: int, n_dev: int) -> MegaConfig:
    """``build_mega(n_total)``'s megaspace over ``n_dev`` tiles, with
    the fused sweep, the counting sort, skin 0 and the async halo ship.
    At n_total = 2^20 and 4 tiles: 2x2 tiles of 14,780, capacity
    294,912 (262,144 alive), halo_cap 4096."""
    tx, tz = mega_factor(n_dev)
    alive_per = _alive_per(n_total, n_dev)
    cap = alive_per + max(64, alive_per // 8)
    radius = 50.0
    extent = float(int((n_total * 10000 / 12) ** 0.5))
    tile_w = extent / tx
    tile_d = extent / tz if tz > 1 else 0.0
    if radius > min(tile_w, tile_d if tz > 1 else tile_w):
        raise ValueError(
            f"tiles {tile_w:.0f}x{tile_d:.0f} thinner than the AOI radius "
            f"{radius} at n_total={n_total}, n_dev={n_dev}")
    # worst-strip occupancy estimate x4, clamped
    strip_frac = radius / min(tile_w, tile_d or tile_w)
    halo_cap = max(512, min(16384, 1 << int(4 * alive_per * strip_frac)
                            .bit_length()))
    grid = GridSpec(
        radius=radius, extent_x=tile_w + 2 * radius,
        extent_z=(tile_d + 2 * radius) if tz > 1 else extent, k=32,
        cell_cap=12, row_block=min(cap, 65536), sweep_impl="fused",
        sort_impl="pallas", topk_impl="sort", skin=0.0, verlet_cap=0,
        precision="off")
    cfg = WorldConfig(
        capacity=cap, grid=grid, npc_speed=5.0,
        enter_cap=65536, leave_cap=65536, sync_cap=65536,
        attr_sync_cap=4096, input_cap=4096, delta_rows_cap=65536,
    )
    return MegaConfig(
        cfg=cfg, n_dev=n_dev, tile_w=tile_w, halo_cap=halo_cap,
        migrate_cap=256, mesh_shape=(tx, tz) if tz > 1 else None,
        tile_d=tile_d, halo_impl="async",
    )


def mega_world(mc: MegaConfig, n_total: int, seed: int, device="cuda"):
    """(stacked state, MultiTickInputs) of the megaspace bench world of
    ``n_total`` entities on ``device``: per tile, the first ``n_total /
    n_dev`` slots alive movers uniform inside the tile, 1% with a
    client; per tile ``min(input_cap, alive / 16)`` client syncs to
    distinct alive slots at tile-local positions."""
    cfg, n_dev = mc.cfg, mc.n_dev
    n = cfg.capacity
    tz = mc.shape[1]
    alive_per = _alive_per(n_total, n_dev)
    if alive_per > n:
        raise ValueError(f"{alive_per} alive rows a tile exceed the "
                         f"capacity {n}")
    rng = np.random.default_rng(seed)
    ix = (np.arange(n_dev) // tz).astype(np.float32)[:, None]
    iz = (np.arange(n_dev) % tz).astype(np.float32)[:, None]
    tw, td = np.float32(mc.tile_w), np.float32(mc.tile_d)

    def tile_x(size):
        return ix * tw + rng.uniform(0, mc.tile_w, (n_dev, size)) \
            .astype(np.float32)

    def tile_z(size):
        if mc.is_2d:
            return iz * td + rng.uniform(0, mc.tile_d, (n_dev, size)) \
                .astype(np.float32)
        return rng.uniform(0, mc.world_z, (n_dev, size)).astype(np.float32)

    pos = np.zeros((n_dev, n, 3), np.float32)
    pos[..., 0] = tile_x(n)
    pos[..., 2] = tile_z(n)
    alive = np.broadcast_to(np.arange(n) < alive_per, (n_dev, n))
    has_client = (rng.random((n_dev, n)) < CLIENT_FRAC) & alive

    st = create_mega_state(mc, seed=seed, device=device)
    dev = st.device
    st = st.replace(
        pos=torch.tensor(pos, device=dev),
        alive=torch.tensor(alive, device=dev),
        npc_moving=torch.tensor(alive, device=dev),
        has_client=torch.tensor(has_client, device=dev),
        client_gate=torch.zeros((n_dev, n), dtype=torch.int32, device=dev),
        # bench.py keys tile d with PRNGKey(seed * n_dev + d + 1)
        rng=torch.stack([prng.prng_key(seed * n_dev + d + 1, dev)
                         for d in range(n_dev)]),
    )

    ic = cfg.input_cap
    n_sync = min(ic, max(16, alive_per // 16))
    vals = np.zeros((n_dev, ic, 4), np.float32)
    vals[:, :n_sync, 0] = tile_x(n_sync)
    vals[:, :n_sync, 2] = tile_z(n_sync)
    idx = np.zeros((n_dev, ic), np.int32)
    for d in range(n_dev):
        idx[d, :n_sync] = rng.choice(alive_per, n_sync, replace=False)
    empty = MultiTickInputs.empty(cfg, n_dev, device=dev)
    inputs = dataclasses.replace(empty, base=TickInputs(
        pos_sync_idx=torch.tensor(idx, device=dev),
        pos_sync_vals=torch.tensor(vals, device=dev),
        pos_sync_n=torch.full((n_dev,), n_sync, dtype=torch.int32,
                              device=dev),
    ))
    return st, inputs
