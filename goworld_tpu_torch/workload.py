"""The port's first workload: the JAX package's bench world
(``bench.py`` ``build(n, client_frac=0.01)``) under the configuration
that runs both CUDA kernels, made from a numpy seed.

Every slot holds an alive mover at a uniform position in a square world
sized for about 12 Chebyshev neighbors at radius 50, 1% of them own a
client, and every tick carries 4096 client position syncs to distinct
slots.
"""

from __future__ import annotations

import numpy as np
import torch

from goworld_tpu_torch.core.state import WorldConfig, create_state
from goworld_tpu_torch.core.step import TickInputs
from goworld_tpu_torch.ops.aoi import GridSpec

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
