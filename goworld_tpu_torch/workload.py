"""The port's workloads, made from a numpy seed.

* The single-Space bench world (``bench.py`` ``build(n,
  client_frac=0.01)``) under the configuration that runs the sweep and
  sort kernels: every slot holds an alive mover at a uniform position in
  a square world sized for about 12 Chebyshev neighbors at radius 50, 1%
  of them own a client, and every tick carries 4096 client position
  syncs to distinct slots. Uncut (:func:`uncut_config`,
  :func:`uncut_world`) it is the bench's own headline: a Verlet skin of
  4 and sync slots drawn with repeats, as ``bench.py`` draws them.
* BASELINE config 5 (``bench.py``'s ``btree`` and ``mlp`` variants):
  the bench world uncut under ``behavior="btree"`` or ``"mlp"``, the mlp
  policy drawn as ``init_policy(PRNGKey(5))`` at hidden 128
  (:func:`behavior_config`, :func:`behavior_world`); a registry scenario
  over the same world (:func:`scenario_config`).
* Several Spaces on one card (:func:`multi_config`, :func:`multi_world`):
  S bench worlds of ``n_per`` slots each, stacked on a leading ``[S]``
  axis for the batched tick (the JAX World's vmapped local step), each
  Space with its own key (``seed * S + d``), positions and syncs.
* The megaspace bench world (``bench.py`` ``build_mega(n_total)``): the
  same density over one square world cut into the most-square grid of
  ``n_dev`` tiles, each tile's movers uniform inside it, with a
  tile-local client-sync stream per tile; it runs all three kernels.
* The served game (:func:`serve_world`): the bench world's config and
  density hosted by the serving ``World``, populated through
  ``Space.create_entity``, with a game's per-tick traffic staged through
  the World's own entry points (:meth:`Served.stage`): client syncs
  that walk each player a step from where it stands, or, as a stress
  case, the bench's stream of syncs to uniform points. With ``spaces >
  1`` one World hosts an Arena a Space, and each tick also moves
  SERVE_MIGRATIONS entities between two random Spaces (``enter_space``),
  as a game process hosting several zone maps sees its players walk
  between zones.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time

import numpy as np
import torch

from goworld_tpu_torch.core.state import WorldConfig, create_state
from goworld_tpu_torch.core.step import TickInputs
from goworld_tpu_torch.entity import Entity, GameClient, Space, World
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.aoi import GridSpec
from goworld_tpu_torch.parallel.megaspace import MegaConfig, create_mega_state
from goworld_tpu_torch.parallel.mesh import create_multi_state, make_mesh
from goworld_tpu_torch.parallel.step import MultiTickInputs
from goworld_tpu_torch.utils import ids

CLIENT_FRAC = 0.01
# bench.py's BENCH_SKIN_DEFAULT: movers advance 5/60 a tick, so a skin
# of 4 rebuilds the candidate cache about every 24 ticks
BENCH_SKIN = 4.0


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


def uncut_config(n: int, **grid_kw) -> WorldConfig:
    """The bench world uncut: :func:`slice_config` with the bench's
    Verlet skin (``verlet_cap`` auto: 48 at k = 32)."""
    return slice_config(n, **{"skin": BENCH_SKIN, **grid_kw})


# bench.py draws config 5's policy as init_policy(PRNGKey(5))
POLICY_SEED = 5


def behavior_config(n: int, behavior: str, **grid_kw) -> WorldConfig:
    """BASELINE config 5 as ``bench.py`` builds its ``btree`` and
    ``mlp`` variants: the bench world uncut (:func:`uncut_config`)
    under ``behavior``; ``skin=0.0`` gives the lean twin."""
    return dataclasses.replace(uncut_config(n, **grid_kw),
                               behavior=behavior)


def scenario_config(n: int, name: str, **grid_kw) -> WorldConfig:
    """The bench world uncut under registry scenario ``name`` (the
    random walk as ``cfg.behavior``, as ``bench.py`` resolves a scenario
    name)."""
    from goworld_tpu_torch.scenarios.spec import resolve_bench_behavior

    behavior, spec = resolve_bench_behavior(name)
    return dataclasses.replace(uncut_config(n, **grid_kw),
                               behavior=behavior, scenario=spec)


def behavior_world(cfg: WorldConfig, seed: int, device="cuda"):
    """(state, inputs, policy) of :func:`uncut_world` under ``cfg``'s
    behavior: the policy (``init_policy(POLICY_SEED)``, hidden 128)
    when the behavior or the scenario needs it, else None."""
    from goworld_tpu_torch.models.npc_policy import init_policy

    st, inputs = uncut_world(cfg, seed, device)
    policy = None
    if cfg.behavior == "mlp" or (cfg.scenario is not None
                                 and cfg.scenario.needs_policy):
        policy = init_policy(POLICY_SEED, device=st.device)
    return st, inputs, policy


def mlp_underflow_case(rows: int, seed: int, device="cuda"):
    """(obs, (w1, b1, w2, b2, w3, b3)) whose layer-2 products of the
    policy straddle 2^-126, where XLA's CPU runtime flushes them:
    observations near 2e-36 make layer 1's tanh outputs bf16 values near
    2^-115, and w2's words lie in [2^-11, 2^-9) (field 116-117), so the
    exponent fields of many factor pairs sum below ``ops.mlp.EXACT_LO``
    and the kernel must run layer 2 on the flushed mul and add. Hidden
    128, biases zero, w3 ~ 0.1 N(0, 1)."""
    hidden = 128
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.tensor(np.asarray(a, np.float32),
                            device=device).to(torch.bfloat16)
    obs = torch.tensor((rng.uniform(0.1, 0.2, (rows, 10)) * 1.5e-35)
                       .astype(np.float32), device=device)
    ws = (bf(rng.uniform(0.5, 1.0, (10, hidden))), bf(np.zeros(hidden)),
          bf(rng.uniform(2.0 ** -11, 2.0 ** -9, (hidden, hidden))),
          bf(np.zeros(hidden)), bf(rng.standard_normal((hidden, 3)) * 0.1),
          bf(np.zeros(3)))
    return obs, ws


def underflow_world(n: int, device="cuda", behavior: str = "mlp"):
    """``(cfg, state, inputs, policy)``: the mlp world of ``n`` rows
    whose observations are near 1e-38, driven by
    :func:`mlp_underflow_case`'s weights (w1's rows of cos(yaw) and the
    neighbor count zeroed), as ``tests/test_torch_cap.py``'s underflow
    case builds it: the bench layout (every slot an alive mover, 1% with
    a client, 8 at least, headings in (-7, 7)) from
    ``np.random.default_rng(0)`` on ``create_state(cfg, seed=1)``, then
    positions, headings and velocities scaled down from
    ``default_rng(3)``, and no position syncs. Its float ops underflow
    into subnormals, which XLA's CPU runtime flushes
    (``utils/fpenv.py``). ``behavior="random_walk"`` gives its twin: the
    same lanes and inputs under the random walk (policy None)."""
    from goworld_tpu_torch import interop
    from goworld_tpu_torch.models.npc_policy import MLPPolicy

    cfg = dataclasses.replace(slice_config(n, row_block=256),
                              behavior=behavior)
    g = cfg.grid
    lanes = interop.state_to_numpy(create_state(cfg, seed=1, device="cpu"))
    rng = np.random.default_rng(0)
    lanes["pos"][:, 0] = rng.uniform(0, g.extent_x, n)
    lanes["pos"][:, 2] = rng.uniform(0, g.extent_z, n)
    lanes["yaw"][:] = rng.uniform(-7, 7, n)
    lanes["alive"][:] = True
    lanes["npc_moving"][:] = True
    lanes["has_client"][:] = rng.random(n) < CLIENT_FRAC
    lanes["has_client"][:8] = True
    idx = np.zeros(cfg.input_cap, np.int32)
    idx[:64] = rng.choice(n, 64, replace=False)
    vals = np.zeros((cfg.input_cap, 4), np.float32)
    vals[:64, 0] = rng.uniform(0, g.extent_x, 64)
    vals[:64, 2] = rng.uniform(0, g.extent_z, 64)
    vals[:64, 3] = rng.uniform(0, 6, 64)
    rng = np.random.default_rng(3)
    for c in (0, 2):
        lanes["pos"][:, c] = rng.uniform(0.1, 0.2, n).astype(np.float32) \
            * np.float32(1e-35)
    lanes["yaw"][:] = rng.uniform(0.1, 0.2, n).astype(np.float32) \
        * np.float32(1e-38)
    lanes["vel"][:] = rng.uniform(0.1, 0.2, (n, 3)).astype(np.float32) \
        * np.float32(1e-37)
    inputs = interop.inputs_from_numpy(dict(
        pos_sync_idx=idx, pos_sync_vals=vals,
        pos_sync_n=np.asarray(0, np.int32)), device=device)
    state = interop.state_from_numpy(lanes, device=device)
    if behavior != "mlp":
        return cfg, state, inputs, None
    _, ws = mlp_underflow_case(4, 0, device=device)
    ws = list(ws)
    ws[0] = ws[0].clone()
    ws[0][6:8] = 0
    return cfg, state, inputs, MLPPolicy(*ws)


def bench_world(cfg: WorldConfig, seed: int, device="cuda"):
    """(state, inputs) of the bench world on ``device``."""
    return _world(cfg, seed, device, repeats=False)


def uncut_world(cfg: WorldConfig, seed: int, device="cuda"):
    """(state, inputs) of the bench world uncut on ``device``: as
    :func:`bench_world`, but the 4096 sync slots are drawn uniformly
    with repeats (``bench.py`` ``randint``). ``cfg`` is
    :func:`uncut_config` or a variant of it."""
    return _world(cfg, seed, device, repeats=True)


def _world(cfg: WorldConfig, seed: int, device, repeats: bool):
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
    idx[:ic] = rng.integers(0, n, ic) if repeats \
        else rng.choice(n, ic, replace=False)
    inputs = TickInputs(
        pos_sync_idx=torch.tensor(idx, device=dev),
        pos_sync_vals=torch.tensor(vals, device=dev),
        pos_sync_n=torch.tensor(ic, dtype=torch.int32, device=dev),
    )
    return st, inputs


def multi_config(spaces: int, n_per: int, **grid_kw) -> WorldConfig:
    """The config of each of ``spaces`` Spaces of ``n_per`` slots on one
    card: :func:`slice_config` of ``n_per`` (the bench's density, extent
    ``sqrt(n_per * 10000 / 12)`` a Space; caps are each Space's own).
    The World and :func:`multi_world` stack ``spaces`` of them."""
    if spaces < 1:
        raise ValueError(f"spaces must be >= 1, got {spaces}")
    return slice_config(n_per, **grid_kw)


def multi_world(cfg: WorldConfig, spaces: int, seed: int, device="cuda"):
    """(stacked state, stacked inputs) of ``spaces`` bench worlds, every
    lane ``[S, ...]``: Space d keyed ``seed * S + d`` (as
    ``create_multi_state`` keys it), its movers and ``min(input_cap,
    n)`` syncs to distinct slots drawn as :func:`bench_world` draws
    them, from one numpy generator."""
    n, g = cfg.capacity, cfg.grid
    rng = np.random.default_rng(seed)
    st = create_multi_state(cfg, spaces, seed=seed, device=device)
    dev = st.device
    pos = np.zeros((spaces, n, 3), np.float32)
    pos[..., 0] = rng.uniform(0, g.extent_x, (spaces, n))
    pos[..., 2] = rng.uniform(0, g.extent_z, (spaces, n))
    st = st.replace(
        pos=torch.tensor(pos, device=dev),
        alive=torch.ones((spaces, n), dtype=torch.bool, device=dev),
        npc_moving=torch.ones((spaces, n), dtype=torch.bool, device=dev),
        has_client=torch.tensor(rng.random((spaces, n)) < CLIENT_FRAC,
                                device=dev),
        client_gate=torch.zeros((spaces, n), dtype=torch.int32,
                                device=dev),
    )
    ic = min(cfg.input_cap, n)
    vals = np.zeros((spaces, cfg.input_cap, 4), np.float32)
    vals[:, :ic, 0] = rng.uniform(0, g.extent_x, (spaces, ic))
    vals[:, :ic, 2] = rng.uniform(0, g.extent_z, (spaces, ic))
    idx = np.zeros((spaces, cfg.input_cap), np.int32)
    for d in range(spaces):
        idx[d, :ic] = rng.choice(n, ic, replace=False)
    inputs = TickInputs(
        pos_sync_idx=torch.tensor(idx, device=dev),
        pos_sync_vals=torch.tensor(vals, device=dev),
        pos_sync_n=torch.full((spaces,), ic, dtype=torch.int32,
                              device=dev),
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


# the served game's per-tick traffic
SERVE_SYNCS = 4096      # client position syncs (distinct players)
SERVE_HP_SETS = 1024    # sets of the hot attr, some slots twice
SERVE_HP_TWICE = 64
SERVE_CHURN = 64        # destroys and as many creates
SERVE_SPARE = 4096      # slots left free for the churn (a Space)
SERVE_MIGRATIONS = 256  # enter_space moves between Spaces, with spaces > 1


class CountingSink:
    """The served World's ``sync_sink`` and ``client_sink``: the batched
    game-server path, counting what the World delivers (and keeping it
    too with ``keep=True``)."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.sync_records = 0
        self.sync_batches = 0
        self.messages: collections.Counter = collections.Counter()
        self.kept: list = []

    def sync(self, gate_id, cids, eids, vals) -> None:
        self.sync_records += len(cids)
        self.sync_batches += 1
        if self.keep:
            self.kept.append(("sync", gate_id, cids.copy(), eids.copy(),
                              vals.copy()))

    def client(self, gate_id, client_id, msg) -> None:
        self.messages[msg["type"]] += 1
        if self.keep:
            self.kept.append(("msg", gate_id, client_id, msg))

    def take(self) -> dict:
        """Counts (and kept items) since the last take."""
        out = dict(sync_records=self.sync_records,
                   sync_batches=self.sync_batches,
                   messages=dict(self.messages), kept=self.kept)
        self.sync_records = self.sync_batches = 0
        self.messages = collections.Counter()
        self.kept = []
        return out


@dataclasses.dataclass
class Served:
    """A populated serving World and the script of its traffic."""

    world: World
    arena: Space             # the first Space's Arena
    sink: CountingSink
    hooks: list | None
    rng: np.random.Generator
    mobs: list
    players: np.ndarray      # S16 ids of the client-bound players
    seed: int
    populate_s: float
    player_xz: np.ndarray    # f64[P, 2] where each player stands
    heading: np.ndarray      # f64[P] each player's walking direction
    created: int = 0
    boot_ticks: int = 0      # ticks the population entered through
    boot_events: int = 0     # their enter events
    arenas: list = dataclasses.field(default_factory=list)  # a Space each
    migrating: list = dataclasses.field(default_factory=list)
    # the world's (x, z) extent where it is not the grid's: a megaspace's
    # grid is one tile's, in tile-shifted coordinates
    extent: tuple | None = None

    def world_extent(self) -> tuple[float, float]:
        g = self.world.cfg.grid
        return self.extent or (g.extent_x, g.extent_z)

    def _new_id(self) -> str:
        self.created += 1
        return ids.gen_fixed_id(f"serve.{self.seed}.{self.created}")

    def _pos(self, k: int) -> np.ndarray:
        ex, ez = self.world_extent()
        xz = np.zeros((k, 3), np.float64)
        xz[:, 0] = self.rng.uniform(0, ex, k)
        xz[:, 2] = self.rng.uniform(0, ez, k)
        return xz

    def stage(self, teleport: bool = False) -> dict:
        """Stage one tick's traffic: SERVE_SYNCS client position syncs to
        distinct players (``stage_pos_sync_batch``), SERVE_HP_SETS sets
        of the mobs' ``hp`` (SERVE_HP_TWICE mobs set twice), then
        SERVE_CHURN mob destroys and as many creates.

        A sync walks its player one step of ``npc_speed * dt`` (a mob's
        step) along its heading from where it stands; a heading turns at
        random with the random walk's ``turn_prob`` and reflects at the
        world's edges. With ``teleport`` each sync goes to a uniform
        point of the extent instead: the bench's input stream, a stress
        case that changes more interest lists a tick than the World's
        caps hold.

        With several Spaces, after the destroys, SERVE_MIGRATIONS
        entities (mobs and players alike) each ``enter_space`` another
        random Space at a uniform point, which the World repacks at its
        next flush (:meth:`migrated` counts those that arrived); the
        creates then land in random Spaces."""
        w, rng = self.world, self.rng
        cfg, g = w.cfg, w.cfg.grid
        k = min(SERVE_SYNCS, self.players.size)
        who = rng.choice(self.players.size, k, replace=False)
        if teleport:
            xz = self._pos(k)[:, [0, 2]]
            self.heading[who] = rng.uniform(0, 2 * np.pi, k)
        else:
            turn = rng.random(k) < cfg.turn_prob
            self.heading[who[turn]] = rng.uniform(0, 2 * np.pi,
                                                  int(turn.sum()))
            step = cfg.npc_speed * cfg.dt
            xz = self.player_xz[who] + step * np.stack(
                [np.cos(self.heading[who]), np.sin(self.heading[who])], 1)
            ext = np.array(self.world_extent())
            out = (xz < 0) | (xz > ext)
            xz = np.clip(xz, 0, ext)
            h = self.heading[who]
            h = np.where(out[:, 0], np.pi - h, h)
            self.heading[who] = np.where(out[:, 1], -h, h)
        self.player_xz[who] = xz
        vals = np.zeros((k, 4), np.float32)
        vals[:, [0, 2]] = xz
        vals[:, 3] = self.heading[who]
        synced = w.stage_pos_sync_batch(self.players[who], vals)
        once = SERVE_HP_SETS - SERVE_HP_TWICE
        pick = rng.choice(len(self.mobs), once, replace=False)
        hp = rng.integers(1, 100, SERVE_HP_SETS)
        for i, m in enumerate(np.concatenate([pick, pick[:SERVE_HP_TWICE]])):
            w.entities[self.mobs[m]].attrs["hp"] = int(hp[i])
        for m in sorted(rng.choice(len(self.mobs), SERVE_CHURN,
                                   replace=False), reverse=True):
            w.entities[self.mobs[m]].destroy()
            self.mobs[m] = self.mobs[-1]
            self.mobs.pop()
        staged = dict(syncs=synced, hp_sets=SERVE_HP_SETS,
                      destroys=SERVE_CHURN, creates=SERVE_CHURN)
        several = len(self.arenas) > 1
        if several:
            # before the creates: a row whose spawn is still staged has
            # nothing on the device for the repack to read
            staged["migrations"] = self._migrate(SERVE_MIGRATIONS)
        for p in self._pos(SERVE_CHURN):
            arena = self.arenas[rng.integers(len(self.arenas))] \
                if several else self.arena
            e = arena.create_entity("Mob", pos=tuple(p),
                                    eid=self._new_id(), moving=True,
                                    attrs={"hp": 100})
            self.mobs.append(e.id)
        return staged

    def _migrate(self, k: int) -> int:
        """Stage ``k`` moves of distinct entities, each into another
        random Space at a uniform point; returns how many went staged
        (both Spaces AOI shards: all of them)."""
        w, rng = self.world, self.rng
        n_mobs = len(self.mobs)
        pick = rng.choice(n_mobs + self.players.size, k, replace=False)
        targets = rng.integers(1, len(self.arenas), k)
        where = self._pos(k)
        self.migrating = []
        for i, t, p in zip(pick, targets, where):
            if i < n_mobs:
                e = w.entities[self.mobs[i]]
            else:
                j = i - n_mobs
                e = w.entities[self.players[j].decode()]
                self.player_xz[j] = p[[0, 2]]
            dst = self.arenas[(e.space.shard + t) % len(self.arenas)]
            e.enter_space(dst.id, tuple(p))
            if e._migrating is not None:
                self.migrating.append((e.id, dst.shard))
        return len(self.migrating)

    def migrated(self) -> int:
        """How many of the last tick's staged moves arrived: the entity
        holds a row of its destination Space and no migration."""
        w = self.world
        return sum(1 for eid, dst in self.migrating
                   if (e := w.entities.get(eid)) is not None
                   and e._migrating is None and e.shard == dst
                   and e.slot is not None)


def _game_types(hooks: list | None):
    class Mob(Entity):
        ATTRS = {"hp": "allclients hot:0"}

    class Player(Entity):
        ATTRS = {"hp": "allclients hot:0"}

    class Arena(Space):
        pass

    if hooks is not None:
        def enter(self, other):
            hooks.append(("enter", self.id, other.id))

        def leave(self, other):
            hooks.append(("leave", self.id, other.id))

        def space_enter(self, e):
            hooks.append(("space_enter", e.id))

        for cls in (Mob, Player):
            cls.OnEnterAOI, cls.OnLeaveAOI = enter, leave
        Arena.OnEntityEnterSpace = space_enter
    return Mob, Player, Arena


def serve_world(n: int, seed: int, device="cuda", *,
                record_hooks: bool = False, keep: bool = False,
                boot: bool = False, world_kw: dict | None = None,
                spaces: int = 1, behavior: str = "random_walk",
                mesh: bool = False, mega_shape: tuple | None = None,
                halo_impl: str = "async", spare: int = SERVE_SPARE,
                **grid_kw) -> Served:
    """A served game on ``slice_config(n, **grid_kw)``: one ``World``
    (at its defaults, the planes on, or with ``world_kw``) with one AOI
    Space ("Arena") and two types, ``Mob`` (a random-walk mover,
    ``ATTRS={"hp": "allclients hot:0"}``) and ``Player`` (bound to a
    ``GameClient``, moved by client syncs). ``n - SERVE_SPARE``
    entities are created through ``Space.create_entity`` at positions
    uniform over the extent from ``np.random.default_rng(seed)``,
    CLIENT_FRAC of them players; the Mobs move by ``behavior`` (the
    World draws the mlp policy from ``seed``). The sinks count (``keep`` also keeps
    what they get); with ``record_hooks`` the AOI and space-enter hooks
    append to ``Served.hooks``.

    Without ``boot`` the whole population enters on the first tick the
    caller runs, whose enter events far exceed ``enter_cap``: the
    decoded interest sets are then missing most pairs for good (a
    capped, lossy state that the audit plane reports). With ``boot``
    the population enters through ticks run here, in batches sized so
    that a tick's enter events stay within half of ``enter_cap``
    (:func:`_boot_batch`), and a boot tick whose events overflow any
    cap raises: the served game starts with exact interest sets.

    With ``spaces > 1`` the World hosts that many Spaces of ``n`` slots
    (``World(cfg, n_spaces=spaces)``), an Arena each, each populated as
    above; a boot tick enters a batch into every Space, its caps checked
    in every Space.

    The population ends as the JAX package's game server boots
    (``net/game.py`` ``serve_forever``, ini ``gc_freeze``): one
    ``gc.collect()`` and ``gc.freeze()`` move the populated world into
    the collector's permanent generation, so no later collection walks
    it (a pass over ~10^7 objects stalls a tick for seconds). The
    freeze is process-wide; ``gc.unfreeze()`` hands the objects back.

    ``mesh`` builds the World of ``spaces`` Spaces on a mesh
    (``parallel.mesh.make_mesh(spaces)``: ``enter_space`` moves ride the
    step's exchange). ``mega_shape=(tx, tz)`` builds a megaspace World
    instead: one Arena over ``tx * tz`` tiles of ``n`` slots, each tile
    :func:`slice_config`'s extent at ``n`` (so the bench's density),
    ``halo_impl`` shipping the halo, and ``(n - SERVE_SPARE) * tx * tz``
    entities over the whole world. ``spare`` slots a Space (or tile)
    stay free for the churn."""
    cfg = dataclasses.replace(slice_config(n, **grid_kw), behavior=behavior)
    hooks = [] if record_hooks else None
    mob_cls, player_cls, arena_cls = _game_types(hooks)
    t0 = time.perf_counter()
    kw = dict(world_kw or {})
    extent = None
    tiles = 1
    if mega_shape is not None:
        tx, tz = mega_shape
        tiles = tx * tz
        g, r = cfg.grid, cfg.grid.radius
        extent = (tx * g.extent_x, tz * g.extent_z)
        cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
            g, extent_x=g.extent_x + 2 * r,
            extent_z=g.extent_z + 2 * r if tz > 1 else g.extent_z))
        kw.update(mesh=make_mesh(tiles, device=device), megaspace=True,
                  mega_shape=mega_shape if tz > 1 else None,
                  halo_impl=halo_impl)
        spaces = tiles
    elif mesh:
        kw.update(mesh=make_mesh(spaces, device=device))
    w = World(cfg, spaces, seed=seed, device=device, **kw)
    w.register_entity("Mob", mob_cls)
    w.register_entity("Player", player_cls)
    w.register_space("Arena", arena_cls, megaspace=mega_shape is not None)
    w.create_nil_space()
    sink = CountingSink(keep)
    w.sync_sink = sink.sync
    w.client_sink = sink.client
    arenas = [w.create_space("Arena",
                             eid=ids.gen_fixed_id(f"arena.{seed}"
                                                  + (f".{d}" if d else "")))
              for d in range(1 if mega_shape else spaces)]
    arena = arenas[0]
    rng = np.random.default_rng(seed)
    served = Served(world=w, arena=arena, sink=sink, hooks=hooks, rng=rng,
                    mobs=[], players=np.zeros(0, "S16"), seed=seed,
                    populate_s=0.0, player_xz=np.zeros((0, 2)),
                    heading=np.zeros(0), arenas=arenas, extent=extent)
    # a megaspace's population is one Arena's: tiles x a Space's
    pop = (n - spare) * tiles
    spaces = len(arenas)
    pos = served._pos(pop * spaces)
    is_player = rng.random(pop * spaces) < CLIENT_FRAC
    players = []
    player_xz = []

    def create(lo: int, hi: int, d: int = 0) -> None:
        arena = arenas[d]
        for i in range(d * pop + lo, d * pop + hi):
            p = tuple(pos[i])
            if is_player[i]:
                player_xz.append(pos[i, [0, 2]])
                e = arena.create_entity(
                    "Player", pos=p, eid=served._new_id(),
                    attrs={"hp": 100},
                    client=GameClient(0, f"c{i:015d}", w))
                players.append(e.id)
            else:
                e = arena.create_entity("Mob", pos=p, eid=served._new_id(),
                                        moving=True, attrs={"hp": 100})
                served.mobs.append(e.id)

    if boot:
        done = 0
        while done < pop:
            # a megaspace's batch spreads over its tiles
            hi = min(pop, done + tiles * _boot_batch(cfg, done // tiles))
            for d in range(spaces):
                create(done, hi, d)
            done = hi
            w.tick()
            # a pipelined World decodes each boot tick at once, so that
            # its caps are checked on its own outputs
            w.flush_pending_outputs()
            out = w.last_outputs
            out = getattr(out, "base", out)
            for lane, cap in (("enter_n", cfg.enter_cap),
                              ("leave_n", cfg.leave_cap),
                              ("delta_rows_n", cfg.delta_rows_cap_eff)):
                if int(getattr(out, lane).max()) > cap:
                    raise RuntimeError(
                        f"boot tick {w.tick_count}: {lane} "
                        f"{getattr(out, lane).tolist()} > {cap}")
            served.boot_ticks += 1
            served.boot_events += int(out.enter_n.sum())
            sink.take()
    else:
        for d in range(spaces):
            create(0, pop, d)
    served.players = np.array(players, "S16")
    served.player_xz = np.array(player_xz, np.float64).reshape(-1, 2)
    served.heading = rng.uniform(0, 2 * np.pi, served.players.size)
    gc.collect()
    gc.freeze()
    served.populate_s = time.perf_counter() - t0
    return served


def _boot_batch(cfg: WorldConfig, present: int) -> int:
    """How many entities may enter on one boot tick with ``present``
    already in: a new entity has ``nb * (present + B) / capacity``
    neighbours at ``nb`` neighbours a full world (``nb`` = capacity x
    (2 radius)^2 / extent area; 12 in :func:`slice_config`), and each
    pair with an entity already present gives two enter events, so B
    new entities give ``nb * B * (2 present + B) / capacity`` of them;
    B is the largest batch whose events stay within half of
    ``enter_cap`` (the other half is left for the movers' own)."""
    g = cfg.grid
    n = cfg.capacity
    nb = n * (2.0 * g.radius) ** 2 / (g.extent_x * g.extent_z)
    budget = cfg.enter_cap / 2.0
    b = -present + np.sqrt(present ** 2 + budget * n / nb)
    return max(1, int(b))
