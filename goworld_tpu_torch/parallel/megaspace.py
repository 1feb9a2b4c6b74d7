"""One large Space sharded as spatial tiles (megaspace), the port of
``goworld_tpu/parallel/megaspace.py``.

Entities live in tiles (x strips in 1D, XZ rectangles in 2D); AOI sees
across tile borders through the halo ghost exchange
(:mod:`goworld_tpu_torch.parallel.halo`), and entities that cross a
border migrate automatically (:mod:`goworld_tpu_torch.parallel.migrate`).
Identity across the megaspace is the global id ``gid = tile * N +
slot``; neighbor lists in the state hold gids (sentinel ``n_dev * N``),
and enter/leave/sync records name gids.

Tile placement: the JAX package runs one tile per device under
``shard_map``. Here every tile lives on one device, in the JAX layout (a
leading ``[n_dev]`` axis on every lane). The tick loops over tiles in
Python and runs the single-Space ops and kernels on each tile's view;
the exchange points act on all tiles at once: the migration
``all_to_all`` is a transpose of the stacked send buffers, the
``psum`` a sum, and each halo exchange phase one launch of the CUDA
kernel of ``csrc/halo_ship.cu``. Tiles on several cards are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import (
    SpaceState,
    WorldConfig,
    check_ported,
    resolve_device,
)
from goworld_tpu_torch.core.step import (TickOutputs, compute_velocity,
                                         contracted_rows)
from goworld_tpu_torch.models.npc_policy import neighbor_mean_offset
from goworld_tpu_torch.ops import prng
from goworld_tpu_torch.ops.aoi import (
    ROADMAP_HINT,
    _f32,
    grid_neighbors_flags,
)
from goworld_tpu_torch.ops.delta import interest_pairs
from goworld_tpu_torch.ops.integrate import apply_pos_inputs, integrate
from goworld_tpu_torch.ops.sync import collect_attr_deltas, collect_sync
from goworld_tpu_torch.parallel import migrate as mig
from goworld_tpu_torch.parallel.halo import (
    HALO_IMPLS,
    exchange_halo,
    exchange_halo_2d,
    meta_gid_bound,
)
from goworld_tpu_torch.parallel.mesh import (
    create_multi_state,
    stack_states,
    tile_view,
)
from goworld_tpu_torch.parallel.step import MultiTickInputs
from goworld_tpu_torch.scenarios.behaviors import scenario_velocity


@dataclasses.dataclass(frozen=True)
class MegaConfig:
    """Static megaspace configuration, field for field the JAX package's
    ``MegaConfig`` with the same checks.

    ``cfg.grid`` is the tile-local grid in shifted coordinates: origin
    0, ``extent_x = tile_w + 2 * radius`` (one halo margin each side).
    1D (``mesh_shape=None``): tiles are x strips and ``extent_z`` is the
    world's z extent. 2D (``mesh_shape=(tx, tz)``): tile ``d`` is ``(d //
    tz, d % tz)`` of size ``tile_w x tile_d`` and ``extent_z = tile_d +
    2 * radius``. ``halo_impl`` is "ppermute" (each lane shipped plain)
    or "async" (the phase kernel, one launch an exchange phase).
    """

    cfg: WorldConfig
    n_dev: int
    tile_w: float
    halo_cap: int = 1024
    migrate_cap: int = 256
    mesh_shape: tuple[int, int] | None = None  # (tx, tz); None = (n_dev, 1)
    tile_d: float = 0.0                        # z tile depth (2D only)
    halo_impl: str = "ppermute"

    def __post_init__(self):
        g = self.cfg.grid
        if self.cfg.scenario is not None \
                and "btree" in self.cfg.scenario.behavior_names:
            # the tile step feeds behaviors from summary lanes that carry
            # no nearest-client offset; the JAX package refuses it too
            raise ValueError(
                "megaspace scenarios cannot include the 'btree' mix "
                "member: the tile step's summary features carry no "
                "nearest-client offset (pick a non-btree mix, or run "
                "cfg.behavior='btree' homogeneous)"
            )
        if self.halo_impl not in HALO_IMPLS:
            raise ValueError(
                f"halo_impl {self.halo_impl!r} not in {HALO_IMPLS}"
            )
        if self.halo_impl == "async" \
                and self.n_dev * self.cfg.capacity > meta_gid_bound():
            raise ValueError(
                "halo_impl='async' packs gids into a 29-bit meta lane; "
                f"n_dev * capacity = {self.n_dev * self.cfg.capacity} "
                f"exceeds {meta_gid_bound()} — use halo_impl='ppermute'"
            )
        expected = self.tile_w + 2.0 * g.radius
        if abs(g.extent_x - expected) > 1e-6:
            raise ValueError(
                f"grid.extent_x must be tile_w + 2*radius = {expected}, "
                f"got {g.extent_x}"
            )
        if g.origin_x != 0.0 or g.origin_z != 0.0:
            raise ValueError(
                "megaspace grids use tile-shifted coordinates; "
                "grid.origin_x/origin_z must be 0"
            )
        if g.radius > self.tile_w:
            # the halo is one hop each way: a radius wider than a tile
            # would need neighbors of neighbors, which never arrive
            raise ValueError(
                f"grid.radius ({g.radius}) must be <= tile_w "
                f"({self.tile_w}) for adjacent-tile halo exchange"
            )
        if self.mesh_shape is not None:
            tx, tz = self.mesh_shape
            if tx * tz != self.n_dev:
                raise ValueError(
                    f"mesh_shape {self.mesh_shape} != n_dev {self.n_dev}"
                )
            if tz > 1:
                if self.tile_d <= 0:
                    raise ValueError("2D megaspace requires tile_d > 0")
                if g.radius > self.tile_d:
                    raise ValueError(
                        f"grid.radius ({g.radius}) must be <= tile_d "
                        f"({self.tile_d})"
                    )
                expected_z = self.tile_d + 2.0 * g.radius
                if abs(g.extent_z - expected_z) > 1e-6:
                    raise ValueError(
                        "2D megaspace: grid.extent_z must be "
                        f"tile_d + 2*radius = {expected_z}, got "
                        f"{g.extent_z}"
                    )

    @property
    def shape(self) -> tuple[int, int]:
        return self.mesh_shape or (self.n_dev, 1)

    @property
    def is_2d(self) -> bool:
        return self.shape[1] > 1

    @property
    def world_x(self) -> float:
        return self.tile_w * self.shape[0]

    @property
    def world_z(self) -> float:
        if self.is_2d:
            return self.tile_d * self.shape[1]
        return self.cfg.grid.extent_z

    @property
    def ghost_rows(self) -> int:
        return (4 if self.is_2d else 2) * self.halo_cap

    @property
    def gid_sentinel(self) -> int:
        return self.n_dev * self.cfg.capacity

    def tile_of(self, x: float, z: float) -> int:
        """Owning tile of a world coordinate (host-side placement)."""
        tx, tz = self.shape
        ix = max(0, min(tx - 1, int(x // self.tile_w)))
        if not self.is_2d:
            return ix
        iz = max(0, min(tz - 1, int(z // self.tile_d)))
        return ix * tz + iz


@dataclasses.dataclass(frozen=True)
class MegaTickOutputs:
    base: TickOutputs            # lanes [n_dev, ...]; j ids are gids
    arr_tag: torch.Tensor        # i32[n_dev, n_dev*mcap] old gid of arrival
    arr_slot: torch.Tensor       # i32[n_dev, n_dev*mcap] new local slot
    arr_n: torch.Tensor          # i32[n_dev]
    migrate_dropped: torch.Tensor  # i32[n_dev]
    migrate_demand: torch.Tensor   # i32[n_dev, n_dev] true per-dest count
    halo_demand: torch.Tensor    # i32[n_dev] boundary strip occupancy
    global_alive: torch.Tensor   # i32[n_dev]


def _check_mega_ported(mc: MegaConfig, devices) -> None:
    """Raise ``NotImplementedError`` for what this port does not run
    yet; it never substitutes another placement or path."""
    check_ported(mc.cfg)
    if mc.cfg.grid.precision != "off":
        raise NotImplementedError(
            f"precision='q16' in the megaspace {ROADMAP_HINT}")
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            f"tiles on several cards (devices={list(devices)}) "
            f"{ROADMAP_HINT}")


def _placement(device, devices):
    if devices is not None and len(devices) == 1:
        device = devices[0]
    return resolve_device(device)


def create_mega_state(mc: MegaConfig, seed: int = 0, device="cuda",
                      devices=None) -> SpaceState:
    """Stacked per-tile state with global-id neighbor lists, on
    ``device`` (the card unless the caller asks for the CPU)."""
    _check_mega_ported(mc, devices)
    st = create_multi_state(mc.cfg, mc.n_dev, seed,
                            device=_placement(device, devices))
    return st.replace(
        nbr=torch.full_like(st.nbr, mc.gid_sentinel),
        nbr_cnt=torch.zeros_like(st.nbr_cnt),
    )


def _stack_outputs(outs, cls):
    return cls(**{
        f.name: None if getattr(outs[0], f.name) is None
        else torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(cls)
    })


def tile_shifts(mc: MegaConfig, dev) -> torch.Tensor:
    """f32[n_dev, 3]: each tile's shift into tile-local coordinates,
    ``(tile_min_x - radius, 0, tile_min_z - radius)`` (z stays 0 in 1D),
    in float32 as the JAX package computes it."""
    tz = mc.shape[1]
    d = torch.arange(mc.n_dev, device=dev)
    r = _f32(mc.cfg.grid.radius, dev)
    sx = (d // tz).to(torch.float32) * _f32(mc.tile_w, dev) - r
    if mc.is_2d:
        sz = (d % tz).to(torch.float32) * _f32(mc.tile_d, dev) - r
    else:
        sz = torch.zeros(mc.n_dev, dtype=torch.float32, device=dev)
    return torch.stack([sx, torch.zeros_like(sx), sz], dim=1)


def mega_tick_body(mc: MegaConfig, state: SpaceState,
                   inputs: MultiTickInputs, shifts: torch.Tensor,
                   policy=None):
    """One megaspace tick over stacked tiles. Returns a new state and
    the outputs; the lanes of ``state`` are not modified. See
    :func:`make_mega_tick`."""
    cfg = mc.cfg
    n = cfg.capacity
    n_dev = mc.n_dev
    tx, tz = mc.shape
    gsent = mc.gid_sentinel
    ghost_rows = mc.ghost_rows
    dev = state.pos.device
    tile_w, tile_d = _f32(mc.tile_w, dev), _f32(mc.tile_d, dev)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    # with a skin the tiles keep the stateless sweep (over cells of
    # radius + skin), as the JAX megaspace does: the Verlet cache lane
    # rides along untouched
    aoi_cache = state.aoi_cache
    state = state.replace(aoi_cache=None)

    # 1. inputs, behaviors and integration over the whole world, then
    #    tile targeting and the emigrant pack, tile by tile
    tiles, pre_dirty, departed, sends = [], [], [], []
    for d in range(n_dev):
        st = tile_view(state, d)
        base = inputs.base
        pos, yaw, touched = apply_pos_inputs(
            st.pos, st.yaw, base.pos_sync_idx[d], base.pos_sync_vals[d],
            base.pos_sync_n[d])
        keys = prng.split(st.rng)
        rng, k_behave = keys[0], keys[1]
        # gid neighbor lists cannot gather positions: the behaviors read
        # the summary lanes the previous tick's sweep left, and the
        # scenario schedule is anchored to the world's bounds
        tele = fused = None
        if cfg.scenario is not None:
            vel, tele_pos, tele = scenario_velocity(
                cfg, k_behave, pos, yaw, st, policy,
                bounds=(0.0, 0.0, mc.world_x, mc.world_z),
                features=(st.nbr_mean_off,
                          st.nbr_client_cnt.to(torch.float32),
                          torch.zeros_like(st.nbr_mean_off)))
        else:
            vel, fused = compute_velocity(cfg, k_behave, pos, yaw, st,
                                          policy, (mc.world_x, mc.world_z))
        fused = contracted_rows(cfg, vel, st, fused)
        pos, moved = integrate(pos, vel, st.npc_moving, cfg.dt,
                               (0.0, -1e9, 0.0),
                               (mc.world_x, 1e9, mc.world_z), fused=fused)
        if tele is not None:
            # a cross-tile teleport migrates on this tick
            pos = torch.where(tele[:, None], tele_pos, pos)
            moved = moved | tele
        st = st.replace(pos=pos, yaw=yaw, vel=vel, rng=rng)
        dirty = (moved | touched | st.dirty) & st.alive

        # 2. automatic tile migration from position
        tgt = torch.clamp(torch.floor(pos[:, 0] / tile_w).to(torch.int32),
                          0, tx - 1)
        if mc.is_2d:
            tgt_iz = torch.clamp(
                torch.floor(pos[:, 2] / tile_d).to(torch.int32), 0, tz - 1)
            tgt = tgt * tz + tgt_iz
        tgt = torch.where(st.alive & (tgt != d), tgt, -1)
        fbuf, ibuf, gone, demand = mig.pack_emigrants(
            st, tgt, d * n + slots, n_dev, mc.migrate_cap)
        tiles.append(mig.despawn_departed(st, gone))
        pre_dirty.append(dirty & ~gone)
        departed.append(gone)
        sends.append((fbuf, ibuf, demand))

    # the all_to_all: tile d receives block d of every sender's buffer
    recv_f = torch.stack([s[0] for s in sends]).transpose(0, 1)
    recv_i = torch.stack([s[1] for s in sends]).transpose(0, 1)
    arrivals = []
    for d in range(n_dev):
        st, *arr = mig.insert_arrivals(tiles[d], recv_f[d], recv_i[d],
                                       nbr_sentinel=gsent,
                                       quarantine=departed[d])
        tiles[d] = st
        pre_dirty[d] = pre_dirty[d] | st.dirty   # arrivals force-sync
        arrivals.append(arr)
    dirty = torch.stack(pre_dirty)

    # 3. halo ghost exchange; AOI-excluded entities never ship
    pos_all = torch.stack([st.pos for st in tiles])
    yaw_all = torch.stack([st.yaw for st in tiles])
    alive_all = torch.stack([st.alive for st in tiles])
    visible = alive_all & (torch.stack([st.aoi_radius for st in tiles])
                           > 0.0)
    if mc.is_2d:
        gpos, gyaw, gdirty, gvalid, ggid, halo_demand = exchange_halo_2d(
            (tx, tz), n, pos_all, yaw_all, dirty, visible, mc.tile_w,
            mc.tile_d, cfg.grid.radius, mc.halo_cap, impl=mc.halo_impl)
    else:
        gpos, gyaw, gdirty, gvalid, ggid, halo_demand = exchange_halo(
            n_dev, pos_all, yaw_all, dirty, visible, mc.tile_w,
            cfg.grid.radius, mc.halo_cap, impl=mc.halo_impl)

    # 4-7. per tile: AOI over local + ghost rows in tile-shifted
    #      coordinates (ghosts are candidates, never watchers), gid
    #      translation, interest diff, sync and attr records
    p_ext = n + ghost_rows
    wants_features = (cfg.behavior in ("mlp", "btree")
                      if cfg.scenario is None
                      else cfg.scenario.needs_features)
    inf_w = torch.full((ghost_rows,), float("inf"), dtype=torch.float32,
                       device=dev)
    no_client = torch.zeros(ghost_rows, dtype=torch.bool, device=dev)
    new_tiles, outs = [], []
    for d in range(n_dev):
        st = tiles[d]
        pos_ext = torch.cat([st.pos, gpos[d]])
        dirty_ext = torch.cat([dirty[d], gdirty[d]])
        hc_ext = torch.cat([st.has_client, no_client])
        nbr_ext, nbr_cnt, nbr_fl, aoi_stats = grid_neighbors_flags(
            cfg.grid, pos_ext - shifts[d], torch.cat([st.alive, gvalid[d]]),
            query_rows=n, watch_radius=torch.cat([st.aoi_radius, inf_w]),
            flag_bits=dirty_ext.to(torch.int32)
            | (hc_ext.to(torch.int32) << 1),
            with_stats=True,
        )
        # next tick's behavior features, while nbr_ext still indexes
        # pos_ext (the gid translation below loses the positions)
        mean_off = (neighbor_mean_offset(pos_ext, st.pos, nbr_ext, nbr_cnt,
                                         p_ext)
                    if wants_features else st.nbr_mean_off)
        gid_ext = torch.cat([d * n + slots, ggid[d]])
        nbr_gid = torch.where(
            nbr_ext == p_ext, gsent,
            gid_ext[torch.clamp_max(nbr_ext, p_ext - 1).long()])
        nbr_gid = torch.sort(nbr_gid, dim=1).values
        (enter_w, enter_j, enter_n, leave_w, leave_j, leave_n,
         delta_rows_n) = interest_pairs(
            st.nbr, nbr_gid, gsent, cfg.enter_cap, cfg.leave_cap,
            min(cfg.delta_rows_cap_eff, n))
        sync_w, sync_j, sync_vals, sync_n = collect_sync(
            nbr_ext, dirty_ext, st.has_client, pos_ext,
            torch.cat([st.yaw, gyaw[d]]), cfg.sync_cap,
            nbr_dirty=(nbr_fl & 1).bool())
        sync_j = torch.where(
            sync_j >= 0,
            gid_ext[torch.clamp(sync_j, 0, p_ext - 1).long()], -1)
        attr_e, attr_i, attr_v, attr_n = collect_attr_deltas(
            st.hot_attrs, st.attr_dirty, cfg.attr_sync_cap)
        new_tiles.append(st.replace(
            nbr=nbr_gid,
            nbr_cnt=nbr_cnt,
            nbr_client_cnt=((nbr_fl >> 1) & 1).sum(dim=1,
                                                  dtype=torch.int32),
            nbr_mean_off=mean_off,
            dirty=torch.zeros_like(st.dirty),
            attr_dirty=torch.zeros_like(st.attr_dirty),
            tick=st.tick + 1,
        ))
        outs.append(TickOutputs(
            enter_w=enter_w, enter_j=enter_j, enter_n=enter_n,
            leave_w=leave_w, leave_j=leave_j, leave_n=leave_n,
            delta_rows_n=delta_rows_n,
            sync_w=sync_w, sync_j=sync_j, sync_vals=sync_vals,
            sync_n=sync_n,
            attr_e=attr_e, attr_i=attr_i, attr_v=attr_v, attr_n=attr_n,
            alive_count=st.alive.sum(dtype=torch.int32),
            aoi_demand_max=aoi_stats[0], aoi_over_k_rows=aoi_stats[1],
            aoi_cell_max=aoi_stats[2], aoi_over_cap_cells=aoi_stats[3],
            # the megaspace sweep keeps no Verlet cache: no skin telemetry
            aoi_rebuilt=None, aoi_skin_slack=None,
        ))

    base = _stack_outputs(outs, TickOutputs)
    # the psum: every tile reads the megaspace's total
    global_alive = base.alive_count.sum(dtype=torch.int32).repeat(n_dev)
    outputs = MegaTickOutputs(
        base=base,
        arr_tag=torch.stack([a[0] for a in arrivals]),
        arr_slot=torch.stack([a[1] for a in arrivals]),
        arr_n=torch.stack([a[2] for a in arrivals]),
        migrate_dropped=torch.stack([a[3] for a in arrivals]),
        migrate_demand=torch.stack([s[2] for s in sends]),
        halo_demand=halo_demand,
        global_alive=global_alive,
    )
    return stack_states(new_tiles).replace(aoi_cache=aoi_cache), outputs


def make_mega_tick(mc: MegaConfig, device="cuda", devices=None):
    """Build the megaspace tick on ``device`` (the card unless the
    caller asks for the CPU). ``devices`` naming more than one card
    raises ``NotImplementedError``: tiles on several cards are not
    ported yet.

    Returns ``tick(states, inputs, policy=None) -> (states,
    MegaTickOutputs)`` with leading [n_dev] axes;
    ``inputs.migrate_target`` is ignored (tile migration follows
    position). The tick returns new tensors (the JAX package's
    ``donate`` has no counterpart).
    """
    _check_mega_ported(mc, devices)
    dev = _placement(device, devices)
    shifts = tile_shifts(mc, dev)

    def tick(state: SpaceState, inputs: MultiTickInputs, policy=None):
        if state.device.type != dev.type:
            raise ValueError(
                f"state lives on {state.device}, the tick on {dev}")
        if state.pos.dim() != 3 or state.pos.shape[0] != mc.n_dev:
            raise ValueError(
                f"expected a stacked state of {mc.n_dev} tiles, got pos "
                f"{tuple(state.pos.shape)}")
        return mega_tick_body(mc, state, inputs, shifts, policy)

    return tick
