"""World — the host-side entity manager and tick driver, the port of
``goworld_tpu/entity/manager.py``.

Reference being rebuilt: ``engine/entity/EntityManager.go`` (type registry,
id->entity maps, create/load/restore, RPC entry — ``:155-434``) fused with
the game process's serve loop (``components/game/GameService.go:77-190``):
the host stages all mutations between ticks, flushes them as vectorized
scatters, runs ONE device step, and fans the step's event arrays back out
to Python hooks and client messages.

Everything here is the JAX World's Python and numpy, except its
device seams, rewritten for torch:

* the step (:func:`_make_local_tick`): one Space runs ``make_tick`` on
  its view of the stacked ``[1, ...]`` state, its outputs restacked as
  ``unsqueeze(0)`` views; several run the batched ``make_tick`` on the
  ``[S, ...]`` lanes, one launch of each kernel for all Spaces, without
  the skin (the JAX World vmaps its step there and clears the skin);
  with ``resident=True`` (the default) the new carry is copied into the
  old carry's storage (:func:`_carry_into`), so every lane keeps its
  address from tick to tick;
* the live telemetry fold (:mod:`goworld_tpu_torch.ops.telemetry`): the
  tick's health signals folded into device-resident histogram lanes in
  place, with no host sync;
* the staging flush (:meth:`World._flush_staging`): every host lane of a
  flush is built once in numpy, packed into one pinned buffer and copied
  with one non-blocking copy; the scatters write the real rows only
  (no padding buckets, since torch compiles nothing per shape), each at
  its flat row ``shard * capacity + slot``, write each (row, column)
  once, keeping the last staged value on the host (a CUDA
  ``index_put_`` with duplicate indices writes them in no fixed order),
  and never read the device from the host but once, on a tick with
  staged migrations between Spaces: one gather of every migrating row
  and one device-to-host copy, as the JAX World's one ``device_get``;
* the output fetch (:meth:`World._fetch`): every output lane, the
  telemetry accumulator and, on an audit sample tick, the audit's
  ``pos``/``alive``/``aoi_radius`` planes in one device-to-host copy and
  one stream synchronisation, as numpy arrays in the JAX package's
  types, so the decode (:meth:`World._process_outputs`) is the JAX
  decode; with ``pipeline_decode`` the copy of tick N's outputs and
  accumulator rides a copy stream into pinned memory while tick N + 1
  runs (:meth:`World._start_copy`), and tick N + 1's fetch waits for
  that copy's event alone;
* the lazy per-tick position and yaw caches (:meth:`World.read_pos`,
  :meth:`World.read_yaw`).

The World runs the JAX World's default planes, host code as it is
there: the live telemetry lanes with their workload and window
signatures, the sync-age anchor, the residency plane
(:mod:`goworld_tpu_torch.utils.residency`: phase marks, bubble, gc, the
carry's census on ``data_ptr()`` and the caching allocator's stats) and
the audit plane (:mod:`goworld_tpu_torch.utils.audit`: the entity
ledger and a rotating cohort judged against a brute-force oracle on a
worker thread). A plane that fails disables itself and logs, as in the
reference; a failure of the step is never caught.

The World hosts ``n_spaces`` AOI Spaces on one device (``mesh=None``),
with the JAX World's staged device migration between them
(:meth:`World.enter_space`), and the JAX World's other planes: the
pipelined decode, the keyframe cadence of the snapshot chain
(:mod:`goworld_tpu_torch.freeze`), the governor's config swap
(:meth:`World.apply_tick_config`) and the step's cost report. Its other
shapes (a mesh, the megaspace, multihost) raise ``NotImplementedError``
naming ROADMAP.md; none is substituted by another path.

Slot lifecycle contract (``SURVEY.md#7``): a slot freed by a host despawn
is flushed before the step, so its watchers' leave events fire in THAT
step; the slot returns to the free set after those events are processed.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from goworld_tpu_torch.core.state import (
    SpaceState,
    WorldConfig,
    has_behaviors,
    map_lane,
    resolve_device,
)
from goworld_tpu_torch.core.step import TickInputs, TickOutputs, make_tick
from goworld_tpu_torch.models.npc_policy import init_policy
from goworld_tpu_torch.entity.attrs import (
    AttrDelta,
    ListAttr,
    MapAttr,
    load_into,
    make_root,
    sever_tree,
)
from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.registry import (
    RF_OTHER_CLIENT,
    RF_OWN_CLIENT,
    Registry,
)
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.entity.timer import Crontab, PostQueue, TimerQueue
from goworld_tpu_torch.ops import telemetry as telem
from goworld_tpu_torch.parallel.mesh import create_multi_state, tile_view
from goworld_tpu_torch.utils import audit as audit_mod
from goworld_tpu_torch.utils import (
    consts,
    devprof,
    ids,
    log,
    metrics,
    opmon,
    tracing,
)
from goworld_tpu_torch.utils import residency as residency_mod

logger = log.get("world")

def _refuse(what: str, queue: str = "A1b") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md Queue {queue}")


def _type_aoi_radius(desc) -> float:
    """Device aoi_radius for a type (reference EntityTypeDesc.aoiDistance,
    ``EntityManager.go:24-101``): use_aoi=False types are excluded from AOI
    entirely (radius 0 — invisible and blind, the service-entity case); an
    explicit aoi_distance > 0 bounds the type's view; otherwise +inf means
    "the space's uniform radius" (GridSpec.radius caps the reach)."""
    if not desc.use_aoi:
        return 0.0
    if desc.aoi_distance > 0:
        return float(desc.aoi_distance)
    return float("inf")


def _lanes_of(obj, fn):
    """A dataclass of tensor lanes with ``fn`` applied to every lane."""
    return type(obj)(**{
        f.name: map_lane(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)
    })


def _lane_pairs(dst, src):
    """(carry lane, new lane) of every lane of two state dataclasses
    (the Verlet cache's lanes included) whose new value lives elsewhere:
    a lane the step returned as it got it needs no copy."""
    for f in dataclasses.fields(dst):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if a is None:
            continue
        if dataclasses.is_dataclass(a):
            yield from _lane_pairs(a, b)
        elif b.data_ptr() != a.data_ptr():
            yield a, b


def _carry_into(dst: SpaceState, src: SpaceState) -> None:
    """Write the step's new carry ``src`` into the storage of the old
    carry ``dst``: the resident carry, whose lanes keep their addresses
    from tick to tick (the reference donates its carry to the jitted
    step). Enqueued after the step on the same stream."""
    pairs = list(_lane_pairs(dst, src))
    if pairs:
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])


def _make_local_tick(cfg: WorldConfig, n_spaces: int, device,
                     resident: bool = True):
    """The step of a World on one device. One Space: ``make_tick`` on
    the Space's view of the stacked state (lanes ``[1, ...]``), with the
    outputs restacked as ``unsqueeze(0)`` views, so the Verlet skin runs
    there. Several: the batched ``make_tick`` on the ``[S, ...]`` lanes,
    with the skin cleared (as the JAX World's vmapped step clears it;
    the adaptive extraction tiers too, which the port never chooses).
    With ``resident`` the new carry is written into the given state's
    tensors (:func:`_carry_into`) and that state is returned; without it
    the new lanes replace the old ones. Both give the same bits."""
    if n_spaces > 1:
        tick = make_tick(_batched_config(cfg), device=device)

        def step(state: SpaceState, inputs: TickInputs, policy=None):
            s1, outs = tick(state, inputs, policy)
            if resident:
                _carry_into(state, s1)
                return state, outs
            return s1, outs

        return step
    tick = make_tick(cfg, device=device)

    def step1(state: SpaceState, inputs: TickInputs, policy=None):
        view = tile_view(state, 0)
        s1, out = tick(view, _lanes_of(inputs, lambda t: t[0]), policy)
        outs = _lanes_of(out, lambda t: t.unsqueeze(0))
        if resident:
            _carry_into(view, s1)
            return state, outs
        return _lanes_of(s1, lambda t: t.unsqueeze(0)), outs

    return step1


def _batched_config(cfg: WorldConfig) -> WorldConfig:
    """``cfg`` as the batched step of several Spaces runs it: no skin,
    no adaptive extraction (the JAX World's ``_make_local_tick``)."""
    return dataclasses.replace(
        cfg, adaptive_extract=False,
        grid=dataclasses.replace(cfg.grid, skin=0.0))


def _pack_words(lanes: list[torch.Tensor]) -> torch.Tensor:
    """Every lane's 32-bit words in one int32 tensor made by one
    concatenation (a 1-byte lane, such as ``alive``, padded to whole
    words first)."""
    words = []
    for t in lanes:
        t = t.detach().reshape(-1)
        if t.element_size() == 1:
            pad = t.new_zeros(-t.numel() % 4, dtype=torch.uint8)
            t = torch.cat([t.view(torch.uint8), pad])
        words.append(t.view(torch.int32))
    return torch.cat(words)


def _unpack_words(got: np.ndarray, lanes) -> list[np.ndarray]:
    """The lanes of :func:`_pack_words`'s words ``got`` (host int32) as
    numpy in the JAX package's types; ``lanes`` gives each lane's shape
    and dtype (tensors, or ``(shape, dtype)`` pairs)."""
    out, off = [], 0
    for t in lanes:
        shape, dtype = (tuple(t.shape), t.dtype) if torch.is_tensor(t) \
            else t
        n = int(np.prod(shape, dtype=np.int64))
        if dtype in (torch.bool, torch.uint8, torch.int8):
            nw = -(-n // 4)
            a = got[off:off + nw].view(np.uint8)[:n].view(
                np.bool_ if dtype == torch.bool else np.uint8)
        else:
            nw = n
            a = got[off:off + n]
            if dtype == torch.float32:
                a = a.view(np.float32)
        out.append(a.reshape(shape))
        off += nw
    return out


def _keep_last(lin: np.ndarray) -> np.ndarray:
    """Positions of the last occurrence of each value of ``lin``, in
    ascending order of value: the writes of a staged list that survive
    when later writes to the same place win."""
    _, first_of_rev = np.unique(lin[::-1], return_index=True)
    return lin.size - 1 - first_of_rev


class _HostPack:
    """The host lanes of one flush, packed into one buffer and sent to
    the device with one copy (pinned and non-blocking on a card). Each
    lane starts on an 8-byte boundary, so its device view takes its
    dtype in place."""

    _DTYPES = {np.dtype(np.float32): torch.float32,
               np.dtype(np.int32): torch.int32,
               np.dtype(np.int64): torch.int64,
               np.dtype(np.bool_): torch.bool}

    def __init__(self):
        self._parts: list[tuple[int, np.ndarray]] = []
        self._nbytes = 0

    def add(self, a: np.ndarray) -> int:
        """Queue ``a``; returns its index in :meth:`send`'s list."""
        a = np.ascontiguousarray(a)
        self._parts.append((self._nbytes, a))
        self._nbytes += -(-a.nbytes // 8) * 8
        return len(self._parts) - 1

    def send(self, device: torch.device) -> list[torch.Tensor]:
        """Every queued lane on ``device``, in the order added."""
        host = torch.empty(self._nbytes, dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        buf = host.numpy()
        for off, a in self._parts:
            buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = host.to(device, non_blocking=True)
        return [dev[off:off + a.nbytes].view(self._DTYPES[a.dtype])
                .reshape(a.shape) for off, a in self._parts]


class World:
    """Hosts every entity of one game process on one device.

    Parameters:
      cfg: each Space's device config (shared by all Spaces).
      n_spaces: number of AOI shards in the stacked state; with more
        than one the step runs them batched, without the skin.
      mesh: must be None (a mesh is not ported yet).
      pipeline_decode: decode each tick's outputs during the next tick
        (host events and client sends lag one tick; despawned slots are
        released a decode later; :meth:`flush_pending_outputs` drains).
        Read each tick: it may be turned on between ticks, and off
        after :meth:`flush_pending_outputs`.
      clock: injectable time source for timers (tests pass virtual time).
      device: where the state and the step live: the card unless the
        caller asks for the CPU; raises when no card is present.

    The planes default as in the JAX World: ``telemetry_live``,
    ``residency`` and ``audit`` on, sampled every
    ``residency_sample_every`` and ``audit_sample_every`` ticks, the
    audit judging ``audit_cohort`` entities a sample (none under
    ``pipeline_decode``, which decodes a tick late and so lags the
    positions the oracle would read: every sample is a recorded skip).
    ``snapshot_keyframe_every`` is kept for the snapshot chain's
    callers. ``resident=True``
    (the default) keeps the carry's storage from tick to tick: the JAX
    World deletes an old carry so that reading it raises, which torch
    cannot do, so a reference to ``w.state``'s tensors taken before a
    tick sees them overwritten by it (``resident=False`` replaces the
    lanes instead; both give the same bits). The JAX World's knobs of
    the refused shapes (``migrate_cap``, ``halo_cap``, ``halo_impl``,
    ``mega_shape``) are not taken.
    """

    def __init__(
        self,
        cfg: WorldConfig,
        n_spaces: int = 1,
        *,
        mesh=None,
        game_id: int = 1,
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
        megaspace: bool = False,
        pipeline_decode: bool = False,
        resident: bool = True,
        telemetry_live: bool = True,
        snapshot_keyframe_every: int = 0,
        residency: bool = True,
        residency_sample_every: int = 16,
        audit: bool = True,
        audit_sample_every: int = 64,
        audit_cohort: int = 64,
        device="cuda",
    ):
        if mesh is not None:
            raise _refuse("a World on a mesh", "A8")
        if megaspace:
            raise _refuse("the megaspace World", "A8")
        if n_spaces < 1:
            raise ValueError(f"n_spaces must be >= 1, got {n_spaces}")
        if n_spaces > 1 and has_behaviors(cfg):
            raise _refuse("behaviors and scenarios at n_spaces > 1", "A item 3")
        self.device = resolve_device(device)
        # delta-compressed snapshot cadence (freeze.SnapshotChain): every
        # Nth checkpoint a full quantized keyframe, the rest plane deltas
        # against it; 0 = whole snapshots. Kept for the chain's callers.
        self.snapshot_keyframe_every = max(0, int(snapshot_keyframe_every))
        # pipelined decode (see _tick_phases): the decode of tick N runs
        # while the card computes tick N + 1; its copies ride a stream
        # of their own
        self.pipeline_decode = bool(pipeline_decode)
        self._pending_outs = None     # (copy, split) of the last tick
        self._pending_telem = None    # host accumulator left by a drain
        self._age_pending_mark: tuple[int, int] | None = None
        self._copy_stream = None      # made at the first pipelined copy
        self.cfg = cfg
        self.n_spaces = n_spaces
        self.game_id = game_id
        self.registry = Registry()
        # the MLPPolicy when cfg.behavior == 'mlp' (or a scenario mix has
        # the mlp member), drawn from the World's seed as the JAX World
        # draws it; callers may replace it before the first tick
        self.policy = None
        if cfg.behavior == "mlp" or (
                cfg.scenario is not None and cfg.scenario.needs_policy):
            self.policy = init_policy(seed, device=self.device)
        self.resident = resident
        # the batched step clears the skin: no [capacity, verlet_cap]
        # caches a Space that it would never touch
        state_cfg = _batched_config(cfg) if n_spaces > 1 else cfg
        self.state: SpaceState = create_multi_state(
            state_cfg, n_spaces, seed=seed, device=self.device)
        self._step = _make_local_tick(cfg, n_spaces, self.device, resident)

        # the step's cost report, as a lazy devprof provider (run only
        # when asked for), held through a weakref: the registry is
        # process-global and must not pin a discarded World's device state
        wself = weakref.ref(self)

        def _tick_cost_provider():
            w = wself()
            if w is None:
                return {"name": "world.tick", "error": "world discarded"}
            return w.cost_report()

        devprof.register_provider("world.tick", _tick_cost_provider)

        # live device-telemetry lanes: one fold a tick accumulates the
        # tick's signals on the device with no host sync; the drain
        # rides the tick's one fetch. Feeds the metrics registry on a
        # cadence and the workload signature over a rotating window.
        self.telemetry_live = bool(telemetry_live)
        self._telem_fn = None
        self._telem_acc = None
        self._telem_lanes = None    # latest drained cumulative (host)
        self._telem_win = None      # window-start cumulative (signature)
        self._telem_win_tick = 0
        self._telem_last_window = None  # last COMPLETED window's delta
        # sync-age provenance (utils/syncage.py): (seq, tick-start wall
        # us, outputs-host-visible wall us) of the tick whose outputs
        # the host is fanning out, captured at the one fetch
        self.sync_age_anchor: tuple[int, int, int] | None = None
        self._telem_feed_mark = None  # last metrics-fed cumulative
        # negative start: the FIRST drain feeds the registry, then the
        # cadence holds
        self._telem_feed_tick = -self.TELEM_FEED_TICKS
        if self.telemetry_live:
            try:
                self._init_live_telemetry()
            except Exception:
                # observability must never take serving down
                logger.exception("live telemetry init failed; disabled")
                self._telem_fn = self._telem_acc = None

        # serve-loop residency plane: perf_counter marks riding the
        # tick's structure, sampled census and allocator stats. Built
        # outside a try: a bad sampling knob fails loudly, only runtime
        # sampling degrades.
        self.residency = None
        if residency:
            self.residency = residency_mod.register(
                f"game{game_id}",
                residency_mod.ResidencyTracker(
                    f"game{game_id}",
                    sample_every=residency_sample_every))

        # correctness audit plane: the entity ledger, fed by the
        # create/destroy/migrate hooks below, and a sampled AOI oracle
        # judged on a worker thread against planes that rode the
        # tick's one fetch. Built outside a try, like residency.
        self.audit = None
        self._audit_shard = 0
        if audit:
            self.audit = audit_mod.register(
                f"game{game_id}",
                audit_mod.AuditPlane(
                    f"game{game_id}",
                    sample_every=audit_sample_every,
                    cohort=audit_cohort))

        # host object model
        self.entities: dict[str, Entity] = {}
        self.spaces: dict[str, Space] = {}
        self._slot_owner: list[dict[int, str]] = [
            {} for _ in range(n_spaces)
        ]
        # numpy mirrors of slot -> (entity id, client id, gate), kept
        # incrementally in lockstep with _slot_owner / client binding:
        # the sync-record fan-out decodes tens of thousands of records
        # per tick, and with the mirrors the decode is pure numpy gather
        # + groupby (see _process_outputs)
        self._mir_eid = np.zeros((n_spaces, cfg.capacity), "S16")
        self._mir_cid = np.zeros((n_spaces, cfg.capacity), "S16")
        self._mir_gate = np.full((n_spaces, cfg.capacity), -1, np.int32)
        self._free: list[set[int]] = [
            set(range(cfg.capacity)) for _ in range(n_spaces)
        ]
        self._shard_space: list[str | None] = [None] * n_spaces
        self.nil_space: Space | None = None

        # runtime utils
        self.timers = TimerQueue(clock)
        self.post_q = PostQueue()
        self.crontab = Crontab()
        self.tick_count = 0
        self.last_outputs = None  # fetched outputs of the most recent tick

        # staging buffers (flushed as vectorized scatters each tick)
        self._staged_spawn: list[tuple[int, int, dict]] = []
        self._staged_despawn: list[tuple[int, int]] = []
        self._staged_hot: list[tuple[int, int, int, float]] = []
        self._staged_moving: list[tuple[int, int, bool]] = []
        self._staged_client: list[tuple[int, int, bool, int]] = []
        self._staged_pos: dict[tuple[int, int], Entity] = {}
        # (src shard, src slot, dst shard, eid) of each enter_space
        # between two AOI Spaces, repacked at the next flush
        self._staged_migrate: list[tuple[int, int, int, str]] = []
        # upstream (client->server) pos-sync BATCH path: slot-addressed
        # staging arrays + a lazily rebuilt eid->(shard,slot) intern
        # index over the client-bound mirror columns, so a decoded batch
        # resolves in one searchsorted instead of a per-record dict walk
        self._batch_pos_mask: np.ndarray | None = None
        self._batch_pos_vals: np.ndarray | None = None
        self._batch_pos_any = False
        self._sync_index: tuple | None = None
        # host staging of the position-sync inputs (zeroed and refilled
        # each flush), and the sync fan-out's gather scratch
        ic = cfg.input_cap
        self._pin_idx = np.zeros((n_spaces, ic), np.int32)
        self._pin_vals = np.zeros((n_spaces, ic, 4), np.float32)
        self._pin_counts = np.zeros((n_spaces,), np.int32)
        self._scr_cid = np.zeros((cfg.sync_cap,), "S16")
        self._scr_gate = np.zeros((cfg.sync_cap,), np.int32)
        self._scr_eid = np.zeros((cfg.sync_cap,), "S16")
        # (shard, slot, expected_owner_eid): release only applies if the
        # slot still belongs to that entity; under pipeline_decode a
        # despawn's release waits one decode more (_release_next)
        self._release_now: list[tuple[int, int, str | None]] = []
        self._release_next: list[tuple[int, int, str | None]] = []

        # attr journaling
        self._dirty_attr_entities: dict[str, list[AttrDelta]] = {}

        # per-tick device read cache
        self._pos_cache: np.ndarray | None = None
        self._yaw_cache: np.ndarray | None = None

        # pluggable sinks (the gateway overrides these; defaults capture)
        self.client_messages: list[tuple[int, str, dict]] = []
        self.client_sink: Callable[[int, str, dict], None] | None = None
        # batched downstream sync: sync_sink(gate_id, cids, eids, vals)
        # replaces per-record "sync" dicts when set (the game-server path)
        self.sync_sink: Callable[[int, list, list, np.ndarray], None] | None \
            = None
        self.filtered_sink = None
        self.remote_router = None  # cross-process RPC hook
        # cross-process EnterSpace: called when the target space is not
        # hosted here (reference requestMigrateTo, Entity.go:1006-1012)
        self.remote_space_router: Callable[[Entity, str, tuple], None] | None \
            = None
        self.storage = None        # persistence backend
        # periodic per-entity persistence (reference Entity.go:164-177
        # setupSaveTimer): raw timers, never dumped into migrate data
        self.save_interval: float = consts.DEFAULT_SAVE_INTERVAL
        self._save_timers: dict[str, int] = {}
        self.service_mgr = None    # sharded services
        # cluster notifications (the game server wires these)
        self.on_entity_created: Callable[[Entity], None] | None = None
        self.on_entity_destroyed: Callable[[Entity], None] | None = None
        self.op_stats: dict[str, float] = defaultdict(float)
        self._aoi_alarm_tick = -(1 << 30)  # last AOI-overflow alarm tick
        self._m_aoi_overflow = metrics.counter(
            "aoi_overflow_total",
            help="AOI rows truncated to nearest-k + cells past cell_cap",
        )
        self._m_aoi_demand = metrics.gauge("aoi_demand_max")
        self._m_aoi_cell = metrics.gauge("aoi_cell_max")
        self._m_aoi_rebuild = metrics.counter(
            "aoi_rebuild_total",
            help="AOI front-half rebuilds (every tick when skin = 0)",
        )
        self._m_aoi_slack = metrics.gauge("aoi_skin_slack")

    # ==================================================================
    # registration / creation
    # ==================================================================
    def register_entity(self, name: str, cls, **kw):
        return self.registry.register(name, cls, **kw)

    def register_space(self, name: str, cls, **kw):
        if not issubclass(cls, Space):
            raise TypeError(f"{cls} must subclass Space")
        return self.registry.register(name, cls, is_space=True, **kw)

    def _attach(self, e: Entity, eid: str) -> None:
        e.id = eid
        e.world = self
        e.attrs = make_root(lambda d, _e=e: self._on_attr_delta(_e, d))
        self._setup_save_timer(e)

    def _setup_save_timer(self, e: Entity) -> None:
        """Schedule the periodic save for a persistent entity (reference
        ``setupSaveTimer``, ``Entity.go:214-217``)."""
        if not e._type_desc.is_persistent or self.save_interval <= 0:
            return
        if e.id in self._save_timers:
            return
        self._save_timers[e.id] = self.timers.add(
            self.save_interval,
            lambda _e=e: None if _e.destroyed else self.save_entity(_e),
            interval=self.save_interval,
        )

    def create_nil_space(self) -> Space:
        """The per-game anchor space (reference ``space_ops.go:33-47``)."""
        if "NilSpace" not in self.registry:
            self.registry.register("NilSpace", Space, is_space=True,
                                   use_aoi=False)
        sp = Space()
        sp._type_desc = self.registry.get("NilSpace")
        self._attach(sp, ids.nil_space_id(self.game_id))
        sp.is_nil_space = True
        self.entities[sp.id] = sp
        if self.audit is not None:
            self.audit.ledger.on_create(sp.id, "NilSpace",
                                        self.tick_count)
        self.spaces[sp.id] = sp
        self.nil_space = sp
        if self.on_entity_created is not None:
            self.on_entity_created(sp)
        return sp

    def create_space(
        self, type_name: str, *, use_aoi: bool | None = None,
        attrs: dict | None = None, eid: str | None = None, **kw_attrs,
    ) -> Space:
        desc = self.registry.get(type_name)
        if not desc.is_space:
            raise TypeError(f"{type_name} is not a space type")
        if desc.megaspace:
            raise _refuse(f"space type {type_name!r} (megaspace=True)",
                          "A8")
        if eid is not None and eid in self.entities:
            raise ValueError(f"entity id collision: {eid}")
        sp: Space = desc.cls()
        sp._type_desc = desc
        # honor a caller-supplied id (CreateSpaceAnywhere routes by it)
        self._attach(sp, eid or ids.gen_entity_id())
        aoi = desc.use_aoi if use_aoi is None else use_aoi
        if aoi:
            try:
                shard = self._shard_space.index(None)
            except ValueError:
                raise RuntimeError(
                    f"no free shard for AOI space ({self.n_spaces} in use); "
                    "raise n_spaces"
                ) from None
            self._shard_space[shard] = sp.id
            sp.shard = shard
        self.entities[sp.id] = sp
        self.spaces[sp.id] = sp
        if self.audit is not None:
            self.audit.ledger.on_create(sp.id, type_name,
                                        self.tick_count)
        # explicit attrs dict first (wire path — attr names there may
        # collide with parameter names), then kwarg sugar
        for k, v in {**(attrs or {}), **kw_attrs}.items():
            sp.attrs[k] = v
        sp.OnInit()
        sp.OnSpaceInit()
        sp.OnAttrsReady()
        sp.OnCreated()
        sp.OnSpaceCreated()
        if self.on_entity_created is not None:
            self.on_entity_created(sp)
        return sp

    def create_entity(
        self,
        type_name: str,
        *,
        space: Space | None = None,
        pos=(0.0, 0.0, 0.0),
        eid: str | None = None,
        client: GameClient | None = None,
        attrs: dict | None = None,
        moving: bool = False,
    ) -> Entity:
        """Reference ``createEntity`` (``EntityManager.go:201``)."""
        desc = self.registry.get(type_name)
        if desc.is_space:
            raise TypeError(f"use create_space for space type {type_name}")
        e: Entity = desc.cls()
        e._type_desc = desc
        new_id = eid or ids.gen_entity_id()
        if new_id in self.entities:
            raise ValueError(f"entity id collision: {new_id}")
        self._attach(e, new_id)
        self.entities[e.id] = e
        if self.audit is not None:
            self.audit.ledger.on_create(e.id, type_name,
                                        self.tick_count)
        if attrs:
            load_into(e.attrs, attrs)
        e.OnInit()
        e.OnAttrsReady()
        space = space or self.nil_space
        if space is not None:
            self._enter_space_local(e, space, pos, moving=moving)
        if client is not None:
            self.set_entity_client(e, client)
        e.OnCreated()
        if self.on_entity_created is not None:
            self.on_entity_created(e)
        return e

    def load_entity(self, type_name: str, eid: str,
                    cb: Callable[[Entity | None], None] | None = None) -> None:
        """Async load from storage (reference ``loadEntityLocally``,
        ``EntityManager.go:307``). Requires a storage backend."""
        if self.storage is None:
            raise RuntimeError("no storage backend configured")
        if eid in self.entities:
            if cb:
                self.post_q.post(lambda: cb(self.entities.get(eid)))
            return

        def _loaded(data: dict | None) -> None:
            if data is None:
                logger.warning("load_entity %s %s: not found", type_name, eid)
                if cb:
                    cb(None)
                return
            if eid in self.entities:  # raced a concurrent load/create
                if cb:
                    cb(self.entities[eid])
                return
            e = self.create_entity(type_name, eid=eid, attrs=data)
            e.OnRestored()
            if cb:
                cb(e)

        self.storage.load(type_name, eid, _loaded)

    # ==================================================================
    # slot management
    # ==================================================================
    def _alloc_slot(self, shard: int, eid: str) -> int:
        try:
            slot = self._free[shard].pop()
        except KeyError:
            raise RuntimeError(
                f"space shard {shard} is full ({self.cfg.capacity} slots)"
            ) from None
        self._slot_set(shard, slot, eid)
        return slot

    def _owner_entity(self, shard: int, slot: int) -> Entity | None:
        eid = self._slot_owner[shard].get(slot)
        return self.entities.get(eid) if eid is not None else None

    # -- slot/client numpy mirrors (all _slot_owner writes route here) --
    def _write_client_cols(self, shard: int, slot: int,
                           c: GameClient | None) -> None:
        if c is not None:
            self._mir_cid[shard, slot] = c.client_id.encode("ascii")
            self._mir_gate[shard, slot] = c.gate_id
        else:
            self._mir_cid[shard, slot] = b""
            self._mir_gate[shard, slot] = -1
        # the eid->(shard,slot) intern index over these columns is stale
        self._sync_index = None

    def _slot_set(self, shard: int, slot: int, eid: str) -> None:
        self._slot_owner[shard][slot] = eid
        self._mir_eid[shard, slot] = eid.encode("ascii")
        e = self.entities.get(eid)
        self._write_client_cols(shard, slot,
                                e.client if e is not None else None)

    def _slot_clear(self, shard: int, slot: int) -> None:
        self._slot_owner[shard].pop(slot, None)
        self._mir_eid[shard, slot] = b""
        self._write_client_cols(shard, slot, None)

    def _mirror_client(self, e: Entity) -> None:
        """Refresh the client columns for an entity's current slot (call
        after any (re)bind/unbind; no-op for slotless or stale rows)."""
        if e.shard is None or e.slot is None:
            return
        if self._slot_owner[e.shard].get(e.slot) != e.id:
            return
        self._write_client_cols(e.shard, e.slot, e.client)

    def _drop_staged_for(self, shard: int, slot: int) -> None:
        """Forget pending writes aimed at a row being despawned."""
        self._staged_hot = [
            x for x in self._staged_hot if (x[0], x[1]) != (shard, slot)
        ]
        self._staged_moving = [
            x for x in self._staged_moving if (x[0], x[1]) != (shard, slot)
        ]
        self._staged_client = [
            x for x in self._staged_client if (x[0], x[1]) != (shard, slot)
        ]
        self._staged_pos.pop((shard, slot), None)
        if self._batch_pos_mask is not None:
            self._batch_pos_mask[shard, slot] = False

    # ==================================================================
    # space enter / leave
    # ==================================================================
    def enter_space(self, e: Entity, space_id: str, pos) -> None:
        """Reference ``EnterSpace`` (``Entity.go:956-973``): a staged
        device migration when both spaces are AOI shards (repacked at
        the next flush, replacing the dispatcher block-and-queue
        protocol, ``DispatcherService.go:850-891``), else the host move
        after the current frame."""
        target = self.spaces.get(space_id)
        if target is None:
            if self.remote_space_router is not None:
                # the space lives on another game process
                self.remote_space_router(e, space_id, tuple(map(float, pos)))
                return
            raise KeyError(f"space {space_id} not found in this world")
        if e.space is target:
            e.set_position(pos)
            return
        src = e.space
        if (
            src is not None and e.shard is not None
            and target.shard is not None and e.slot is not None
        ):
            e.OnMigrateOut()
            self._staged_migrate.append(
                (e.shard, e.slot, target.shard, e.id)
            )
            self._drop_staged_for(e.shard, e.slot)
            src.members.discard(e.id)
            e.OnLeaveSpace(src)
            src.OnEntityLeaveSpace(e)
            # during the migration window the entity has NO device row it
            # may address: slot ownership of the source row is kept (for
            # its leave events) in _staged_migrate, and e.slot is
            # re-pointed by the flush's repack
            e._migrating = (e.shard, e.slot, target.shard)
            e.slot = None
            e.shard = None
            e.space = target
            target.members.add(e.id)
            e._pending_pos = tuple(map(float, pos))
        else:
            self.post_q.post(
                lambda: self._move_space_host(e, target, pos)
            )

    def _move_space_host(self, e: Entity, target: Space, pos) -> None:
        if e.destroyed:
            return
        self._leave_space_host(e)
        self._enter_space_local(e, target, pos)

    def _leave_space_host(self, e: Entity) -> None:
        src = e.space
        if src is None:
            self._cancel_migration(e)
            return
        src.members.discard(e.id)
        if e.slot is not None:
            self._drop_staged_for(e.shard, e.slot)
            self._staged_despawn.append((e.shard, e.slot))
            e.slot = None
            e.shard = None
        self._cancel_migration(e)
        e.space = None
        e.OnLeaveSpace(src)
        src.OnEntityLeaveSpace(e)

    def _cancel_migration(self, e: Entity) -> None:
        """Abort an in-window migration (reference ``cancelEnterSpace``,
        ``Entity.go:1014-1023``): drop the staged request and despawn
        the still-live source row."""
        mig = e._migrating
        if mig is None:
            return
        src_sh, src_sl, _dst = mig
        e._migrating = None
        self._staged_migrate = [
            m for m in self._staged_migrate if m[3] != e.id
        ]
        self._staged_despawn.append((src_sh, src_sl))

    def _enter_space_local(
        self, e: Entity, space: Space, pos, moving: bool = False
    ) -> None:
        e.space = space
        space.members.add(e.id)
        shard = space.shard
        if shard is not None:
            slot = self._alloc_slot(shard, e.id)
            e.slot = slot
            e.shard = shard
            hot = [0.0] * self.cfg.attr_width
            for name, col in e._type_desc.hot_attrs.items():
                v = e.attrs.get(name)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    hot[col] = float(v)
            self._staged_spawn.append((shard, slot, dict(
                pos=tuple(map(float, pos)),
                yaw=0.0,
                type_id=e._type_desc.type_id,
                npc_moving=moving,
                has_client=e.client is not None,
                client_gate=e.client.gate_id if e.client else -1,
                hot=hot,
                aoi_radius=_type_aoi_radius(e._type_desc),
            )))
        e._pending_pos = tuple(map(float, pos))
        e.OnEnterSpace()
        space.OnEntityEnterSpace(e)

    def destroy_entity(self, e: Entity) -> None:
        """Reference ``destroyEntity`` (``Entity.go:631-651``)."""
        if e.destroyed:
            return
        e.destroyed = True
        if self.audit is not None:
            # the ledger tracks LIVE entities; the host object may
            # linger in self.entities until its leave events drain
            self.audit.ledger.on_destroy(e.id, self.tick_count)
        try:
            e.OnDestroy()
        except Exception:
            logger.exception("OnDestroy failed for %s", e)
        if e._type_desc.is_persistent and self.storage is not None:
            self.save_entity(e)
        if e.client is not None:
            self.set_entity_client(e, None)
        for tid in list(e.timer_ids):
            self.timers.cancel(tid)
        e.timer_ids.clear()
        save_tid = self._save_timers.pop(e.id, None)
        if save_tid is not None:
            self.timers.cancel(save_tid)
        if isinstance(e, Space):
            # evict members into the nil space (despawns their rows) so a
            # new space claiming this shard never sees ghost entities
            for mid in list(e.members):
                m = self.entities.get(mid)
                if m is None or m is e:
                    continue
                if self.nil_space is not None:
                    self._move_space_host(m, self.nil_space, m.position)
                else:
                    self._leave_space_host(m)
            if e.shard is not None:
                self._shard_space[e.shard] = None
            e.OnSpaceDestroy()
            self.spaces.pop(e.id, None)
        had_slot = e.slot is not None
        self._leave_space_host(e)
        if not had_slot and e._migrating is None:
            # never on device (and no row in flight): nothing will
            # reference it again
            self.entities.pop(e.id, None)
        # else: the host object stays mapped until the leave events
        # referencing its slot have been processed (_process_outputs)
        #
        # Break the entity's reference cycles (e -> attrs ->
        # _root_cb-closure -> e, and every attr child's parent pointer)
        # so plain refcounting reclaims it. Post-destroy attr mutations
        # no longer journal, which is correct: the entity is gone to
        # every client.
        if e.attrs is not None:
            sever_tree(e.attrs)
        if self.on_entity_destroyed is not None:
            self.on_entity_destroyed(e)

    # ==================================================================
    # staging entry points (called by Entity)
    # ==================================================================
    def stage_pos_set(self, e: Entity) -> None:
        if e.slot is not None and e.shard is not None:
            self._staged_pos[(e.shard, e.slot)] = e

    def stage_pose(self, e: Entity, pos, yaw: float,
                   moving: bool | None = None) -> None:
        """Overwrite an entity's authoritative pose from a snapshot and
        stage the device-row write (the restore path; flushed with the
        position inputs on the next tick). ``moving=None`` leaves the
        moving flag unstaged."""
        e._pending_pos = tuple(map(float, pos))
        e._pending_yaw = float(yaw)
        self.stage_pos_set(e)
        if moving is not None:
            self.set_moving(e, bool(moving))

    def _sync_pos_index(self) -> tuple:
        """eid -> (shard, slot) intern index over client-bound live
        slots, rebuilt lazily after any client (re)bind/unbind or slot
        change (all of which funnel through ``_write_client_cols``),
        built and probed with :func:`ids.build_eid_index`."""
        if self._sync_index is None:
            sh, sl = np.nonzero(self._mir_gate >= 0)
            hashed, keys, sorted_eids, order = ids.build_eid_index(
                self._mir_eid[sh, sl]
            )
            self._sync_index = (
                hashed,
                keys,
                sorted_eids,
                sh[order].astype(np.int32),
                sl[order].astype(np.int32),
            )
        return self._sync_index

    def stage_pos_sync_batch(self, eids, vals) -> int:
        """Stage a decoded upstream sync batch (S16 eids[N], f32[N,4]
        x/y/z/yaw) without touching per-entity Python objects: one
        searchsorted against the intern index resolves every record to
        its (shard, slot); records for unknown, client-less or slotless
        entities are dropped (the reference's ``e == nil || e.client ==
        nil`` skip, ``GameService.go:395-407``). Last write wins per
        slot, both within a batch and across batches in the same tick.
        Host reads (``Entity.position``/``yaw``) see staged values
        immediately via ``_peek_batch_pos``; host-side ``set_position``
        writes staged the same tick take precedence at flush. Returns
        the number staged."""
        hashed, keys, sorted_eids, ish, isl = self._sync_pos_index()
        eids = np.ascontiguousarray(np.asarray(eids, "S16"))
        if eids.shape[0] == 0 or keys.size == 0:
            return 0
        p, ok = ids.probe_eid_index(hashed, keys, sorted_eids, eids)
        if not ok.any():
            return 0
        sh = ish[p[ok]]
        sl = isl[p[ok]]
        v = np.asarray(vals, np.float32).reshape(-1, 4)[ok]
        if self._batch_pos_mask is None:
            self._batch_pos_mask = np.zeros(
                (self.n_spaces, self.cfg.capacity), bool
            )
            self._batch_pos_vals = np.zeros(
                (self.n_spaces, self.cfg.capacity, 4), np.float32
            )
        # in-batch duplicates: keep the LAST record per slot (wire
        # arrival order)
        sel = _keep_last(sh.astype(np.int64) * self.cfg.capacity + sl)
        self._batch_pos_mask[sh[sel], sl[sel]] = True
        self._batch_pos_vals[sh[sel], sl[sel]] = v[sel]
        self._batch_pos_any = True
        return int(sel.size)

    def _peek_batch_pos(self, shard: int, slot: int):
        """Staged-but-unflushed client sync for a slot (or None)."""
        if self._batch_pos_any and self._batch_pos_mask is not None \
                and self._batch_pos_mask[shard, slot]:
            return self._batch_pos_vals[shard, slot]
        return None

    def set_moving(self, e: Entity, moving: bool) -> None:
        if e.slot is not None and e.shard is not None:
            self._staged_moving.append((e.shard, e.slot, moving))

    def stage_hot(self, e: Entity, col: int, val: float) -> None:
        if e.slot is not None and e.shard is not None:
            self._staged_hot.append((e.shard, e.slot, col, val))

    def set_entity_client(self, e: Entity, client: GameClient | None) -> None:
        """Reference ``SetClient`` (``Entity.go:678-720``): bind/unbind and
        send the client its own entity + currently visible neighbors
        (``GameClient.go:37-53``: player gets Client attrs, neighbors get
        AllClients attrs)."""
        old = e.client
        e.client = client
        if client is not None:
            client.owner = e
        self._mirror_client(e)
        if e.slot is not None and e.shard is not None:
            self._staged_client.append((
                e.shard, e.slot,
                client is not None,
                client.gate_id if client is not None else -1,
            ))
        if old is not None and client is None:
            old.send({"type": "destroy_entity", "eid": e.id,
                      "is_player": True})
            e.OnClientDisconnected()
        elif client is not None:
            client.send({
                "type": "create_entity", "eid": e.id,
                "etype": e.type_name, "is_player": True,
                "attrs": e.get_client_data(),
                "pos": list(e.position), "yaw": e.yaw,
            })
            for nid in e.interested_in:
                n = self.entities.get(nid)
                if n is not None:
                    client.send({
                        "type": "create_entity", "eid": n.id,
                        "etype": n.type_name, "is_player": False,
                        "attrs": n.get_all_clients_data(),
                        "pos": list(n.position), "yaw": n.yaw,
                    })
            e.OnClientConnected()

    # ==================================================================
    # attr deltas
    # ==================================================================
    def _on_attr_delta(self, e: Entity, d: AttrDelta) -> None:
        self._dirty_attr_entities.setdefault(e.id, []).append(d)
        root_key = d.path[0] if d.path else None
        col = e._type_desc.hot_attrs.get(root_key)
        if col is not None and isinstance(d.value, (int, float)) \
                and not isinstance(d.value, bool):
            self.stage_hot(e, col, float(d.value))

    def _apply_device_attr(self, e: Entity, name: str, v: float,
                           aud: str | None) -> None:
        """Write a kernel-mutated hot attr shadowed by a tree node into
        the host tree WITHOUT echoing it back to the device, journaling
        the change when ``aud`` (the attr's audience) gives it a
        recipient."""
        attrs = e.attrs
        cb = attrs._root_cb
        attrs._root_cb = None
        try:
            attrs[name] = v
        finally:
            attrs._root_cb = cb
        if aud is not None and (
                e.client is not None
                or (aud == "all_clients" and bool(e.interested_by))):
            self._dirty_attr_entities.setdefault(e.id, []).append(
                AttrDelta((name,), "set", v)
            )

    def _drain_attr_journals(self) -> None:
        for eid, deltas in self._dirty_attr_entities.items():
            e = self.entities.get(eid)
            if e is None or e.destroyed:
                continue
            has_own = e.client is not None
            has_watchers = bool(e.interested_by)
            if not has_own and not has_watchers:
                # nobody to tell — don't build recs that are dropped
                continue
            desc = e._type_desc
            own: list = []
            others: list = []
            for d in deltas:
                aud = desc.audience_of(d.path[0]) if d.path else None
                if aud is None:
                    continue
                rec = {"path": list(d.path), "op": d.op, "value": d.value}
                if aud == "all_clients":
                    own.append(rec)
                    others.append(rec)
                else:
                    own.append(rec)
            if own and has_own:
                e.client.send({"type": "attrs", "eid": eid, "deltas": own})
            if others and has_watchers:
                for wid in e.interested_by:
                    w = self.entities.get(wid)
                    if w is not None and w.client is not None:
                        w.client.send(
                            {"type": "attrs", "eid": eid, "deltas": others}
                        )
        self._dirty_attr_entities.clear()

    # ==================================================================
    # RPC
    # ==================================================================
    def call(self, eid: str, method: str, *args,
             from_client: str | None = None) -> None:
        """Reference ``entity.Call`` (``EntityManager.go:399-412``):
        local-optimized post, else the remote router (the dispatcher-hop
        analog, provided by the deployment layer)."""
        e = self.entities.get(eid)
        if e is not None and consts.OPTIMIZE_LOCAL_ENTITY_CALL:
            self.post_q.post(
                lambda: self._invoke(e, method, args, from_client)
            )
        elif self.remote_router is not None:
            self.remote_router(eid, method, args, from_client)
        elif e is not None:  # local, but forced through the routed path
            self.post_q.post(
                lambda: self._invoke(e, method, args, from_client)
            )
        else:
            logger.warning("call %s.%s: entity not found", eid, method)

    def _invoke(self, e: Entity, method: str, args: tuple,
                from_client: str | None) -> None:
        if tracing.active:
            ctx = tracing.current()
            if ctx is not None and ctx.sampled:
                # traced RPC: the method execution gets its own span
                with tracing.hop("invoke", f"game{self.game_id}", ctx,
                                 method=method, eid=e.id):
                    return self._invoke_body(e, method, args,
                                             from_client)
        return self._invoke_body(e, method, args, from_client)

    def _invoke_body(self, e: Entity, method: str, args: tuple,
                     from_client: str | None) -> None:
        if e.destroyed:
            return
        desc = e._type_desc.rpc_descs.get(method)
        if desc is None:
            logger.warning("%s has no RPC method %s", e, method)
            return
        if from_client is not None:
            own = e.client is not None and e.client.client_id == from_client
            need = RF_OWN_CLIENT if own else RF_OTHER_CLIENT
            if not desc.flags & need:
                logger.warning(
                    "client %s not allowed to call %s.%s",
                    from_client, e, method,
                )
                return
        try:
            getattr(e, method)(*args)
        except Exception:
            logger.exception("RPC %s.%s failed", e, method)

    def call_service(self, name: str, method: str, *args,
                     shard_key: str | None = None,
                     shard_index: int | None = None,
                     all_shards: bool = False) -> None:
        """CallServiceAny/ShardKey/ShardIndex/All (goworld.go:157-172)."""
        if self.service_mgr is None:
            raise RuntimeError("service manager not configured")
        if all_shards:
            self.service_mgr.call_all(name, method, *args)
            return
        self.service_mgr.call(name, method, args, shard_key=shard_key,
                              shard_index=shard_index)

    def call_filtered_clients(self, key, op, val, method, args) -> None:
        if self.filtered_sink is None:
            logger.warning("call_filtered_clients: no gateway attached")
            return
        self.filtered_sink(key, op, val, method, args)

    # ==================================================================
    # timers
    # ==================================================================
    def add_entity_timer(self, e: Entity, delay: float, interval: float,
                         cb_or_method, args: tuple) -> int:
        if isinstance(cb_or_method, str):
            # method-name timers are migration/freeze-safe (Entity.go:271)
            return self.timers.add(
                delay, interval=interval, method=cb_or_method,
                args=(e.id,) + args,
            )
        box: dict[str, int] = {}

        def _cb() -> None:
            if interval <= 0:  # one-shot: forget the tid (no leak)
                e.timer_ids.discard(box.get("tid", -1))
            if not e.destroyed:
                cb_or_method(*args)

        box["tid"] = tid = self.timers.add(
            delay, interval=interval, cb=_cb
        )
        return tid

    def _fire_timer(self, t) -> None:
        if t.method is not None:
            eid = t.args[0]
            e = self.entities.get(eid)
            if e is None or e.destroyed:
                return
            if t.interval <= 0:
                e.timer_ids.discard(t.tid)
            fn = getattr(e, t.method, None)
            if fn is None:
                logger.warning("timer method %s missing on %s", t.method, e)
                return
            fn(*t.args[1:])
        elif t.cb is not None:
            t.cb()

    # ==================================================================
    # client message sink
    # ==================================================================
    def client_emit_ok(self, e: Entity | None) -> bool:
        """Whether this process emits ``e``'s client-bound messages: a
        single-controller World always does (the multi-controller send
        dedup of the JAX World is not ported)."""
        return True

    def send_to_client(self, gate_id: int, client_id: str, msg: dict) -> None:
        if self.client_sink is not None:
            self.client_sink(gate_id, client_id, msg)
        else:
            self.client_messages.append((gate_id, client_id, msg))

    # ==================================================================
    # cross-process migration (reference Entity.go:1060-1115,
    # EntityManager.go:246-305 — GetMigrateData / restoreEntity)
    # ==================================================================
    def get_migrate_data(self, e: Entity) -> dict:
        """Everything needed to recreate the entity on another game: all
        attrs, client binding, pos/yaw, migration-safe timers — plus the
        audit ownership seq the target's ledger validates against
        re-delivered or stale ghosts (``remove_for_migration`` commits
        the matching ledger move, back to back on the logic thread)."""
        data = {
            "type": e.type_name,
            "id": e.id,
            "attrs": e.attrs.to_dict(),
            "client": (
                [e.client.gate_id, e.client.client_id]
                if e.client is not None else None
            ),
            "pos": list(e.position),
            "yaw": e.yaw,
            "timers": self.timers.dump(list(e.timer_ids)),
        }
        if self.audit is not None:
            data["own_seq"] = self.audit.ledger.next_seq(e.id)
        return data

    def remove_for_migration(self, e: Entity, target: int = 0,
                             out_tick: int | None = None) -> None:
        """Tear down the local copy WITHOUT destroy semantics — no
        OnDestroy, no persistence, no client destroy message (the client
        binding travels in the migrate data; reference
        ``destroyEntity(isMigrate=true)``, ``Entity.go:631-651``).

        ``target`` names the destination game in the ledger's in-flight
        record; ``out_tick`` stamps the entity at its own send tick
        (default: the current tick)."""
        if self.audit is not None:
            # ledger move-out: opens an in-flight record the target's
            # migrate-in must retire within the conservation grace
            self.audit.ledger.stamp_migrate_out(
                e.id,
                self.tick_count if out_tick is None else int(out_tick),
                target=int(target))
        e.OnMigrateOut()
        for tid in list(e.timer_ids):
            self.timers.cancel(tid)
        e.timer_ids.clear()
        save_tid = self._save_timers.pop(e.id, None)
        if save_tid is not None:
            self.timers.cancel(save_tid)  # target game schedules its own
        e.client = None  # quiet detach; the data carries the binding
        self._mirror_client(e)
        e.destroyed = True
        self._leave_space_host(e)
        if e.slot is None and e._migrating is None:
            self.entities.pop(e.id, None)

    def restore_from_migration(self, data: dict,
                               space: Space | None = None) -> Entity:
        """Recreate a migrated-in entity: rebuild attrs, quietly re-assign
        the client, enter the target space, restore timers, OnMigrateIn."""
        desc = self.registry.get(data["type"])
        e: Entity = desc.cls()
        e._type_desc = desc
        self._attach(e, data["id"])
        self.entities[e.id] = e
        if self.audit is not None:
            self.audit.ledger.on_migrate_in(
                e.id, data["type"], data.get("own_seq", 0),
                self.tick_count)
        load_into(e.attrs, data["attrs"])
        if data.get("client"):
            # direct assignment = the reference's "re-assign client
            # quietly" (no create_entity resend)
            e.client = GameClient(
                data["client"][0], data["client"][1], self, owner=e
            )
        sp = space or self.nil_space
        if sp is not None:
            self._enter_space_local(e, sp, tuple(data["pos"]))
        e._pending_yaw = float(data.get("yaw", 0.0))
        self.stage_pos_set(e)
        for tid in self.timers.restore(data.get("timers", [])):
            e.timer_ids.add(tid)
        e.OnMigrateIn()
        if self.on_entity_created is not None:
            self.on_entity_created(e)
        return e

    # ==================================================================
    # persistence
    # ==================================================================
    def save_entity(self, e: Entity) -> None:
        if self.storage is None or not e._type_desc.is_persistent:
            return
        self.storage.save(e.type_name, e.id, e.get_persistent_data())

    # ==================================================================
    # live device telemetry
    # ==================================================================
    # cadence constants (ticks): how often the drained lanes feed the
    # metrics registry, and how often the signature window rotates (the
    # signature reads the delta since the last rotation, so it always
    # covers the most recent 1-2 windows)
    TELEM_FEED_TICKS = 32
    SIG_WINDOW_TICKS = 256

    def _init_live_telemetry(self) -> None:
        cfg = self.cfg
        # the skin lane exists only where the Verlet cache is live in
        # the step (the state carries a cache, and capacity is inside
        # the packed-id bound)
        skin_on = (cfg.grid.skin > 0
                   and getattr(self.state, "aoi_cache", None) is not None
                   and cfg.capacity < (1 << consts.AOI_ID_BITS))
        self._telem_skin_on = skin_on
        self._telem_half_skin = cfg.grid.skin / 2.0 if skin_on else 0.0
        self._telem_acc = telem.telemetry_init(
            skin_on, occupancy=True, n_tiles=self.n_spaces,
            device=self.device)
        self._telem_fn = telem.make_fold(half_skin=self._telem_half_skin)

    def _ingest_telemetry(self, acc_host) -> None:
        """Host half of the live lanes (called with the accumulator
        copy that rode the tick's fetch): keep the cumulative drain,
        feed the metrics registry and rotate the signature window on
        their cadences."""
        lanes = telem.telemetry_drain(
            acc_host, self._telem_skin_on, self._telem_half_skin)
        self._telem_lanes = lanes
        if self.tick_count - self._telem_feed_tick \
                >= self.TELEM_FEED_TICKS:
            self._feed_telemetry_metrics(lanes)
            self._telem_feed_tick = self.tick_count
        if self.tick_count - self._telem_win_tick \
                >= self.SIG_WINDOW_TICKS:
            # stash the just-COMPLETED window's delta before rotating:
            # a governor judges whole windows
            self._telem_last_window = telem.lanes_delta(
                lanes, self._telem_win)
            self._telem_win = lanes
            self._telem_win_tick = self.tick_count

    def _feed_telemetry_metrics(self, lanes: dict) -> None:
        """Drained lanes -> metrics registry: one histogram per lane
        (`telemetry_<lane>`; increment = the delta since the last feed)
        plus per-tile occupancy gauges. The tick_ms lane is skipped (the
        live wall latency has its own series)."""
        delta = telem.lanes_delta(lanes, self._telem_feed_mark)
        for nm, lane in delta.items():
            if nm == "tick_ms" or not isinstance(lane, dict) \
                    or "counts" not in lane:
                continue
            metrics.histogram(
                f"telemetry_{nm}", buckets=tuple(lane["edges"]),
            ).add_counts(lane["counts"])
        per_tile = (lanes.get("occupancy") or {}).get("per_tile")
        if per_tile is not None:
            for i, c in enumerate(per_tile):
                metrics.gauge("telemetry_tile_occupancy",
                              tile=str(i)).set(c)
        self._telem_feed_mark = lanes

    def workload_signature(self) -> dict | None:
        """The live workload signature over the recent window (the
        reducer of ops/telemetry.py on the drained-lane delta since the
        last window rotation), stamped with the resolved kernel-config
        key. None until the first tick has drained (or when
        telemetry_live is off)."""
        if self._telem_lanes is None:
            return None
        delta = telem.lanes_delta(self._telem_lanes, self._telem_win)
        sig = telem.workload_signature(
            delta, config=devprof.grid_config_key(self.cfg.grid))
        sig["game_id"] = self.game_id
        sig["tick"] = self.tick_count
        sig["window_ticks"] = self.tick_count - self._telem_win_tick
        return sig

    def window_signature(self) -> dict | None:
        """The signature of the last COMPLETED rotation window (a
        governor's decision input). None until the first window has
        rotated."""
        if self._telem_last_window is None:
            return None
        sig = telem.workload_signature(
            self._telem_last_window,
            config=devprof.grid_config_key(self.cfg.grid))
        sig["game_id"] = self.game_id
        sig["tick"] = self.tick_count
        sig["window_ticks"] = self.SIG_WINDOW_TICKS
        return sig

    # ==================================================================
    # live tick-config swap (autotune governor)
    # ==================================================================
    def apply_tick_config(self, cfg2, step, *, telem_fold=None,
                          telem_acc0=None, telem_skin_on: bool = False,
                          telem_half_skin: float = 0.0) -> None:
        """Swap the resolved tick config BETWEEN ticks — the autotune
        governor's commit path (:mod:`goworld_tpu_torch.autotune`).
        ``step`` is the candidate's built and warmed step
        (:func:`_make_local_tick` at ``cfg2``, run once off the tick
        thread by the warm set, so nothing builds or first-launches
        here), ``cfg2`` its resolved WorldConfig. State carries over
        untouched except the Verlet cache, which is dropped or
        re-allocated invalid when the skin (or any cache-shaping knob)
        flips — the next tick rebuilds, so the swap is exact from its
        first tick.

        The live telemetry lanes follow the new config's lane set: the
        warmed fold and a copy of its zeroed accumulator swap in when
        given, else the lanes re-initialize; either way the signature
        window restarts — a window must never straddle two configs."""
        if self.n_spaces != 1:
            raise ValueError(
                "apply_tick_config serves single-shard non-mesh worlds")
        from goworld_tpu_torch.autotune.warmset import carry_state

        # a pipelined decode holding last tick's outputs must drain
        # first: they belong to the OLD config
        self.flush_pending_outputs()
        self._pending_telem = None
        self.state = carry_state(self.state, self.cfg, cfg2, stacked=True)
        self.cfg = cfg2
        self._step = step
        if self._telem_fn is not None or telem_fold is not None:
            if telem_fold is not None and telem_acc0 is not None:
                self._telem_fn = telem_fold
                # folds write the accumulator in place: the entry's zeroed
                # one stays zeroed for a later swap back
                self._telem_acc = telem.telemetry_clone(telem_acc0)
                self._telem_skin_on = bool(telem_skin_on)
                self._telem_half_skin = float(telem_half_skin)
            elif self.telemetry_live:
                try:
                    self._init_live_telemetry()
                except Exception:
                    logger.exception(
                        "live telemetry re-init failed on swap; disabled")
                    self._telem_fn = self._telem_acc = None
            # fresh window: drained lanes/marks of the old lane set must
            # never delta against the new accumulator
            self._telem_lanes = None
            self._telem_win = None
            self._telem_win_tick = self.tick_count
            self._telem_last_window = None
            self._telem_feed_mark = None

    def cost_report(self):
        """The step's cost report (:func:`devprof.cost_report`): the
        kernels' work and the roofline model's bytes at this World's
        config, and its state's, inputs' and outputs' bytes. Built from
        shapes; errors are folded into the report, never raised."""
        return devprof.cost_report(
            self.cfg, self.n_spaces, self.state, policy=self.policy,
            resident=self.resident, name="world.tick",
            config=devprof.grid_config_key(self.cfg.grid),
            n=self.cfg.capacity * self.n_spaces)

    # ==================================================================
    # the tick
    # ==================================================================
    def tick(self) -> None:
        # per-tick phase timeline: a serve loop may open the tick record
        # itself (so its own spans land in it too); a standalone World
        # opens its own and must close it even when a phase raises, or
        # the process-global recorder wedges
        tl = metrics.timeline
        self_opened = not tl.is_open
        if self_opened:
            tl.begin_tick()
        try:
            self._tick_phases(tl)
        finally:
            if self_opened:
                tl.end_tick()

    def _tick_phases(self, tl) -> None:
        t_start = time.perf_counter()
        # serve-loop residency marks: perf_counter instants at the
        # phase boundaries; nothing here touches the device
        rt = self.residency
        if rt is not None:
            rt.tick_begin()
        # sync-age epoch: this tick's state is decided by the inputs
        # flushed below, so the age of what it produces starts HERE
        age_mark = (self.tick_count, int(time.time() * 1e6))
        with tl.span("flush_staging"):
            self.timers.tick(self._fire_timer)
            self.crontab.tick()
            self.post_q.tick()
            inputs = self._flush_staging()
        self._pos_cache = self._yaw_cache = None
        t0 = time.perf_counter()
        with tl.span("device_step"):
            self.state, outs = self._step(self.state, inputs, self.policy)
            if self._telem_fn is not None:
                # fold THIS tick's outputs into the device lanes, in
                # place, no host sync; a fold failure disables the
                # lanes, never the tick
                try:
                    self._telem_acc = self._telem_fn(self._telem_acc, outs)
                except Exception:
                    logger.exception(
                        "live telemetry fold failed; disabled")
                    self._telem_fn = self._telem_acc = None
        if rt is not None:
            # the device has work from HERE: closes the previous
            # inter-dispatch gap
            rt.mark_dispatch()
        # audit-oracle cohort planes: on a sample tick the judged
        # shard's pos/alive/aoi_radius ride the same fetch below (not
        # under pipelining, where the audit skips its samples)
        aud_req = None
        ap = self.audit
        if (ap is not None and not self.pipeline_decode
                and ap.want_sample(self.tick_count)):
            s = self._audit_shard % self.n_spaces
            aud_req = (self.state.pos[s], self.state.alive[s],
                       self.state.aoi_radius[s])
        aud_host = None
        if self.pipeline_decode:
            # PIPELINED decode: tick N's outputs and accumulator start
            # their copy to the host now, on the copy stream, while tick
            # N - 1's (copied while this tick's step ran) are fetched and
            # decoded below. The frame pays max(device, host decode)
            # instead of their sum; host-visible events and client sends
            # lag one tick, and despawn releases one decode more
            # (_release_next). Freeze and swap paths call
            # flush_pending_outputs() first. Nothing to decode on the
            # first tick.
            lanes, split = self._fetch_lanes(outs, self._telem_acc, None)
            pending, self._pending_outs = self._pending_outs, (
                self._start_copy(lanes), split)
            # the outputs fetched below are the PREVIOUS tick's: the age
            # anchor follows them
            age_mark, self._age_pending_mark = \
                self._age_pending_mark, age_mark
            with tl.span("fetch_outputs"):
                if rt is not None:
                    rt.mark_fetch()
                outs = acc_host = None
                if pending is not None:
                    outs, acc_host, _ = pending[1](
                        self._finish_copy(pending[0]))
                elif self._pending_telem is not None:
                    acc_host = self._pending_telem
                self._pending_telem = None
                if rt is not None:
                    rt.mark_visible()
                self._ingest_host_telemetry(acc_host)
        else:
            with tl.span("fetch_outputs"):
                if rt is not None:
                    rt.mark_fetch()
                outs, acc_host, aud_host = self._fetch(
                    outs, self._telem_acc, aud_req)
                if rt is not None:
                    # outputs are host-visible: the device_wait lane ends
                    rt.mark_visible()
                self._ingest_host_telemetry(acc_host)
        if outs is not None and age_mark is not None:
            # outputs are host-visible NOW: close the device_tick lane
            self.sync_age_anchor = (age_mark[0], age_mark[1],
                                    int(time.time() * 1e6))
        # launch of the step plus the wait for its outputs (under
        # pipelining, the previous tick's): how long this frame waited
        # on the device
        dt = time.perf_counter() - t0
        self.op_stats["device_step_s"] = dt
        if rt is not None:
            rt.observe_device_step(dt)
        tl.set_tick_args(device_step_ms=round(dt * 1e3, 3),
                         tick=self.tick_count)
        with tl.span("decode_fanout"):
            if outs is not None:
                self._decode_outputs(outs)
            self.post_q.tick()
        ap = self.audit
        if ap is not None and ap.want_sample(self.tick_count):
            # capture the cohort + frozen interest sets HERE (the decode
            # just made them current), hand the oracle to the worker;
            # a capture failure disables the plane, never the tick
            try:
                self._audit_sample(aud_host)
            except Exception:
                logger.exception("audit sampling failed; disabled")
                self.audit = None
        if rt is not None:
            rt.mark_decode_done()
            if rt.should_sample(self.tick_count):
                # sampled census (address reads) and allocator stats;
                # a probe failure disables the plane, never the tick
                try:
                    rt.sample_census(self.state)
                    rt.sample_memory(self.device, self.tick_count)
                except Exception:
                    logger.exception(
                        "residency sampling failed; disabled")
                    self.residency = None
        self.tick_count += 1
        opmon.monitor.record("world.tick", time.perf_counter() - t_start)

    def _ingest_host_telemetry(self, acc_host) -> None:
        """Feed a fetched accumulator to the live lanes; a drain
        failure disables them, never the tick."""
        if acc_host is None:
            return
        try:
            self._ingest_telemetry(acc_host)
        except Exception:
            logger.exception("live telemetry drain failed; disabled")
            self._telem_fn = self._telem_acc = None

    def _decode_outputs(self, outs) -> None:
        """The host half of a tick: record and decode fetched outputs.
        Shared by the tick and :meth:`flush_pending_outputs`, so the
        pipelined and eager decodes cannot drift."""
        self.last_outputs = outs  # observability (tests, opmon)
        self._process_outputs(outs)
        self._drain_attr_journals()

    def flush_pending_outputs(self) -> None:
        """Drain the pipelined decode (a no-op when pipelining is off or
        nothing is pending): wait for the last tick's copy and decode
        it. Freeze, checkpoint, config-swap and shutdown paths call it
        first: a snapshot must not lose a tick's client sends and
        interest updates. The accumulator that rode the same copy is
        fed to the live lanes at the next tick's fetch, where the JAX
        World fetches it."""
        pending, self._pending_outs = self._pending_outs, None
        if pending is None:
            return
        outs, acc_host, _ = pending[1](self._finish_copy(pending[0]))
        self._pending_telem = acc_host
        self._decode_outputs(outs)

    # -- correctness audit sampling --------------------------------------
    def _audit_sample(self, aud_host) -> None:
        """Logic-thread half of one audit sample: decide eligibility
        (every skip recorded with its reason), run the cohort-bounded
        mirror probes inline, freeze the cohort's interest sets and the
        ledger census, and hand the oracle math to the audit worker. No
        device sync: ``aud_host`` rode the tick's fetch."""
        ap = self.audit
        tick = self.tick_count
        if self.pipeline_decode:
            # the decoded interest sets are tick N-1's while state.pos
            # is tick N's: the oracle would judge mismatched epochs
            ap.skip_sample("pipeline_decode", tick)
            return
        if aud_host is None:
            ap.skip_sample("no_fetch", tick)
            return
        if (self.op_stats.get("aoi_over_k_rows")
                or self.op_stats.get("aoi_over_cap_cells")):
            # the oracle's exactness precondition: a sweep that
            # overflowed k/cell_cap is approximate by design
            ap.skip_sample("overflow", tick)
            return
        s = self._audit_shard % self.n_spaces
        self._audit_shard += 1
        owner = dict(self._slot_owner[s])
        if not owner:
            ap.skip_sample("empty", tick)
            return
        # slots whose device rows lag the host this tick (staged
        # spawns/despawns/moves from decode callbacks, in-flight
        # migrations): judging them would manufacture mismatches
        pending = {sl for sh, sl, _ in self._staged_spawn if sh == s}
        pending |= {sl for sh, sl in self._staged_despawn if sh == s}
        pending |= {sl for sh, sl in self._staged_pos if sh == s}
        eligible = []
        for slot, eid in owner.items():
            if slot in pending:
                continue
            e = self.entities.get(eid)
            if (e is None or e.destroyed or e.slot is None
                    or e._migrating is not None
                    or e._pending_pos is not None):
                continue
            eligible.append(slot)
        cohort = ap.next_cohort(eligible)
        if not cohort:
            ap.skip_sample("empty", tick)
            return
        # mirror consistency probes, inline (cohort-bounded): slot->eid
        # mirror columns, client binding columns, interested_by edges
        probe_bad = 0
        for slot in cohort:
            eid = owner[slot]
            e = self.entities[eid]
            if self._mir_eid[s, slot] != eid.encode("ascii"):
                probe_bad += 1
                ap.ledger.note_violation(
                    "mirror_slot",
                    f"slot mirror [{s},{slot}] holds "
                    f"{self._mir_eid[s, slot]!r}, host says EntityID "
                    f"{eid} (tick {tick})", tick)
            cid = e.client.client_id.encode("ascii") \
                if e.client is not None else b""
            gid = e.client.gate_id if e.client is not None else -1
            if (self._mir_cid[s, slot] != cid
                    or int(self._mir_gate[s, slot]) != gid):
                probe_bad += 1
                ap.ledger.note_violation(
                    "mirror_client",
                    f"client mirror [{s},{slot}] diverges for EntityID "
                    f"{eid}: cols ({self._mir_cid[s, slot]!r}, "
                    f"{int(self._mir_gate[s, slot])}) vs host "
                    f"({cid!r}, {gid}) (tick {tick})", tick)
            for jid in e.interested_in:
                je = self.entities.get(jid)
                if je is None or eid not in je.interested_by:
                    probe_bad += 1
                    ap.ledger.note_violation(
                        "interest_symmetry",
                        f"EntityID {eid} watches {jid} but is not in "
                        f"its interested_by (tick {tick})", tick)
        ap.note_probe(len(cohort), probe_bad)
        # ledger-vs-world census cross-check: both sides frozen NOW on
        # the logic thread (the worker only diffs)
        world_live = {eid for eid, e in self.entities.items()
                      if not e.destroyed}
        ledger_live = ap.ledger.live_eids()
        # frozen interest sets for the cohort (the worker must not
        # chase live sets the next tick is already mutating)
        interest = {owner[slot]: set(self.entities[owner[slot]]
                                     .interested_in)
                    for slot in cohort}
        pos, alive, wr = aud_host
        quant_step = quant_hi = None
        if self.cfg.grid.precision != "off":
            quant_step = self.cfg.grid.quant_step
            quant_hi = (1 << consts.PRECISION_POS_BITS) - 1
        radius = self.cfg.grid.radius

        def _job():
            diff = sorted(world_live ^ ledger_live)
            if diff:
                ap.ledger.note_violation(
                    "census_divergence",
                    f"ledger and world census diverge at EntityID "
                    f"{diff[0]} ({len(diff)} differ; tick {tick})",
                    tick)
            ap.judge_sample(
                tick=tick, pos=pos, alive=alive, watch_radius=wr,
                radius=radius, cohort_slots=cohort, owner=owner,
                interest=interest, quant_step=quant_step,
                quant_hi=quant_hi or 0)

        ap.submit(_job)

    # -- staging flush --------------------------------------------------
    def _flush_staging(self) -> TickInputs:
        """Apply every staged mutation to the device state and build the
        tick's position-sync inputs.

        The JAX World's scatters in the same order (the migration
        repack, spawn, despawn, hot attrs, moving flags, client
        bindings, then the inputs), with the same final values: each
        stage's host lanes are built once in numpy, every (row, column)
        written once with its last staged value, all lanes sent in one
        copy, each row addressed by its flat index ``shard * capacity +
        slot``. The host reads the device on a tick with migrations
        only (:meth:`_repack_migrations`); a position or yaw the inputs
        must keep is gathered from the state on the device."""
        cfg = self.cfg
        cap = cfg.capacity
        pack = _HostPack()
        if self._staged_migrate:
            self._repack_migrations()

        spawn = None
        if self._staged_spawn:
            d = [v for _, _, v in self._staged_spawn]
            spawn = [pack.add(x) for x in (
                np.array([sh * cap + sl for sh, sl, _ in self._staged_spawn],
                         np.int64),
                np.array([x["pos"] for x in d], np.float32).reshape(-1, 3),
                np.array([x["yaw"] for x in d], np.float32),
                np.array([x["npc_moving"] for x in d], bool),
                np.array([x["has_client"] for x in d], bool),
                np.array([x["client_gate"] for x in d], np.int32),
                np.array([x["type_id"] for x in d], np.int32),
                np.array([x["hot"] for x in d], np.float32).reshape(
                    -1, cfg.attr_width),
                np.array([x.get("aoi_radius", np.inf) for x in d],
                         np.float32),
            )]
            # the device row now holds the spawn position; clear the host
            # mirror so Entity.position tracks the live row (unless a
            # newer set_position is staged — that loop clears its own)
            for shard_, slot_, _ in self._staged_spawn:
                if (shard_, slot_) in self._staged_pos:
                    continue
                e_ = self._owner_entity(shard_, slot_)
                if e_ is not None:
                    e_._pending_pos = None
                    e_._pending_yaw = None
            self._staged_spawn.clear()

        despawn = None
        if self._staged_despawn:
            despawn = pack.add(np.array(
                [sh * cap + sl for sh, sl in self._staged_despawn],
                np.int64))
            # release AFTER this tick's leave events decode: at the end
            # of this tick's decode, or of the next one when the decode
            # is pipelined (this tick's outputs decode next tick; a
            # release now would let a reused slot take the old entity's
            # pending leave events)
            rel = (self._release_next if self.pipeline_decode
                   else self._release_now)
            rel.extend(
                (sh_, sl_, self._slot_owner[sh_].get(sl_))
                for sh_, sl_ in self._staged_despawn
            )
            self._staged_despawn.clear()

        def rows_of(staged) -> np.ndarray:
            return np.array([x[0] * cap + x[1] for x in staged], np.int64)

        hot = None
        if self._staged_hot:
            rw = rows_of(self._staged_hot)
            co = np.array([x[2] for x in self._staged_hot], np.int64)
            va = np.array([x[3] for x in self._staged_hot], np.float32)
            keep = _keep_last(rw * cfg.attr_width + co)
            hot = [pack.add(x[keep]) for x in (rw, co, va)]
            self._staged_hot.clear()

        moving = None
        if self._staged_moving:
            rw = rows_of(self._staged_moving)
            mv = np.array([x[2] for x in self._staged_moving], bool)
            keep = _keep_last(rw)
            moving = [pack.add(x[keep]) for x in (rw, mv)]
            self._staged_moving.clear()

        client = None
        if self._staged_client:
            rw = rows_of(self._staged_client)
            hc = np.array([x[2] for x in self._staged_client], bool)
            cg = np.array([x[3] for x in self._staged_client], np.int32)
            keep = _keep_last(rw)
            client = [pack.add(x[keep]) for x in (rw, hc, cg)]
            self._staged_client.clear()

        # position-sync inputs -> TickInputs [S, IC]
        ic = cfg.input_cap
        idx = self._pin_idx
        vals = self._pin_vals
        counts = self._pin_counts
        idx.fill(0)
        vals.fill(0)
        counts.fill(0)
        # rows whose position (a set_yaw alone) or yaw (a set_position
        # alone) is the device row's current one: gathered on the device
        fill_pos = np.zeros((self.n_spaces, ic), bool)
        fill_yaw = np.zeros((self.n_spaces, ic), bool)
        entries = list(self._staged_pos.items())
        overflow: dict[tuple[int, int], Entity] = {}
        for (shard, slot), e in entries:
            c = counts[shard]
            if c >= ic:
                # keep it staged so the write lands next tick instead of
                # silently diverging host (_pending_pos) from device
                overflow[(shard, slot)] = e
                continue
            p = e._pending_pos
            if p is None:
                p = self._peek_batch_pos(shard, slot)
                if p is None:
                    fill_pos[shard, c] = True
                    p = (0.0, 0.0, 0.0)
            y = e._pending_yaw
            if y is None:
                fill_yaw[shard, c] = True
                y = 0.0
            idx[shard, c] = slot
            vals[shard, c] = (p[0], p[1], p[2], y)
            counts[shard] = c + 1
            e._pending_pos = None
            e._pending_yaw = None
        self._staged_pos = overflow
        if overflow:
            logger.warning(
                "pos-sync input overflow: %d updates deferred a tick",
                len(overflow),
            )

        # batched client syncs (stage_pos_sync_batch) fill the remaining
        # input rows; host-side writes staged this tick shadow a client
        # record for the same slot (the slots of one batch are unique),
        # and rows that don't fit stay staged for the next tick
        if self._batch_pos_any:
            bm = self._batch_pos_mask
            if entries:
                hsh = np.array([k[0] for k, _ in entries], np.int32)
                hsl = np.array([k[1] for k, _ in entries], np.int32)
                bm[hsh, hsl] = False
            bsh, bsl = np.nonzero(bm)
            deferred = 0
            if bsh.size:
                bv = self._batch_pos_vals[bsh, bsl]
                for shard in np.unique(bsh):
                    m = np.nonzero(bsh == shard)[0]
                    room = max(ic - int(counts[shard]), 0)
                    take = m[:room]
                    k = take.size
                    if k:
                        c0 = int(counts[shard])
                        idx[shard, c0:c0 + k] = bsl[take]
                        vals[shard, c0:c0 + k] = bv[take]
                        counts[shard] = c0 + k
                        bm[shard, bsl[take]] = False
                    deferred += m.size - k
            if deferred:
                logger.warning(
                    "pos-sync input overflow: %d client sync records "
                    "deferred a tick", deferred,
                )
            self._batch_pos_any = bool(bm.any())

        need_pos, need_yaw = bool(fill_pos.any()), bool(fill_yaw.any())
        inp = [pack.add(x) for x in (idx, vals, counts)]
        fills = [pack.add(x) for x in (fill_pos, fill_yaw)] \
            if need_pos or need_yaw else None

        lanes = pack.send(self.device)
        st = self.state

        def flat(lane):
            # the stacked lane's rows as one [S * capacity, ...] view
            return lane.view(-1, *lane.shape[2:])

        if spawn is not None:
            rw, p_, y_, mv, hc, cg, ti, ht, ar = (lanes[i] for i in spawn)
            flat(st.pos).index_copy_(0, rw, p_)
            flat(st.yaw).index_copy_(0, rw, y_)
            flat(st.vel).index_fill_(0, rw, 0.0)
            flat(st.alive).index_fill_(0, rw, True)
            flat(st.npc_moving).index_copy_(0, rw, mv)
            flat(st.has_client).index_copy_(0, rw, hc)
            flat(st.client_gate).index_copy_(0, rw, cg)
            flat(st.type_id).index_copy_(0, rw, ti)
            flat(st.aoi_radius).index_copy_(0, rw, ar)
            flat(st.gen).index_add_(0, rw, torch.ones_like(ti))
            flat(st.dirty).index_fill_(0, rw, True)
            flat(st.hot_attrs).index_copy_(0, rw, ht)
            flat(st.attr_dirty).index_fill_(0, rw, 0)
        if despawn is not None:
            rw = lanes[despawn]
            flat(st.alive).index_fill_(0, rw, False)
            flat(st.has_client).index_fill_(0, rw, False)
            flat(st.client_gate).index_fill_(0, rw, -1)
            flat(st.npc_moving).index_fill_(0, rw, False)
            flat(st.dirty).index_fill_(0, rw, False)
        if hot is not None:
            rw, co, va = (lanes[i] for i in hot)
            flat(st.hot_attrs).index_put_((rw, co), va)
        if moving is not None:
            rw, mv = (lanes[i] for i in moving)
            flat(st.npc_moving).index_copy_(0, rw, mv)
        if client is not None:
            rw, hc, cg = (lanes[i] for i in client)
            flat(st.has_client).index_copy_(0, rw, hc)
            flat(st.client_gate).index_copy_(0, rw, cg)
        d_idx, d_vals, d_counts = (lanes[i] for i in inp)
        if fills is not None:
            f_pos, f_yaw = (lanes[i] for i in fills)
            rows = d_idx.long()
            sp = torch.arange(self.n_spaces, device=rows.device)[:, None]
            if need_pos:
                d_vals[..., :3] = torch.where(
                    f_pos[..., None], st.pos[sp, rows], d_vals[..., :3])
            if need_yaw:
                d_vals[..., 3] = torch.where(f_yaw, st.yaw[sp, rows],
                                             d_vals[..., 3])
        return TickInputs(pos_sync_idx=d_idx, pos_sync_vals=d_vals,
                          pos_sync_n=d_counts)

    def _repack_migrations(self) -> None:
        """The staged migrations between AOI Spaces as a host repack
        (the JAX World's local path): one gather of every migrating row
        and one device-to-host copy, then each entity respawned at a
        slot of its destination Space (its staged position, else its
        row's), its source row despawned (so its watchers get their
        leave events this tick), the hot attrs written during the window
        written over the row, and the hooks run: ``OnMigrateIn``,
        ``OnEnterSpace``, the Space's ``OnEntityEnterSpace``."""
        cap = self.cfg.capacity
        live = [
            m for m in self._staged_migrate
            if (e := self.entities.get(m[3])) is not None
            and not e.destroyed
        ]
        self._staged_migrate.clear()
        if not live:
            return
        st = self.state
        rw = torch.as_tensor(np.array([sh * cap + sl for sh, sl, _, _ in live],
                                      np.int64)).to(self.device)

        def rows(lane):
            return lane.view(-1, *lane.shape[2:]).index_select(0, rw)

        pos, yaw, type_id, moving, has_client, gate, hot = self._dget([
            rows(st.pos), rows(st.yaw), rows(st.type_id),
            rows(st.npc_moving), rows(st.has_client), rows(st.client_gate),
            rows(st.hot_attrs)])
        for i, (sh_, sl_, dst, eid) in enumerate(live):
            e = self.entities[eid]
            e._migrating = None
            new_slot = self._alloc_slot(dst, eid)
            pend = e._pending_pos or tuple(pos[i].tolist())
            self._staged_spawn.append((dst, new_slot, dict(
                pos=pend, yaw=float(yaw[i]),
                type_id=int(type_id[i]),
                npc_moving=bool(moving[i]),
                has_client=bool(has_client[i]),
                client_gate=int(gate[i]),
                hot=hot[i].tolist(),
                aoi_radius=_type_aoi_radius(e._type_desc),
            )))
            # old slot: despawn now; owner mapping stays for this
            # step's leave events, slot frees after processing
            self._staged_despawn.append((sh_, sl_))
            e.slot = new_slot
            e.shard = dst
            e._pending_pos = pend
            # attr writes made during the migration window are only in
            # the host tree; overwrite the repacked row's hot columns
            for name, col in e._type_desc.hot_attrs.items():
                v = e.attrs.get(name)
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    self._staged_hot.append((dst, new_slot, col,
                                             float(v)))
            e.OnMigrateIn()
            e.OnEnterSpace()
            tgt_id = self._shard_space[dst]
            tgt = self.spaces.get(tgt_id) if tgt_id else None
            if tgt is not None:
                tgt.OnEntityEnterSpace(e)

    # -- output processing ----------------------------------------------
    def _process_outputs(self, outs) -> None:
        base = outs
        cfg = self.cfg
        # Leaves before enters. The pair-decode loops below run at
        # event-cap volumes every tick: owner resolution is inlined (two
        # dict gets, no helper-call overhead; dict.get(None) is safely
        # None) and the AOI hook call + its exception containment is
        # skipped for types that don't override the no-op hook. The
        # override test is cached per CLASS per decode (so post-
        # registration class patching is honored) with a per-pair
        # instance-__dict__ check for per-object hook assignment.
        entities = self.entities
        leave_hooked: dict[type, bool] = {}
        enter_hooked: dict[type, bool] = {}
        # pairs read but not applied (an owner already gone): the
        # decoded counts of op_stats are the pairs read less these
        leave_skip = enter_skip = 0
        leave_read = enter_read = sync_sent = 0
        shards = range(self.n_spaces)
        for shard in shards:
            ln = int(base.leave_n[shard])
            if ln > cfg.leave_cap:
                logger.warning(
                    "shard %d leave overflow: %d > %d", shard, ln,
                    cfg.leave_cap,
                )
            ln = min(ln, cfg.leave_cap)
            leave_read += ln
            slot_eid = self._slot_owner[shard].get
            # .tolist() upfront: plain-int pairs beat per-element numpy
            # scalar conversions across tens of thousands of events
            for w, j in zip(base.leave_w[shard][:ln].tolist(),
                            base.leave_j[shard][:ln].tolist()):
                we = entities.get(slot_eid(w))
                je = entities.get(slot_eid(j))
                if we is None or je is None:
                    leave_skip += 1
                    continue
                we.interested_in.discard(je.id)
                je.interested_by.discard(we.id)
                wcls = we.__class__
                hooked = leave_hooked.get(wcls)
                if hooked is None:
                    hooked = leave_hooked[wcls] = (
                        wcls.OnLeaveAOI is not Entity.OnLeaveAOI)
                if hooked or "OnLeaveAOI" in we.__dict__:
                    try:
                        we.OnLeaveAOI(je)
                    except Exception:
                        logger.exception("OnLeaveAOI failed")
                if we.client is not None and not we.destroyed:
                    we.client.send({
                        "type": "destroy_entity", "eid": je.id,
                        "is_player": False,
                    })
        for shard in shards:
            drn = int(base.delta_rows_n[shard])
            drc = min(cfg.delta_rows_cap_eff, cfg.capacity)
            if drn > drc:
                # the ROW cap overflowed: surplus rows' enter/leave events
                # are gone and widening enter/leave caps won't help
                logger.warning(
                    "shard %d AOI delta rows overflow: %d > %d — widen "
                    "WorldConfig.delta_rows_cap", shard, drn, drc,
                )
            en = int(base.enter_n[shard])
            if en > cfg.enter_cap:
                logger.warning(
                    "shard %d enter overflow: %d > %d", shard, en,
                    cfg.enter_cap,
                )
            en = min(en, cfg.enter_cap)
            enter_read += en
            # per-decode payload cache: one subject typically enters
            # MANY watchers' interest this tick, and its AllClients attr
            # snapshot + pos/yaw are identical for each — computed once
            # per subject. The attrs dict is shared read-only across the
            # sends.
            payloads: dict[str, tuple] = {}
            slot_eid = self._slot_owner[shard].get
            for w, j in zip(base.enter_w[shard][:en].tolist(),
                            base.enter_j[shard][:en].tolist()):
                we = entities.get(slot_eid(w))
                je = entities.get(slot_eid(j))
                if we is None or je is None:
                    enter_skip += 1
                    continue
                we.interested_in.add(je.id)
                je.interested_by.add(we.id)
                wcls = we.__class__
                hooked = enter_hooked.get(wcls)
                if hooked is None:
                    hooked = enter_hooked[wcls] = (
                        wcls.OnEnterAOI is not Entity.OnEnterAOI)
                if hooked or "OnEnterAOI" in we.__dict__:
                    try:
                        we.OnEnterAOI(je)
                    except Exception:
                        logger.exception("OnEnterAOI failed")
                if we.client is not None and not je.destroyed:
                    pc = payloads.get(je.id)
                    if pc is None:
                        pc = payloads[je.id] = (
                            je.type_name,
                            je.get_all_clients_data(),
                            list(je.position),
                            je.yaw,
                        )
                    we.client.send({
                        "type": "create_entity", "eid": je.id,
                        "etype": pc[0], "is_player": False,
                        "attrs": pc[1], "pos": pc[2], "yaw": pc[3],
                    })
        for shard in shards:
            # position sync records -> watching clients
            sn = min(int(base.sync_n[shard]), cfg.sync_cap)
            if sn:
                ws = base.sync_w[shard][:sn]
                js = base.sync_j[shard][:sn]
                vs = base.sync_vals[shard][:sn]
                if self.sync_sink is not None:
                    # batched path: one (cids, eids, vals) bundle per
                    # gate per tick, resolved through the numpy slot
                    # mirrors (one gather + per-gate groupby); the
                    # boolean-masked selections COPY, so the scratch
                    # never escapes this method
                    cids = np.take(self._mir_cid[shard], ws,
                                   out=self._scr_cid[:sn])
                    gates = np.take(self._mir_gate[shard], ws,
                                    out=self._scr_gate[:sn])
                    jeids = np.take(self._mir_eid[shard], js,
                                    out=self._scr_eid[:sn])
                    ok = (cids != b"") & (jeids != b"")
                    sync_sent += int(ok.sum())
                    for gate_id in np.unique(gates[ok]):
                        m = ok & (gates == gate_id)
                        self.sync_sink(
                            int(gate_id), cids[m], jeids[m], vs[m]
                        )
                else:
                    for w, j, v in zip(ws, js, vs):
                        we = self._owner_entity(shard, int(w))
                        je = self._owner_entity(shard, int(j))
                        if we is None or we.client is None or je is None:
                            continue
                        sync_sent += 1
                        we.client.send({
                            "type": "sync", "eid": je.id,
                            "pos": [float(v[0]), float(v[1]), float(v[2])],
                            "yaw": float(v[3]),
                        })
            # device-side hot-attr deltas (kernel-mutated attrs)
            an = min(int(base.attr_n[shard]), cfg.attr_sync_cap)
            if an:
                es = base.attr_e[shard][:an]
                cs = base.attr_i[shard][:an]
                vs = base.attr_v[shard][:an]
                slot_eid = self._slot_owner[shard].get
                dirty = self._dirty_attr_entities
                for slot, col, v in zip(es.tolist(), cs.tolist(),
                                        vs.tolist()):
                    e = entities.get(slot_eid(slot))
                    if e is None:
                        continue
                    info = e._type_desc.hot_attr_by_col.get(col)
                    if info is None:
                        continue
                    name, aud = info
                    attrs = e.attrs
                    if isinstance(attrs._d.get(name),
                                  (MapAttr, ListAttr)):
                        # a hot attr shadowed by a tree node — take the
                        # orphaning slow path (same journal policy)
                        self._apply_device_attr(e, name, v, aud)
                        continue
                    attrs._d[name] = v
                    # journal ONLY deltas someone will receive
                    if aud is not None and (
                        e.client is not None
                        or (aud == "all_clients" and e.interested_by)
                    ):
                        dirty.setdefault(e.id, []).append(
                            AttrDelta((name,), "set", v))
        self.op_stats["aoi_leave_decoded"] = leave_read - leave_skip
        self.op_stats["aoi_enter_decoded"] = enter_read - enter_skip
        self.op_stats["sync_records_sent"] = sync_sent

        # AOI-cap overflow gauges: live worlds must never degrade to
        # nearest-k / dropped candidates SILENTLY (the go-aoi sweep is
        # exact at any density, Space.go:244-252). The gauges are
        # exposed every tick; the alarm is rate-limited.
        dem_max = int(np.max(base.aoi_demand_max))
        over_k = int(np.sum(base.aoi_over_k_rows))
        cell_max = int(np.max(base.aoi_cell_max))
        over_cap = int(np.sum(base.aoi_over_cap_cells))
        # interest-migration volume (TRUE demand — may exceed the
        # enter/leave caps, which the overflow warnings above alarm)
        enters = int(np.sum(base.enter_n))
        leaves = int(np.sum(base.leave_n))
        opmon.expose("aoi_enter_events", enters)
        opmon.expose("aoi_leave_events", leaves)
        self.op_stats["aoi_enter_events"] = enters
        self.op_stats["aoi_leave_events"] = leaves
        opmon.expose("aoi_demand_max", dem_max)
        opmon.expose("aoi_over_k_rows", over_k)
        opmon.expose("aoi_cell_max", cell_max)
        opmon.expose("aoi_over_cap_cells", over_cap)
        self.op_stats["aoi_demand_max"] = dem_max
        self.op_stats["aoi_over_k_rows"] = over_k
        self.op_stats["aoi_cell_max"] = cell_max
        self.op_stats["aoi_over_cap_cells"] = over_cap
        self._m_aoi_demand.set(dem_max)
        self._m_aoi_cell.set(cell_max)
        rebuilds = int(np.sum(base.aoi_rebuilt))
        slack = float(np.min(base.aoi_skin_slack))
        if rebuilds:
            self._m_aoi_rebuild.inc(rebuilds)
        self._m_aoi_slack.set(slack)
        opmon.expose("aoi_rebuild_last", rebuilds)
        opmon.expose("aoi_skin_slack", slack)
        self.op_stats["aoi_rebuild_last"] = rebuilds
        self.op_stats["aoi_skin_slack"] = slack
        if over_k or over_cap:
            self._m_aoi_overflow.inc(over_k + over_cap)
        if (over_k or over_cap) and \
                self.tick_count - self._aoi_alarm_tick >= 64:
            self._aoi_alarm_tick = self.tick_count
            logger.warning(
                "AOI cap overflow: %d rows truncated to nearest-%d "
                "(demand max %d), %d cells past cell_cap=%d (occupancy "
                "max %d). Interest sets are degraded this tick. "
                "Re-provision: raise GridSpec.k above the demand max "
                "and/or cell_cap above the occupancy max.",
                over_k, self.cfg.grid.k, dem_max,
                over_cap, self.cfg.grid.cell_cap, cell_max,
            )

        # release slots whose leave events have now been processed
        for shard, slot, expect in self._release_now:
            cur = self._slot_owner[shard].get(slot)
            if cur == expect:
                self._slot_clear(shard, slot)
                self._free[shard].add(slot)
            # forget destroyed host objects: destroy_entity kept them
            # alive only for this release point
            if expect is not None:
                e = self.entities.get(expect)
                if e is not None and e.destroyed and e.slot is None:
                    self.entities.pop(expect, None)
        self._release_now = self._release_next
        self._release_next = []

    # ==================================================================
    # device reads
    # ==================================================================
    def _dget(self, lanes: list[torch.Tensor]) -> list[np.ndarray]:
        """Host copies of device ``lanes`` (32-bit or 1-byte types), as
        numpy in the JAX package's types: one concatenation of the
        lanes' 32-bit words (a 1-byte lane, such as ``alive``, padded
        to whole words first), one copy to the host and, on a card, one
        stream synchronisation (the copy goes into pinned memory,
        non-blocking), whatever the number of lanes."""
        src = _pack_words(lanes)
        if self.device.type == "cuda":
            host = torch.empty(src.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(src, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            host = src  # torch.cat made it: a copy of every lane
        return _unpack_words(host.numpy(), lanes)

    def _start_copy(self, lanes: list[torch.Tensor]) -> tuple:
        """The pipelined drain's copy of ``lanes``: their words packed by
        one concatenation on the compute stream (a snapshot, so the next
        tick may write every lane, the telemetry accumulator's folds in
        place included, in stream order after it), then, on a card,
        copied into pinned memory on the World's copy stream once an
        event recorded after the packing has passed. The packed buffer
        is marked as used by the copy stream, so the caching allocator
        cannot hand its memory to the next tick while the copy is in
        flight. Returns ``(host words, copy event or None, shapes)`` for
        :meth:`_finish_copy`; nothing here waits."""
        src = _pack_words(lanes)
        meta = [(tuple(t.shape), t.dtype) for t in lanes]
        if self.device.type != "cuda":
            return src, None, meta
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        cs = self._copy_stream
        packed = torch.cuda.Event()
        packed.record(torch.cuda.current_stream(self.device))
        cs.wait_event(packed)
        host = torch.empty(src.shape, dtype=torch.int32, pin_memory=True)
        with torch.cuda.stream(cs):
            host.copy_(src, non_blocking=True)
        src.record_stream(cs)
        done = torch.cuda.Event()
        done.record(cs)
        return host, done, meta

    @staticmethod
    def _finish_copy(pending: tuple) -> list[np.ndarray]:
        """The lanes of a :meth:`_start_copy` as numpy, after waiting for
        its copy event: the pipelined tick's one host sync."""
        host, done, meta = pending
        if done is not None:
            done.synchronize()
        return _unpack_words(host.numpy(), meta)

    def _fetch(self, outs: TickOutputs, acc=None, aud=None) -> tuple:
        """The step's outputs as numpy lanes, with the telemetry
        accumulator ``acc`` (a dict of lanes) and the audit planes
        ``aud`` (a tuple) when given, all in one transfer: (outputs,
        host accumulator or None, host audit planes or None)."""
        lanes, split = self._fetch_lanes(outs, acc, aud)
        return split(self._dget(lanes))

    @staticmethod
    def _fetch_lanes(outs: TickOutputs, acc, aud) -> tuple:
        """The lanes :meth:`_fetch` reads and the function that splits
        their host copies into its triple."""
        names = [f.name for f in dataclasses.fields(outs)
                 if getattr(outs, f.name) is not None]
        lanes = [getattr(outs, n) for n in names]
        acc_keys = list(acc) if acc is not None else []
        lanes += [acc[k] for k in acc_keys]
        lanes += list(aud) if aud is not None else []
        n, m = len(names), len(acc_keys)

        def split(got):
            return (dataclasses.replace(outs, **dict(zip(names, got[:n]))),
                    dict(zip(acc_keys, got[n:n + m])) if acc is not None
                    else None,
                    tuple(got[n + m:]) if aud is not None else None)

        return lanes, split

    def read_pos(self, shard: int, slot: int) -> np.ndarray:
        if self._pos_cache is None:
            self._pos_cache = self._dget([self.state.pos])[0]
        return self._pos_cache[shard, slot]

    def read_yaw(self, shard: int, slot: int) -> float:
        if self._yaw_cache is None:
            self._yaw_cache = self._dget([self.state.yaw])[0]
        return float(self._yaw_cache[shard, slot])
