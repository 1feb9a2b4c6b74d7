"""Warm-set: built and warmed steps for candidate tick configs, the port
of ``goworld_tpu/autotune/warmset.py``.

The whole point of the governor is a swap with no stall on the tick
thread, so the target config's step must be ready BEFORE the swap
commits. The reference AOT-compiles an XLA executable per candidate. A
torch step compiles nothing, but its first launches load the kernels of
``csrc/`` (and build the library with ``nvcc`` the first time in the
process), so "warm" here means: each :class:`WarmEntry` carries the
candidate's resolved ``WorldConfig``, its built step
(:func:`~goworld_tpu_torch.entity.manager._make_local_tick`), its live
telemetry fold and a zeroed accumulator, and the step and fold have run
once on a scratch state at the candidate's shapes, on a worker thread
with a CUDA stream of its own. A swap then builds and first-launches
nothing on the tick thread.

State carry-over lives here too (:func:`carry_state`): flipping the
Verlet skin on allocates a fresh INVALID cache (the next tick rebuilds —
exact by construction), flipping it off drops the cache lanes, and any
cache-shape-affecting knob change (verlet_cap, precision, skin width)
re-allocates. Everything else in ``SpaceState`` is config-independent
and carries through untouched. The resident carry copies a new step's
lanes into the carried state's: after a swap that state is the carried
one, so no copy can land in a dropped cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any

import torch

from goworld_tpu_torch.autotune.policy import (
    DEFAULT_CANDIDATES,
    candidate_overrides,
)
from goworld_tpu_torch.utils import consts, log

logger = log.get("autotune")

__all__ = ["WarmEntry", "WarmSet", "candidate_config", "carry_state"]


def candidate_config(cfg, overrides: dict):
    """Resolve a candidate's ``WorldConfig`` from the base config +
    GridSpec overrides. Validation rides ``GridSpec.__post_init__``;
    the packed-id capacity bound clears a requested skin as the
    reference does."""
    kw = dict(overrides)
    if kw.get("skin", cfg.grid.skin) > 0 \
            and cfg.capacity >= (1 << consts.AOI_ID_BITS):
        kw["skin"] = 0.0  # the Verlet reuse rides the packed-id path
    grid = dataclasses.replace(cfg.grid, **kw)
    return dataclasses.replace(cfg, grid=grid)


def _cache_shape_key(grid) -> tuple:
    """The knobs that decide the Verlet cache's existence and layout —
    equal keys mean a carried cache stays VALID across the swap."""
    return (grid.skin > 0, grid.verlet_cap, grid.precision, grid.skin,
            grid.radius)


def carry_state(state, old_cfg, new_cfg, *, stacked: bool = True):
    """Carry a live ``SpaceState`` across a config flip: only the Verlet
    cache is config-shaped; everything else carries untouched. A fresh
    cache is allocated INVALID on the state's device, so the first tick
    under the new config rebuilds — the swap is exact from its very
    first tick. ``stacked``: the World's ``[1, ...]`` lanes."""
    from goworld_tpu_torch.ops.aoi import init_verlet_cache

    if _cache_shape_key(old_cfg.grid) == _cache_shape_key(new_cfg.grid):
        return state
    if new_cfg.grid.skin <= 0:
        return state.replace(aoi_cache=None)
    cache = init_verlet_cache(new_cfg.grid, new_cfg.capacity,
                              state.pos.device)
    if stacked:
        cache = cache.apply(lambda t: t.unsqueeze(0))
    return state.replace(aoi_cache=cache)


@dataclasses.dataclass
class WarmEntry:
    """One candidate's warmed artifacts (immutable once warm)."""

    label: str
    cfg: Any                      # resolved WorldConfig
    step: Any = None              # built step, run once
    fold: Any = None              # telemetry fold, run once (or None)
    acc0: Any = None              # zeroed telemetry accumulator
    skin_on: bool = False
    half_skin: float = 0.0
    error: str | None = None
    warm_s: float = 0.0

    @property
    def warm(self) -> bool:
        return self.step is not None and self.error is None


class WarmSet:
    """Candidate-config step cache for ONE World shape.

    ``ensure(label)`` schedules an off-thread warm (idempotent);
    ``is_warm(label)`` gates the swap commit; ``entry(label)`` hands the
    governor the warmed artifacts. ``block=True`` warms synchronously
    (tests, prewarm)."""

    def __init__(self, cfg, n_spaces: int, policy=None, *,
                 candidates=DEFAULT_CANDIDATES, telemetry: bool = True,
                 resident: bool = True, device="cuda"):
        if n_spaces != 1:
            raise ValueError(
                "WarmSet serves the single-shard production shape "
                f"(n_spaces=1), got n_spaces={n_spaces}")
        from goworld_tpu_torch.core.state import resolve_device

        self.base_cfg = cfg
        self.n_spaces = n_spaces
        self.policy = policy
        self.candidates = tuple(candidates)
        self.telemetry = telemetry
        # every candidate step keeps the World's carry contract, so a
        # swap never changes where the lanes live
        self.resident = resident
        self.device = resolve_device(device)
        self._entries: dict[str, WarmEntry] = {}
        self._lock = threading.Lock()
        self._inflight: set[str] = set()
        self._worker: threading.Thread | None = None
        self._queue: list[str] = []
        self._wake = threading.Condition(self._lock)
        self.warm_count = 0  # tests assert no re-warms on a re-swap

    # -- public ----------------------------------------------------------
    def labels(self) -> list[str]:
        return [lbl for lbl, _ in self.candidates]

    def is_warm(self, label: str) -> bool:
        with self._lock:
            e = self._entries.get(label)
            return e is not None and e.warm

    def entry(self, label: str) -> WarmEntry | None:
        with self._lock:
            return self._entries.get(label)

    def ensure(self, label: str, block: bool = False) -> bool:
        """Schedule (or synchronously run) the candidate's warm; returns
        True when it is warm on return. ``block=True`` with the same
        label already warming on the worker WAITS for it instead of
        warming twice."""
        candidate_overrides(label, self.candidates)  # loud on typos
        with self._lock:
            e = self._entries.get(label)
            if e is not None and (e.warm or e.error):
                return e.warm
            inflight = label in self._inflight
            if not block:
                if not inflight:
                    self._inflight.add(label)
                    self._queue.append(label)
                    self._wake.notify()
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(
                        target=self._worker_loop,
                        name="autotune-warmset", daemon=True)
                    self._worker.start()
                return False
            if not inflight:
                self._inflight.add(label)
        if inflight:
            while True:
                with self._lock:
                    done = label not in self._inflight
                if done:
                    return self.is_warm(label)
                time.sleep(0.05)
        try:
            self._warm(label)
        finally:
            with self._lock:
                self._inflight.discard(label)
        return self.is_warm(label)

    def warm_all(self) -> None:
        """Synchronously warm every candidate (prewarm)."""
        for lbl in self.labels():
            self.ensure(lbl, block=True)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                lbl: {
                    "warm": e.warm,
                    "error": e.error,
                    "warm_s": round(e.warm_s, 3),
                    "config": {
                        "sweep_impl": e.cfg.grid.sweep_impl,
                        "sort_impl": e.cfg.grid.sort_impl,
                        "topk_impl": e.cfg.grid.topk_impl,
                        "skin": e.cfg.grid.skin,
                    },
                }
                for lbl, e in self._entries.items()
            } | {"inflight": sorted(self._inflight),
                 "warms": self.warm_count}

    # -- worker ----------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue:
                    self._wake.wait(timeout=60.0)
                    if not self._queue:
                        # retire; clear the handle UNDER THE LOCK so an
                        # ensure() racing the exit starts a new worker
                        if self._worker is threading.current_thread():
                            self._worker = None
                        return
                label = self._queue.pop(0)
            try:
                self._warm(label)
            finally:
                with self._lock:
                    self._inflight.discard(label)

    def _warm(self, label: str) -> None:
        """Build the candidate's step and fold and run each once on a
        scratch state at its shapes, on a stream of this thread's own
        (the tick thread's stream never waits on it)."""
        from goworld_tpu_torch.core.step import TickInputs
        from goworld_tpu_torch.entity.manager import _lanes_of, \
            _make_local_tick
        from goworld_tpu_torch.ops import telemetry as telem
        from goworld_tpu_torch.parallel.mesh import create_multi_state

        t0 = time.perf_counter()
        try:
            cfg2 = candidate_config(
                self.base_cfg, candidate_overrides(label, self.candidates))
            entry = WarmEntry(label=label, cfg=cfg2)
            step = _make_local_tick(cfg2, self.n_spaces, self.device,
                                    self.resident)
            cuda = self.device.type == "cuda"
            stream = None
            if cuda:
                # after everything already queued on the device (the
                # policy's weights), without a host wait
                stream = torch.cuda.Stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream) if cuda \
                    else contextlib.nullcontext():
                scratch = create_multi_state(cfg2, self.n_spaces,
                                             device=self.device)
                inputs = _lanes_of(TickInputs.empty(cfg2, self.device),
                                   lambda t: t.unsqueeze(0))
                _, outs = step(scratch, inputs, self.policy)
                if self.telemetry:
                    skin_on = (cfg2.grid.skin > 0 and cfg2.capacity
                               < (1 << consts.AOI_ID_BITS))
                    entry.skin_on = skin_on
                    entry.half_skin = cfg2.grid.skin / 2.0 if skin_on \
                        else 0.0
                    entry.fold = telem.make_fold(half_skin=entry.half_skin)
                    acc = telem.telemetry_init(
                        skin_on, occupancy=True, n_tiles=self.n_spaces,
                        device=self.device)
                    entry.acc0 = telem.telemetry_clone(acc)
                    entry.fold(acc, outs)
            if cuda:
                stream.synchronize()
            entry.step = step
            entry.warm_s = time.perf_counter() - t0
            with self._lock:
                self._entries[label] = entry
                self.warm_count += 1
            logger.info("warmset: %s warm in %.2fs", label, entry.warm_s)
        except Exception as exc:
            logger.exception("warmset: warming %s failed", label)
            with self._lock:
                self._entries[label] = WarmEntry(
                    label=label, cfg=self.base_cfg,
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                    warm_s=time.perf_counter() - t0)

