"""KernelGovernor — the online autotuner, the port of
``goworld_tpu/autotune/governor.py``.

One governor serves one live :class:`~goworld_tpu_torch.entity.manager.World`
(the single-shard, non-mesh production shape — the only shape whose
step carries the Verlet-skin runtime branches the candidates toggle).
Per signature window (the World's drained-lane rotation) it:

1. runs the **regret guard** on the most recently committed swap —
   if the measured tick-latency p90 of the post-swap window worsened
   past ``regret_pct`` vs the pre-swap window, it reverts (the old
   step is warm by construction) and PINS the policy for
   ``regret_pin_windows``. Measured truth beats the table;
2. **commits** a previously decided swap iff the target's step is warm
   (:mod:`warmset`) — nothing builds or first-launches on the tick
   thread;
3. feeds the window's workload signature to the **policy**
   (:mod:`policy`), and schedules an off-thread warm for any newly
   decided target.

Every commit/revert increments
``governor_swaps_total{from,to,reason}``, is returned to the caller as
an event dict and lands in the deterministic swap log. The reference's
flight-recorder trigger, its ``/governor`` endpoint, the ``[gameN]``
config and the GameServer's drive come with the serving stack
(ROADMAP.md Queue A item 8).
"""

from __future__ import annotations

import threading
import weakref
from typing import Any

from goworld_tpu_torch.autotune.policy import (
    DEFAULT_CANDIDATES,
    GovernorPolicy,
    seed_table,
)
from goworld_tpu_torch.autotune.warmset import WarmEntry, WarmSet
from goworld_tpu_torch.ops import telemetry as telem
from goworld_tpu_torch.utils import log, metrics

logger = log.get("autotune")

__all__ = ["KernelGovernor", "register", "unregister", "snapshot"]

# swap counters cached per (from, to, reason) — the shed_counter idiom
_swap_counters: dict[tuple, metrics.Counter] = {}


def _swap_counter(frm: str, to: str, reason: str) -> metrics.Counter:
    key = (frm, to, reason)
    c = _swap_counters.get(key)
    if c is None:
        c = _swap_counters[key] = metrics.counter(
            "governor_swaps_total",
            help="kernel-config swaps committed by the autotune "
                 "governor",
            **{"from": frm, "to": to, "reason": reason},
        )
    return c


class KernelGovernor:
    """Online kernel-config governor for one live World."""

    def __init__(
        self,
        world,
        *,
        name: str = "game",
        table: dict[str, str] | None = None,
        candidates=DEFAULT_CANDIDATES,
        up_windows: int = 2,
        down_windows: int = 2,
        cooldown_windows: int = 4,
        regret_pct: float = 0.25,
        regret_pin_windows: int = 8,
    ):
        if world.n_spaces != 1:
            raise ValueError(
                "the kernel governor serves single-shard non-mesh "
                "worlds (the shape whose step carries the skin's "
                "runtime branches)"
            )
        self.name = name
        self._world = weakref.ref(world)
        self.policy = GovernorPolicy(
            table=table if table is not None else seed_table(),
            candidates=candidates,
            up_windows=up_windows,
            down_windows=down_windows,
            cooldown_windows=cooldown_windows,
        )
        self.warmset = WarmSet(
            world.cfg, world.n_spaces, world.policy,
            candidates=candidates,
            telemetry=world.telemetry_live,
            resident=world.resident,
            device=world.device,
        )
        self.regret_pct = float(regret_pct)
        self.regret_pin_windows = int(regret_pin_windows)
        self.current = "default"
        self.pending: str | None = None
        self.windows = 0
        self._last_p90: float | None = None
        # armed after a commit: (previous label, pre-swap p90,
        # windows left to judge)
        self._regret: tuple[str, float | None, int] | None = None
        self._lock = threading.Lock()
        # (window, from, to, reason) — deterministic, mirrors the
        # policy's transition log plus warm-gated commit/revert facts
        self.swaps: list[tuple[int, str, str, str]] = []
        self.last_signature: dict | None = None
        # "default" is the running config: the live step IS the default
        # entry, captured at the first commit
        self._boot_entry = None

    # -- the per-window drive -------------------------------------------
    def on_window(self, sig: dict | None,
                  tick_ms_p90: float | None = None) -> dict | None:
        """Feed one signature window (+ the window's measured tick-ms
        p90). Returns an event dict when a swap/revert COMMITTED this
        window, else None. Must be called from the tick thread (the
        commit mutates the World between ticks)."""
        with self._lock:
            self.windows += 1
            self.last_signature = sig if isinstance(sig, dict) else None
            ev = self._check_regret(tick_ms_p90)
            if ev is None:
                ev = self._maybe_commit(tick_ms_p90)
            if ev is None and isinstance(sig, dict):
                want = self.policy.observe(sig)
                if want is not None:
                    if want == self.current:
                        # the policy walked back to the config still
                        # serving while the previous target warmed:
                        # drop the stale pending, or it would commit
                        # (unwanted) the moment it warms
                        self.pending = None
                    else:
                        self.pending = want
                        self.warmset.ensure(want)
                        # commit in the SAME window when already warm
                        # (a revisited config pays zero decision lag)
                        ev = self._maybe_commit(tick_ms_p90)
            if tick_ms_p90 is not None:
                self._last_p90 = tick_ms_p90
            return ev

    # -- internals (lock held) ------------------------------------------
    def _maybe_commit(self, tick_ms_p90: float | None) -> dict | None:
        label = self.pending
        if label is None:
            return None
        entry = self.warmset.entry(label)
        if entry is not None and entry.error:
            # un-warmable candidate: stop asking for it
            logger.warning("governor %s: candidate %s failed to "
                           "warm (%s); pinning %s", self.name,
                           label, entry.error, self.current)
            self.pending = None
            self.policy.pin(self.current, self.regret_pin_windows,
                            f"warm-failed({label})")
            return None
        if entry is None or not entry.warm:
            return None  # keep serving the current config until warm
        self.pending = None
        return self._commit(label, "policy",
                            pre_p90=self._last_p90
                            if tick_ms_p90 is None else tick_ms_p90)

    def _commit(self, label: str, reason: str,
                pre_p90: float | None) -> dict | None:
        w = self._world()
        if w is None:
            return None
        prev = self.current
        if self._boot_entry is None:
            # capture the boot config as the "default" revert target
            # (its step is the currently-running one — warm by
            # definition). acc0 must be a ZEROED accumulator with the
            # boot lane set — capturing the live cumulative one would
            # re-feed every boot-era sample into the metrics registry
            # when a later swap commits back to "default"
            skin_on = getattr(w, "_telem_skin_on", False)
            acc0 = None
            if w._telem_fn is not None:
                acc0 = telem.telemetry_init(
                    skin_on, occupancy=True, n_tiles=w.n_spaces,
                    device=w.device)
            self._boot_entry = WarmEntry(
                label="default", cfg=w.cfg, step=w._step,
                fold=w._telem_fn, acc0=acc0, skin_on=skin_on,
                half_skin=getattr(w, "_telem_half_skin", 0.0),
            )
            with self.warmset._lock:
                self.warmset._entries.setdefault("default",
                                                 self._boot_entry)
        entry = self.warmset.entry(label)
        if entry is None or not entry.warm:
            return None
        w.apply_tick_config(
            entry.cfg, entry.step,
            telem_fold=entry.fold, telem_acc0=entry.acc0,
            telem_skin_on=entry.skin_on,
            telem_half_skin=entry.half_skin,
        )
        self.current = label
        self.swaps.append((self.windows, prev, label, reason))
        _swap_counter(prev, label, reason).inc()
        self._regret = (prev, pre_p90, 2) if reason != "regret" \
            else None
        ev = {
            "window": self.windows,
            "from": prev,
            "to": label,
            "reason": reason,
            "tick": getattr(w, "tick_count", None),
        }
        logger.info("governor %s: swapped %s -> %s (%s) at tick %s",
                    self.name, prev, label, reason, ev["tick"])
        return ev

    def _check_regret(self, tick_ms_p90: float | None) -> dict | None:
        if self._regret is None:
            return None
        prev, pre_p90, left = self._regret
        if pre_p90 is None or pre_p90 <= 0:
            # no pre-swap baseline was ever measured: the guard cannot
            # judge — disarm instead of staying armed (and displayed)
            # forever
            self._regret = None
            return None
        if tick_ms_p90 is None or tick_ms_p90 != tick_ms_p90:  # NaN
            # no measured truth this window; wait, but boundedly — an
            # unmeasurable post-swap period must not pin the guard
            left -= 1
            self._regret = None if left <= 0 else (prev, pre_p90, left)
            return None
        if tick_ms_p90 > (1.0 + self.regret_pct) * pre_p90:
            bad = self.current
            self._regret = None
            self.pending = None
            ev = self._commit(prev, "regret", pre_p90=None)
            if ev is not None:
                ev["regret"] = {
                    "pre_p90_ms": round(pre_p90, 3),
                    "post_p90_ms": round(tick_ms_p90, 3),
                    "threshold_pct": self.regret_pct,
                }
                self.policy.pin(prev, self.regret_pin_windows,
                                f"regret({bad}: "
                                f"{pre_p90:.3g}->{tick_ms_p90:.3g}ms)")
            return ev
        left -= 1
        self._regret = None if left <= 0 else (prev, pre_p90, left)
        return None

    # -- observation -----------------------------------------------------
    def log_lines(self) -> list[str]:
        """Deterministic swap log (commit/revert facts — the policy's
        decision log is served alongside in :meth:`snapshot`)."""
        return [f"#{w} {frm}->{to} {reason}"
                for w, frm, to, reason in self.swaps]

    def snapshot(self) -> dict:
        with self._lock:
            reg = None
            if self._regret is not None:
                prev, pre, left = self._regret
                reg = {"revert_to": prev, "pre_p90_ms": pre,
                       "windows_left": left}
            return {
                "current": self.current,
                "pending": self.pending,
                "windows": self.windows,
                "swaps": self.log_lines(),
                "policy": self.policy.snapshot(),
                "warmset": self.warmset.snapshot(),
                "regret_guard": reg,
                "regret_pct": self.regret_pct,
                "signature": self.last_signature,
            }


# =======================================================================
# process-local registry
# =======================================================================
_reg_lock = threading.Lock()
_governors: dict[str, Any] = {}  # name -> weakref.ref(KernelGovernor)


def register(name: str, gov: KernelGovernor) -> KernelGovernor:
    """Latest-wins registration (the devprof provider convention);
    weakref-backed so the registry never pins a discarded server's
    World."""
    with _reg_lock:
        _governors[name] = weakref.ref(gov)
    return gov


def unregister(name: str) -> None:
    with _reg_lock:
        _governors.pop(name, None)


def snapshot() -> dict:
    """The ``/governor`` payload: every live governor's snapshot, or
    an honest absence."""
    with _reg_lock:
        refs = list(_governors.items())
    out: dict = {}
    for name, ref in refs:
        gov = ref()
        if gov is None:
            continue
        try:
            out[name] = gov.snapshot()
        except Exception as exc:  # an endpoint must never 500
            out[name] = {"error": str(exc)[:200]}
    if not out:
        return {"error": "no kernel governor in this process "
                         "([gameN] governor = true enables it)"}
    return out


def reset() -> None:
    """Drop registry state (tests)."""
    with _reg_lock:
        _governors.clear()
