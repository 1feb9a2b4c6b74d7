"""In-process chaos soaks of the hot-standby and rebalance planes, the
port's copy of the ``failover`` and ``rebalance`` scenarios of the JAX
package's ``tools/chaos_soak.py`` (its cluster scenarios — kill,
overload — and the in-process governor and audit soaks are not ported
yet; ROADMAP.md Queue A item 8).

``failover``: a primary World under churn and a migration storm streams
SnapshotChain frames through the real :class:`ReplicationWorker` into a
live standby World; the primary dies at a deterministic tick, the
standby promotes through the kvreg-arbitrated claim (both stale-claim
race orders replayed and refused, the decision log byte-replayable),
and the promoted census must equal the primary's at the last applied
frame, with the standby's conservation verdict green. The same crash
recovered cold (a fresh World restored from the worker's disk chain)
is timed against the warm promotion.

``rebalance``: a donor World under a sustained-DEGRADED occupancy proxy
and an underloaded receiver, watched by the real
:class:`RebalancePolicy` + :class:`HandoffExecutor` stack: the clean
handoff and the target-kill abort (every unacked entity restored live
on the source), the deployment conservation verdict green every window.

Both scenarios put their Worlds on ``device`` (the card unless the
caller asks for the CPU, as the tests do), and a report is the JAX
soak's for the same seed: the same keys, censuses, decision logs and
verdicts. ``run_failover`` also reports the per-frame apply times and
the frame kinds, and hands its Worlds to a caller's ``keep`` dict.

Usage::

    python -m goworld_tpu_torch.tools.chaos_soak --scenario failover \
        --seed 77 --out failover_report.json
    python -m goworld_tpu_torch.tools.chaos_soak --scenario rebalance \
        --seed 77 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

FAILOVER_SOAK_N = 96
FAILOVER_SOAK_TICKS = 40
FAILOVER_KEYFRAME_EVERY = 8


def _mirror_world(spec, cfg, game_id: int, seed: int, device="cuda"):
    """A bare world sharing the primary's type registry (the shape a
    standby process boots with: classes registered, no population)."""
    from goworld_tpu_torch.entity.entity import Entity
    from goworld_tpu_torch.entity.manager import World
    from goworld_tpu_torch.entity.space import Space

    _INF = float("inf")
    w = World(cfg, n_spaces=1, seed=seed, game_id=game_id,
              device=device)
    w.register_space("ScnSpace", type("ScnSpace", (Space,), {}))
    for i, (r, _f) in enumerate(spec.radius_mix):
        tname = f"Scn{i}"
        w.register_entity(
            tname, type(tname, (Entity,), {}),
            aoi_distance=0.0 if r == _INF else float(r))
    return w


def _census(w) -> set:
    """Live EntityIDs minus the world's OWN nil space (each game's nil
    space id is deterministic from ITS game_id and never replicated)."""
    out = {e.id for e in w.entities.values() if not e.destroyed}
    if w.nil_space is not None:
        out.discard(w.nil_space.id)
    return out


def run_failover(seed: int, n: int = FAILOVER_SOAK_N,
                 ticks: int = FAILOVER_SOAK_TICKS,
                 keyframe_every: int = FAILOVER_KEYFRAME_EVERY, *,
                 device="cuda", build_kw: dict | None = None,
                 capture_guard=None, on_build=None,
                 keep: dict | None = None) -> dict:
    """The failover scenario, in-process like the JAX package's audit soak
    (the conservation assertions need direct World + ledger access on
    BOTH sides). One run proves the whole hot-standby story:

    1. STREAM: a primary world under churn + a migration storm
       replicates through the real path — ``SnapshotChain.capture`` on
       the tick thread, the bounded :class:`ReplicationWorker` building
       key/delta records off-thread (disk chain riding the same jobs),
       ``StreamEncoder`` framing, ``StandbyApplier`` reconciling every
       frame into a live standby world with per-frame ledger resync.
    2. KILL: the primary dies at a deterministic tick (mid-churn,
       mid-migration — the worst case).
    3. PROMOTE: the standby claims through the kvreg-arbitrated
       protocol (first-writer-wins + epoch guard, emulated with the
       dispatcher's exact register semantics), wins, resumes ticking
       from its last applied frame. Both stale-claim race orders are
       replayed against the arbitration and must be refused, and the
       decision log must replay byte-for-byte
       (:func:`goworld_tpu_torch.replication.promote.replay_decisions`).
    4. VERDICT: the promoted census must equal the primary's census at
       the last applied frame — zero lost, zero duplicated EntityIDs —
       and the standby's own conservation verdict must pass.
    5. A/B: the same crash recovered COLD (fresh World + chain restore
       from the disk records the worker wrote) is timed against the
       warm promotion; the paper's claim is >= 10x. The cold time is a
       LOWER bound (a real cold restore also pays process boot).

    Same-seed reruns replay the same world evolution and the same
    decision log (the seeded-replay guarantee).

    ``build_kw`` goes to :func:`build_world` (extent, radius, grid and
    config overrides: the smoke sizes the grid for the card's kernels);
    ``capture_guard`` wraps each tick-thread capture and submit (a
    context-manager factory: the smoke passes the card's sync guard);
    ``on_build(primary, standby)`` runs once both Worlds exist; ``keep``
    receives the Worlds, the tracker and the worker's stats."""
    from goworld_tpu_torch import freeze as freeze_mod
    from goworld_tpu_torch.replication.promote import (
        DecisionLog, adjudicate, claim_key, claim_value,
        replay_decisions)
    from goworld_tpu_torch.replication.standby import (
        StandbyApplier, StandbyTracker)
    from goworld_tpu_torch.replication.worker import ReplicationWorker
    from goworld_tpu_torch.scenarios.runner import build_world
    from goworld_tpu_torch.scenarios.spec import get_scenario
    from goworld_tpu_torch.utils import audit as audit_mod

    import tempfile

    report: dict = {"scenario": "failover", "seed": seed, "n": n,
                    "ticks": ticks, "keyframe_every": keyframe_every,
                    "converged": False}
    spec = get_scenario("mixed")
    kill_tick = ticks  # deterministic: the last streamed tick
    tmpdir = tempfile.mkdtemp(prefix="failover_soak_")
    primary, ents, _clients = build_world(
        spec, n=n, skin=4.0, client_frac=0.15, seed=seed, device=device,
        **(build_kw or {}))
    standby = _mirror_world(spec, primary.cfg, game_id=2, seed=seed,
                            device=device)
    # the standby's attach-time warmup (net/game.py _standby_tick): the
    # still-empty world's first tick builds and loads the kernels and
    # warms the allocator — shapes are capacity-static, so this is the
    # same step the promoted tick runs; without it the "warm" promotion
    # would pay that cost, the exact cost hot standby exists to avoid
    standby.tick()
    standby.tick_count = 0
    if on_build is not None:
        on_build(primary, standby)
    guard = capture_guard or contextlib.nullcontext
    tracker = StandbyTracker(2, primary.game_id, tick_hz=60.0)
    applier = StandbyApplier(standby, primary.game_id,
                             tracker=tracker)
    frames: list = []
    lock = threading.Lock()

    def send_fn(blob: bytes, kind: str, tick: int) -> None:
        with lock:
            frames.append((blob, kind, tick))

    chain = freeze_mod.SnapshotChain(primary, tmpdir,
                                     keyframe_every=keyframe_every)
    worker = ReplicationWorker(chain, game_id=primary.game_id,
                               queue_max=4, send_fn=send_fn)
    census_by_tick: dict[int, set] = {}
    try:
        # ---- phase 1: stream under churn + migration storm -----------
        alive = [e for e in ents if not e.destroyed]
        storm = 0
        applied = rejected = 0
        bytes_stream = 0
        apply_ms = 0.0
        frame_ms: list = []
        lag_ms: list = []
        kinds = {"key": 0, "delta": 0}
        for t in range(ticks):
            if t % 4 == 2 and alive:
                e = alive[t % len(alive)]
                if not e.destroyed and e._migrating is None:
                    data = primary.get_migrate_data(e)
                    primary.remove_for_migration(e)
                    moved = primary.restore_from_migration(data)
                    alive[t % len(alive)] = moved
                    storm += 1
            primary.tick()
            census_by_tick[primary.tick_count] = _census(primary)
            t_cap = time.perf_counter()
            with guard():
                worker.submit(chain.capture(), to_disk=True,
                              to_stream=True)
            worker.drain()  # deterministic soak: no backlog drops
            with lock:
                batch, frames[:] = frames[:], []
            for blob, kind, _tick in batch:
                t0 = time.perf_counter()
                out = applier.apply(blob)
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                lag_ms.append((time.perf_counter() - t_cap) * 1e3)
                apply_ms += frame_ms[-1]
                kinds[kind] += 1
                bytes_stream += len(blob)
                if out["ok"]:
                    applied += 1
                else:
                    rejected += 1
        report["migration_round_trips"] = storm
        report["frames_applied"] = applied
        report["frames_rejected"] = rejected
        report["replication_bytes_per_tick"] = round(
            bytes_stream / max(1, ticks), 1)
        report["standby_apply_ms_per_tick"] = round(
            apply_ms / max(1, ticks), 3)
        report["worker"] = worker.stats()
        report["frame_kinds"] = kinds
        report["apply_ms_frames"] = [round(v, 4) for v in frame_ms]
        # capture on the tick thread to applied on the standby, a frame
        report["frame_lag_ms"] = [round(v, 4) for v in lag_ms]
        stream_ok = applied > 0 and rejected == 0
        report["stream_ok"] = stream_ok

        # ---- phase 2: deterministic kill + arbitrated promotion ------
        # the primary is dead from here on: nothing submits, nothing
        # streams. The standby promotes from its last APPLIED frame.
        applied_tick = applier.decoder.applied_tick
        applied_seq = applier.decoder.applied_seq
        report["kill_tick"] = kill_tick
        report["applied_tick_at_kill"] = applied_tick

        kvreg: dict[str, str] = {}

        def kv_register(key: str, val: str, force: bool = False) -> str:
            # the dispatcher's exact first-writer-wins semantics
            # (net/dispatcher.py _h_kvreg): a later non-force register
            # gets the existing value broadcast back
            if key not in kvreg or force:
                kvreg[key] = val
            return kvreg[key]

        key = claim_key(primary.game_id)
        epoch = 1
        mine = claim_value(2, epoch, applied_seq)
        log = DecisionLog()
        log.note("claim", key=key, value=mine, epoch=epoch,
                 applied_seq=applied_seq, applied_tick=applied_tick)
        t_warm0 = time.perf_counter()
        winner = kv_register(key, mine)
        verdict = adjudicate(winner, mine)
        log.note("adjudicate", winner=winner, mine=mine,
                 verdict=verdict)
        promote_ok = verdict == "won"
        standby.tick_count = max(standby.tick_count, applied_tick)
        log.note("promoted", epoch=epoch, tick=standby.tick_count,
                 seq=applied_seq, entities=len(_census(standby)))
        standby.tick()  # first served tick: staged mirror state
        warm_secs = time.perf_counter() - t_warm0  # flushes to device
        # promotion latency in TICKS: staleness at the kill (frames
        # behind the dead primary) + the one resume tick
        promotion_latency_ticks = (kill_tick - max(0, applied_tick)) + 1
        tracker.note_promoted(epoch, applied_tick)
        report["promotion_latency_ticks"] = promotion_latency_ticks
        report["promotion_secs"] = round(warm_secs, 4)
        report["promote_ok"] = promote_ok

        # both stale-claim race orders must be refused:
        # (a) stale-second — a zombie replays an OLD claim after the
        #     live winner registered: first-writer-wins broadcasts the
        #     live winner; the zombie adjudicates "lost"
        stale = claim_value(7, 0, 3)
        zl = DecisionLog()
        zl.note("claim", key=key, value=stale, epoch=0, applied_seq=3,
                applied_tick=-1)
        zw = kv_register(key, stale)
        zv = adjudicate(zw, stale)
        zl.note("adjudicate", winner=zw, mine=stale, verdict=zv)
        stale_second_refused = zv == "lost" and kvreg[key] == mine
        # (b) stale-first — the replay lands BEFORE the live claim on a
        #     fresh key: the live claimant sees a lower-epoch winner
        #     ("stale_winner"), force-re-registers (legitimate exactly
        #     then), and wins the next broadcast
        key2 = claim_key(99)
        kv_register(key2, claim_value(7, 0, 3))  # zombie lands first
        mine2 = claim_value(2, 1, applied_seq)
        fl = DecisionLog()
        w1 = kv_register(key2, mine2)
        v1 = adjudicate(w1, mine2)
        fl.note("adjudicate", winner=w1, mine=mine2, verdict=v1)
        stale_first_named = v1 == "stale_winner"
        w2 = kv_register(key2, mine2, force=True)
        v2 = adjudicate(w2, mine2)
        fl.note("force_reregister", winner=w2, mine=mine2, verdict=v2)
        stale_first_recovered = v2 == "won"
        arbitration_ok = bool(stale_second_refused and stale_first_named
                              and stale_first_recovered)
        report["arbitration"] = {
            "stale_second_refused": stale_second_refused,
            "stale_first_named": stale_first_named,
            "stale_first_recovered": stale_first_recovered,
        }
        report["arbitration_ok"] = arbitration_ok
        # the decision logs must replay byte-for-byte from their inputs
        replay_ok = all(
            replay_decisions(d.inputs) == d.dump()
            for d in (log, zl, fl))
        report["decision_log_replay_ok"] = replay_ok
        report["decision_log"] = log.lines

        # ---- phase 3: conservation verdict ---------------------------
        want = census_by_tick.get(applied_tick, set())
        got = _census(standby)
        lost = sorted(want - got)
        extra = sorted(got - want)
        report["entities_expected"] = len(want)
        report["entities_promoted"] = len(got)
        report["entities_lost"] = len(lost)
        report["entities_duplicated"] = len(extra)
        report["lost_eids"] = lost[:8]
        report["duplicated_eids"] = extra[:8]
        ap2 = standby.audit
        conservation_ok = False
        if ap2 is not None:
            ap2.drain()
            v = audit_mod.conservation_verdict(
                [ap2.snapshot(tick=standby.tick_count)])
            report["conservation_verdict"] = {
                k: v.get(k) for k in ("ok", "live", "in_flight",
                                      "created", "destroyed",
                                      "problems")}
            conservation_ok = v.get("ok") is True
        census_ok = not lost and not extra
        report["census_ok"] = census_ok
        report["conservation_ok"] = conservation_ok

        # ---- phase 4: cold-restore A/B -------------------------------
        # the SAME crash recovered the pre-standby way: fresh World,
        # chain records resolved from disk (the worker wrote them),
        # restore_world, first tick. A real cold restore ALSO pays
        # process boot + kernel build, so this is a conservative floor.
        t_cold0 = time.perf_counter()
        snap_path = freeze_mod.latest_snapshot_path(
            primary.game_id, tmpdir)
        cold_ok = False
        if snap_path is not None:
            data = freeze_mod.read_freeze_file(snap_path)
            cold = _mirror_world(spec, primary.cfg, game_id=3,
                                 seed=seed, device=device)
            try:
                freeze_mod.restore_world(cold, data)
                cold.tick()
                cold_ok = True
            finally:
                audit_mod.unregister("game3")
        cold_secs = time.perf_counter() - t_cold0
        report["cold_restore_secs"] = round(cold_secs, 4)
        report["cold_restore_ok"] = cold_ok
        speedup = cold_secs / max(warm_secs, 1e-9)
        report["warm_vs_cold_speedup"] = round(speedup, 1)
        ab_ok = cold_ok and speedup >= 10.0
        report["ab_ok"] = ab_ok

        report["standby"] = tracker.snapshot()
        if keep is not None:
            keep.update(primary=primary, standby=standby,
                        tracker=tracker, applier=applier,
                        census_by_tick=census_by_tick)
        # the JAX soak's verdict, the A/B included. On the port the
        # ratio reads 1.3-8.3x (ROADMAP.md Queue C15): the JAX soak's
        # cold World pays its tick's jit compile, and a cold World
        # here pays no kernel build (the process already loaded them)
        report["converged"] = bool(
            stream_ok and promote_ok and arbitration_ok and replay_ok
            and census_ok and conservation_ok and ab_ok)
        return report
    except Exception as exc:
        report["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
        return report
    finally:
        worker.close()
        audit_mod.unregister(f"game{primary.game_id}")
        audit_mod.unregister("game2")
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)


REBALANCE_SOAK_N = 96
REBALANCE_SOAK_BATCH = 24
REBALANCE_SOAK_WINDOWS = 20
REBALANCE_HOLD_WINDOWS = 3
REBALANCE_COOLDOWN_WINDOWS = 12
REBALANCE_TIMEOUT_WINDOWS = 4
# windows from the commit to the donor OBSERVING NORMAL again — the
# report's recovery budget (clean variant)
REBALANCE_RECOVERY_BUDGET = 6


def _run_rebalance_variant(seed: int, kill_target: bool,
                           n: int = REBALANCE_SOAK_N,
                           batch: int = REBALANCE_SOAK_BATCH,
                           windows: int = REBALANCE_SOAK_WINDOWS, *,
                           device="cuda") -> dict:
    """One donor/receiver pair driven through the REAL rebalance stack
    (:class:`RebalancePolicy` + :class:`HandoffExecutor` +
    :class:`RebalanceController`): the donor world holds a
    sustained-DEGRADED occupancy proxy, the receiver is an underloaded
    mirror world, and the transport delivers each pump window's sends
    one window later (a one-window wire). ``kill_target=False`` proves
    the clean handoff; ``kill_target=True`` kills the receiver after
    the first delivered sub-batch — the remaining sends vanish into
    the dead target, the executor's idle-window timeout must abort,
    and every unacked entity must come back LIVE on the source with
    the deployment conservation verdict green the whole way."""
    from goworld_tpu_torch.rebalance.controller import RebalanceController
    from goworld_tpu_torch.rebalance.executor import HandoffExecutor
    from goworld_tpu_torch.rebalance.policy import RebalancePolicy
    from goworld_tpu_torch.scenarios.runner import build_world
    from goworld_tpu_torch.scenarios.spec import get_scenario
    from goworld_tpu_torch.utils import audit as audit_mod
    from goworld_tpu_torch.utils import flightrec

    variant = "target_kill" if kill_target else "clean"
    rep: dict = {"variant": variant, "seed": seed, "n": n,
                 "batch": batch, "windows": windows,
                 "converged": False}
    spec = get_scenario("mixed")
    donor, _ents, _clients = build_world(
        spec, n=n, skin=4.0, client_frac=0.15, seed=seed, device=device)
    recv = _mirror_world(spec, donor.cfg, game_id=2, seed=seed,
                         device=device)
    recv.create_nil_space()
    recv_space = recv.create_space("ScnSpace")
    recv.tick()  # kernel build and allocator warmup off the measured path
    recv.tick_count = 0
    try:
        dap, rap = donor.audit, recv.audit
        if dap is None or rap is None:
            rep["error"] = "world built without an audit plane"
            return rep
        original = _census(donor)
        recv_base = _census(recv)  # the receiver's own space entities
        c0 = len(original)
        # occupancy-proxy overload stage: DEGRADED while the census
        # holds at least (c0 - batch/2) entities, so a COMPLETED
        # handoff of `batch` flips the donor NORMAL and an aborted one
        # (half the cohort restored) does not — the stage is a pure
        # deterministic function of world state, seeded-replay safe
        hot_threshold = c0 - batch // 2
        rep["hot_threshold"] = hot_threshold

        def stage_of(w) -> str:
            return ("DEGRADED" if len(_census(w)) >= hot_threshold
                    else "NORMAL")

        policy = RebalancePolicy(
            hold_windows=REBALANCE_HOLD_WINDOWS, batch=batch,
            cooldown_windows=REBALANCE_COOLDOWN_WINDOWS)
        agent = HandoffExecutor(donor, game_id=donor.game_id,
                                batch=batch)
        donor_name = f"game{donor.game_id}"
        mailbox: list = []
        receiver_alive = True
        recv_dead_snap: dict | None = None
        dropped = delivered = 0

        def transport(action):
            # the committed action's send callable: one-window wire
            return lambda eid, data: mailbox.append((eid, data))

        ctl = RebalanceController(
            policy, agents={donor_name: agent}, transport=transport,
            rate=max(1, batch // 2),
            timeout_windows=REBALANCE_TIMEOUT_WINDOWS)

        def deliver() -> None:
            nonlocal dropped, delivered
            arriving, mailbox[:] = mailbox[:], []
            for eid, data in arriving:
                if not receiver_alive:
                    dropped += 1  # the dead target never acks
                    continue
                recv.restore_from_migration(data, space=recv_space)
                agent.ack(eid)
                delivered += 1

        def recv_snapshot() -> dict:
            # a dead game's planes stop answering; the aggregator (and
            # this verdict) judges from its LAST scrape
            if recv_dead_snap is not None:
                return recv_dead_snap
            rap.drain()
            return rap.snapshot(tick=recv.tick_count)

        def verdict() -> dict:
            dap.drain()
            return audit_mod.conservation_verdict(
                [dap.snapshot(tick=donor.tick_count), recv_snapshot()])

        rec = flightrec.FlightRecorder(
            ring=64, context_fn=dap.incident_context)
        incidents: list = []
        verdict_ok_all = True
        max_in_flight = 0
        commit_window = recovered_window = None
        for w_i in range(1, windows + 1):
            deliver()  # last window's sends arrive on the wire
            if kill_target and receiver_alive and delivered > 0:
                # the receiver dies with a sub-batch still queued on
                # the donor: the worst case — mid-handoff, after acks
                recv_dead_snap = rap.snapshot(tick=recv.tick_count)
                receiver_alive = False
                rep["killed_at_window"] = w_i
                rep["acked_before_kill"] = delivered
            donor.tick()
            if receiver_alive:
                recv.tick()
            obs = {
                donor_name: {"stage": stage_of(donor),
                             "entities": len(_census(donor)),
                             "present": True},
                "game2": {"stage": stage_of(recv),
                          "entities":
                              len(_census(recv) - recv_base),
                          "present": receiver_alive},
            }
            if (commit_window is not None and recovered_window is None
                    and obs[donor_name]["stage"] == "NORMAL"):
                recovered_window = w_i  # donor OBSERVED healthy again
            action = ctl.step(obs)
            if action is not None and commit_window is None:
                commit_window = w_i
            v = verdict()
            max_in_flight = max(max_in_flight, int(v["in_flight"]))
            if not v["ok"]:
                verdict_ok_all = False
                rep.setdefault("verdict_problems", v["problems"])
            frame = {"tick": donor.tick_count}
            note = agent.take_action_note()
            if note is not None:
                frame["rebalance"] = note
            incidents.extend(rec.record(frame))

        # ---- the verdicts --------------------------------------------
        results = [dict(f) for ev, f in policy.log.inputs
                   if ev == "result"]
        aborts = [r for r in results if r.get("kind") == "abort"]
        dones = [r for r in results if r.get("kind") == "done"]
        donor_final = _census(donor)
        moved_final = _census(recv) - recv_base
        lost = sorted(original - (donor_final | moved_final))
        dup = sorted(donor_final & moved_final)
        ghosts = sorted((donor_final | moved_final) - original)
        replay_ok = RebalancePolicy.replay(
            policy.log.inputs,
            hold_windows=REBALANCE_HOLD_WINDOWS, batch=batch,
            cooldown_windows=REBALANCE_COOLDOWN_WINDOWS,
        ) == policy.log.dump()
        trigger_fired = sum(
            1 for i in incidents
            if i.get("trigger") == "rebalance_action")
        rep.update({
            "handoff_fired": commit_window is not None,
            "commit_window": commit_window,
            "committed": policy.committed,
            "entities_moved": len(moved_final),
            "entities_lost": len(lost),
            "entities_duplicated": len(dup) + len(ghosts),
            "lost_eids": lost[:8],
            "duplicated_eids": (dup + ghosts)[:8],
            "sends_dropped": dropped,
            "conservation_ok_all_windows": verdict_ok_all,
            "max_in_flight_seen": max_in_flight,
            "decision_log_replay_ok": replay_ok,
            "rebalance_action_triggers": trigger_fired,
            "moves_total": agent.snapshot()["moves_total"],
            "aborts_total": dict(agent.aborts_total),
            "decision_log": list(policy.log.lines),
        })
        zero_loss = not lost and not dup and not ghosts
        if kill_target:
            abort = aborts[0] if aborts else {}
            rep["abort_cause"] = abort.get("cause")
            rep["entities_restored"] = int(abort.get("restored", 0))
            rep["converged"] = bool(
                commit_window is not None
                and agent.aborted == 1 and not dones
                and abort.get("cause") == "timeout"
                # mid-batch: some of the cohort was acked before the
                # kill, the rest must be restored live on the source
                and 0 < len(moved_final) < batch
                and rep["entities_restored"] == batch
                - len(moved_final)
                and zero_loss and verdict_ok_all and replay_ok
                and trigger_fired > 0)
        else:
            rep["donor_recovery_windows"] = (
                None if recovered_window is None or commit_window
                is None else recovered_window - commit_window)
            rep["converged"] = bool(
                commit_window is not None
                and policy.committed == 1 and agent.completed == 1
                and not aborts
                and len(moved_final) == batch
                and rep["donor_recovery_windows"] is not None
                and rep["donor_recovery_windows"]
                <= REBALANCE_RECOVERY_BUDGET
                and zero_loss and verdict_ok_all
                # the verdict judged a window with a batch in flight
                and max_in_flight > 0
                and replay_ok and trigger_fired > 0)
        return rep
    except Exception as exc:
        rep["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
        return rep
    finally:
        from goworld_tpu_torch.utils import audit as audit_mod

        audit_mod.unregister(f"game{donor.game_id}")
        audit_mod.unregister("game2")


def run_rebalance(seed: int, device="cuda") -> dict:
    """The self-healing rebalance scenario, in-process like
    the audit and failover soaks. ONE run proves BOTH halves of the
    story on the same seed:

    - ``clean``: sustained DEGRADED fires exactly one rate-limited
      cohort handoff through the production migration machinery, the
      donor recovers to NORMAL within the recovery budget, zero
      entities are lost or duplicated, the deployment conservation
      verdict is green EVERY window (including mid-batch, with the
      cohort in flight), and the decision log replays byte-for-byte.
    - ``target_kill``: the receiver dies mid-handoff with a sub-batch
      unacked; the executor's timeout abort must restore every unacked
      entity LIVE on the source (ledger out-record/seq machinery —
      the self-round-trip retires the record), already-acked entities
      stay moved, and the donor + receiver censuses still partition
      the original entity set exactly.

    Same-seed reruns replay the same observation stream and therefore
    the same decision log (the seeded-replay guarantee)."""
    report: dict = {"scenario": "rebalance", "seed": seed,
                    "converged": False}
    report["clean"] = _run_rebalance_variant(seed, kill_target=False,
                                             device=device)
    report["target_kill"] = _run_rebalance_variant(
        seed, kill_target=True, device=device)
    report["converged"] = bool(
        report["clean"].get("converged")
        and report["target_kill"].get("converged"))
    return report




def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=("failover", "rebalance"),
                    default="failover")
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--device", default="cuda",
                    help="where the Worlds live (cuda unless cpu)")
    ap.add_argument("--out", default="chaos_report.json")
    args = ap.parse_args()
    if args.scenario == "failover":
        report = run_failover(args.seed, device=args.device)
        report["workload"] = "failover-churn"
    else:
        report = run_rebalance(args.seed, device=args.device)
        report["workload"] = "rebalance-handoff"
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if report.get("converged") else 1


if __name__ == "__main__":
    sys.exit(main())
