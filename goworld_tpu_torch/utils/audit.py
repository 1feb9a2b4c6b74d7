"""Correctness audit plane, the port's copy of ``goworld_tpu/utils/audit.py``
(host only): who owns every entity, and is every interest set exact —
continuously, while serving.

* :class:`EntityLedger` — an INDEPENDENT per-game census: every
  create/destroy/migrate hook of the World feeds a second bookkeeping
  of ``eid -> type`` (deliberately not the ``World.entities`` dict it
  audits), monotone created/destroyed/migrated counters, a per-entity
  ownership sequence stamped into the migrate data on send and
  validated on restore, and bounded rings of in-flight migrate-out/in
  records. The census digest (count + CRC-chained fold over sorted
  EntityIDs per type) proves conservation without shipping eid lists.
* :func:`conservation_verdict` — the deployment equation: the sum of
  per-game censuses plus the in-flight migration window must equal
  created - destroyed exactly; an out-record unmatched for more than
  ``grace_ticks`` names the lost EntityID.
* :class:`AuditPlane` — the per-world runtime: every
  ``audit_sample_every`` ticks a cohort (<= ``audit_cohort`` entities)
  has its interest set recomputed by a brute-force oracle against the
  positions that rode the tick's existing fetch (no added device sync);
  the math runs on a background worker thread, never the tick. The same
  cohort gets its slot mirrors, client binding columns and
  ``interested_by`` reverse edges spot-checked.

Violations feed ``audit_violations_total{kind}`` and the ledger's
violation ring. Honesty rules: a tick whose sweep ran degraded
(overflow gauges nonzero) or whose sample could not be judged is
recorded as SKIPPED with its reason, never silently passed; the plane
itself must never take serving down — worker failures are logged and
the job dropped. The snapshot scrub CRC-walks the SnapshotChain files
(:mod:`goworld_tpu_torch.freeze`).
"""

from __future__ import annotations

import os
import queue
import threading
import zlib
from collections import OrderedDict, deque
from typing import Any, Callable

from goworld_tpu_torch.utils import log, metrics

logger = log.get("audit")

__all__ = [
    "EntityLedger", "AuditPlane", "CensusProbe", "GRACE_TICKS",
    "crc_fold", "cohort_oracle", "quantize_host",
    "conservation_verdict", "register", "unregister", "get",
    "snapshot_all", "reset",
]

# in-flight grace: a migrate-out unmatched by any migrate-in for more
# than this many source ticks is a LOST entity (the migration protocol
# completes in 2-3 dispatcher round trips — well under one tick of
# slack each — so 8 ticks at 60 Hz is ~130 ms of wire budget)
GRACE_TICKS = 8

# bounded state (the ledger must stay O(1) per hook at 1M entities):
# in-flight rings, violation ring, event-tail ring
OUT_RING = 512
IN_RING = 512
VIOLATION_RING = 64
TAIL_RING = 256
# ?eids=1 ships the sorted eid list only under this count — beyond it
# an honest {"truncated": n} is served instead (a 1M-entity JSON list
# is a DoS, not a diff aid)
EIDS_CAP = 20_000


def crc_fold(eids) -> int:
    """CRC-chained fold over EntityIDs in sorted order — the census
    digest. Chaining (each id's crc32 seeded by the running value)
    makes the digest order-sensitive, and sorting first makes it
    canonical: two processes agree iff their eid SETS agree."""
    crc = 0
    for eid in sorted(eids):
        crc = zlib.crc32(eid.encode("ascii", "replace"), crc)
    return crc & 0xFFFFFFFF


class EntityLedger:
    """Independent entity-ownership bookkeeping for one game.

    All mutation hooks are O(1) dict/deque work and run on the logic
    thread; ``snapshot()`` (http thread) takes the same lock, so the
    scrape cost (sorted-census fold, O(n log n)) is paid by the
    scraper, never the tick."""

    def __init__(self, name: str, grace_ticks: int = GRACE_TICKS):
        self.name = name
        self.grace_ticks = int(grace_ticks)
        self._lock = threading.Lock()
        self._eids: dict[str, str] = {}        # eid -> type name
        self._own_seq: dict[str, int] = {}     # eid -> ownership seq
        self.created = 0
        self.destroyed = 0
        self.migrated_out = 0
        self.migrated_in = 0
        # in-flight rings: (eid, seq) -> {target, tick}; matching a
        # migrate-in against them is the aggregator's job — a SOURCE
        # game can never see the restore on the target, so it must not
        # judge its own out-records (that verdict lives in
        # conservation_verdict)
        self._out: "OrderedDict[tuple[str, int], dict]" = OrderedDict()
        self._in: deque = deque(maxlen=IN_RING)
        self.violations: deque = deque(maxlen=VIOLATION_RING)
        self.violations_total: dict[str, int] = {}
        self.tail: deque = deque(maxlen=TAIL_RING)
        self._pending_violation: str | None = None
        self._m_violations: dict[str, Any] = {}

    # -- mutation hooks (logic thread) ---------------------------------
    def on_create(self, eid: str, type_name: str, tick: int) -> None:
        with self._lock:
            if eid in self._eids:
                self._violate(
                    "duplicate_create",
                    f"create of live EntityID {eid} "
                    f"(type {type_name}, tick {tick})", tick)
                return
            self._eids[eid] = type_name
            self._own_seq.setdefault(eid, 1)
            self.created += 1
            self.tail.append((tick, "create", eid, type_name))

    def on_destroy(self, eid: str, tick: int) -> None:
        with self._lock:
            if self._eids.pop(eid, None) is None:
                self._violate(
                    "destroy_unknown",
                    f"destroy of unknown EntityID {eid} (tick {tick})",
                    tick)
                return
            self._own_seq.pop(eid, None)
            self.destroyed += 1
            self.tail.append((tick, "destroy", eid, ""))

    def next_seq(self, eid: str) -> int:
        """The ownership seq the NEXT migrate-out of ``eid`` will
        carry — a pure read for ``get_migrate_data`` (which builds the
        payload before ``remove_for_migration`` commits the ledger
        move; the two agree because both run back-to-back on the
        logic thread)."""
        with self._lock:
            return self._own_seq.get(eid, 0) + 1

    def stamp_migrate_out(self, eid: str, tick: int,
                          target: int = 0) -> int:
        """Remove ``eid`` from the census, bump its ownership sequence
        and return it — the caller stamps the returned seq into the
        migrate data so the restoring game can reject stale or
        re-delivered ghosts. The last-seen seq is kept even after the
        entity leaves: it is the only defense against a re-delivered
        ghost of an entity this game once owned."""
        with self._lock:
            seq = self._own_seq.get(eid, 0) + 1
            if self._eids.pop(eid, None) is None:
                self._violate(
                    "migrate_out_unknown",
                    f"migrate-out of unknown EntityID {eid} "
                    f"(tick {tick})", tick)
            self._own_seq[eid] = seq
            self.migrated_out += 1
            while len(self._out) >= OUT_RING:
                self._out.popitem(last=False)
            self._out[(eid, seq)] = {"target": int(target),
                                     "tick": int(tick)}
            self.tail.append((tick, "migrate_out", eid, f"seq={seq}"))
            return seq

    def on_migrate_in(self, eid: str, type_name: str, seq: int,
                      tick: int) -> None:
        with self._lock:
            seq = int(seq)
            if eid in self._eids:
                self._violate(
                    "duplicate_entity",
                    f"migrate-in of live EntityID {eid} "
                    f"(seq {seq}, tick {tick}) — duplicated owner",
                    tick)
                return
            last = self._own_seq.get(eid, 0)
            # an in-record matching our OWN open out-record is a
            # self-round-trip (single-game worlds, A->B->A through the
            # same ledger), not a ghost: the seq equals the one we just
            # stamped. A RE-delivered ghost arrives after the record
            # below is retired and still fails the stale check.
            own_roundtrip = (eid, seq) in self._out
            if seq and seq <= last and not own_roundtrip:
                self._violate(
                    "stale_migrate",
                    f"migrate-in of EntityID {eid} with stale "
                    f"ownership seq {seq} <= {last} (tick {tick})",
                    tick)
                return
            self._eids[eid] = type_name
            # seq 0 = a peer predating the stamp: accept, re-anchor
            self._own_seq[eid] = seq or (last + 1)
            self.migrated_in += 1
            self._in.append((eid, seq, int(tick)))
            # our own out-record matched locally (self-migration in
            # tests / single-game worlds): retire it
            self._out.pop((eid, seq), None)
            self.tail.append((tick, "migrate_in", eid, f"seq={seq}"))

    def resync(self, live: dict[str, str], tick: int) -> dict:
        """Bulk re-anchor after a snapshot restore or a replicated
        frame apply (freeze.py and replication/standby.py rebuild
        ``world.entities`` directly, bypassing the per-entity hooks).
        ``created`` is re-derived so the local conservation identity
        ``live == created - destroyed - migrated_out + migrated_in``
        holds from the re-anchored census onward. Returns the census
        delta (``{"added": n, "removed": n}``) — the standby tracker
        and promotion decision log stamp it."""
        with self._lock:
            added = sum(1 for eid in live if eid not in self._eids)
            removed = sum(1 for eid in self._eids if eid not in live)
            self._eids = dict(live)
            for eid in live:
                self._own_seq.setdefault(eid, 1)
            self.created = (len(live) + self.destroyed
                            + self.migrated_out - self.migrated_in)
            self.tail.append((tick, "resync", "",
                              f"{len(live)} entities restored"))
            return {"added": added, "removed": removed}

    # -- violations ----------------------------------------------------
    def _violate(self, kind: str, detail: str, tick: int) -> None:
        # lock already held
        self.violations.append({"kind": kind, "detail": detail,
                                "tick": int(tick)})
        self.violations_total[kind] = \
            self.violations_total.get(kind, 0) + 1
        self._pending_violation = f"{kind}: {detail}"
        m = self._m_violations.get(kind)
        if m is None:
            m = self._m_violations[kind] = metrics.counter(
                "audit_violations_total",
                help="correctness audit violations by kind",
                kind=kind, game=self.name)
        m.inc()
        self.tail.append((tick, "VIOLATION", kind, detail))
        logger.error("[%s] audit violation %s: %s", self.name, kind,
                     detail)

    def note_violation(self, kind: str, detail: str, tick: int) -> None:
        """External probes (oracle, mirrors, scrub) record through the
        same ring/counter/trigger path as ledger-internal ones."""
        with self._lock:
            self._violate(kind, detail, tick)

    def take_violation(self) -> str | None:
        """Pop the freshest unconsumed violation note — the per-tick
        flight-recorder frame key (each violation fires the
        ``audit_violation`` trigger at most once)."""
        with self._lock:
            v, self._pending_violation = self._pending_violation, None
            return v

    # -- reading -------------------------------------------------------
    def live_eids(self) -> set[str]:
        with self._lock:
            return set(self._eids)

    def census(self) -> dict[str, dict]:
        """Per-type count + CRC-chained digest over sorted EntityIDs —
        two censuses agree iff the eid sets agree, without shipping a
        single eid."""
        with self._lock:
            by_type: dict[str, list[str]] = {}
            for eid, tname in self._eids.items():
                by_type.setdefault(tname, []).append(eid)
        return {
            tname: {"count": len(eids), "crc": crc_fold(eids)}
            for tname, eids in sorted(by_type.items())
        }

    def snapshot(self, tick: int = 0, eids: bool = False) -> dict:
        census = self.census()  # takes the lock itself
        with self._lock:
            out = {
                "kind": "game",
                "entities": len(self._eids),
                "crc": crc_fold(self._eids),
                "census": census,
                "created": self.created,
                "destroyed": self.destroyed,
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "tick": int(tick),
                "in_flight": [
                    {"eid": eid, "seq": seq, "target": rec["target"],
                     "tick": rec["tick"],
                     "age_ticks": max(0, int(tick) - rec["tick"])}
                    for (eid, seq), rec in self._out.items()
                ],
                "in_records": [
                    {"eid": eid, "seq": seq, "tick": t}
                    for eid, seq, t in self._in
                ],
                "grace_ticks": self.grace_ticks,
                "violations_total": dict(self.violations_total),
                "violations": list(self.violations),
            }
            if eids:
                if len(self._eids) <= EIDS_CAP:
                    out["eids"] = sorted(self._eids)
                else:
                    out["eids"] = {"truncated": len(self._eids)}
            return out

    def incident_context(self) -> dict:
        """The freeze-time payload: ledger event tail + violation ring
        (paid at freeze time only — the flightrec convention)."""
        with self._lock:
            return {
                "entities": len(self._eids),
                "created": self.created,
                "destroyed": self.destroyed,
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "tail": [list(t) for t in self.tail],
                "violations": list(self.violations),
            }


# =======================================================================
# sampled AOI oracle (jax-free numpy; the fetched planes arrive as host
# arrays off the tick's existing fetch-outputs transfer)
# =======================================================================
def quantize_host(pos, step: float, hi: int):
    """Host-side replica of ``ops/aoi.quantize_positions`` for fetched
    f32 planes: snap x/z onto the q16 lattice with the SAME f32
    arithmetic (multiply by a power of two, floor, multiply back — all
    exact), so the oracle judges the identical domain the sweep ran
    on."""
    import numpy as np

    p = np.asarray(pos, np.float32).copy()
    inv = np.float32(1.0 / step)
    st = np.float32(step)
    qx = np.clip(np.floor(p[:, 0] * inv), 0.0, float(hi))
    qz = np.clip(np.floor(p[:, 2] * inv), 0.0, float(hi))
    p[:, 0] = (qx * st).astype(np.float32)
    p[:, 2] = (qz * st).astype(np.float32)
    return p


def cohort_oracle(pos, alive, radius: float, cohort,
                  watch_radius=None) -> dict[int, set[int]]:
    """Brute-force interest rows for the cohort slots only — the
    ``ops/aoi.neighbors_oracle`` semantics (Chebyshev metric,
    per-entity watch radius, radius <= 0 excludes) without paying
    O(n^2) for a <=``audit_cohort`` sample."""
    import numpy as np

    pos = np.asarray(pos)
    alive = np.asarray(alive).astype(bool)
    n = pos.shape[0]
    if watch_radius is None:
        participates = alive
        reach = np.full(n, radius, np.float64)
    else:
        wr = np.asarray(watch_radius, np.float64)
        participates = alive & (wr > 0)
        reach = np.minimum(wr, radius)
    rows: dict[int, set[int]] = {}
    for i in cohort:
        i = int(i)
        if i >= n or not participates[i]:
            rows[i] = set()
            continue
        dx = np.abs(pos[:, 0] - pos[i, 0])
        dz = np.abs(pos[:, 2] - pos[i, 2])
        mask = (np.maximum(dx, dz) <= reach[i]) & participates
        mask[i] = False
        rows[i] = set(np.nonzero(mask)[0].tolist())
    return rows


# =======================================================================
# deployment conservation verdict (shared by every reader of the
# ledgers' snapshots)
# =======================================================================
def conservation_verdict(games: list[dict],
                         dispatcher: dict | None = None,
                         grace_ticks: int = GRACE_TICKS) -> dict:
    """Prove (or refute) deployment-wide entity conservation from
    per-game ledger snapshots:

    ``sum(live) + in_flight == sum(created) - sum(destroyed)``

    where ``in_flight`` is the set of migrate-out records not matched
    by any game's migrate-in record (matched by (EntityID, ownership
    seq)). An unmatched out-record older than ``grace_ticks`` source
    ticks is a LOST entity and names its EntityID; local
    duplicate/stale violations (already named by the ledgers) are
    rolled up. The optional dispatcher census cross-checks the routing
    table's per-game counts against each game's own census."""
    games = [g for g in games if isinstance(g, dict)
             and g.get("kind") == "game"]
    live = sum(int(g.get("entities", 0)) for g in games)
    created = sum(int(g.get("created", 0)) for g in games)
    destroyed = sum(int(g.get("destroyed", 0)) for g in games)
    ins = {(r["eid"], r["seq"])
           for g in games for r in g.get("in_records", [])}
    outstanding = []
    for g in games:
        snap_tick = int(g.get("tick", 0))
        for r in g.get("in_flight", []):
            if (r["eid"], r["seq"]) in ins:
                continue
            # burst-aware grace: age each record from its
            # OWN migrate-out tick against the owning game's snapshot
            # tick — never from a precomputed age a batched scraper
            # may have anchored at the batch head. A rate-limited
            # rebalance of rebalance_batch entities straddling the
            # verdict then judges every record by how long IT has
            # been in flight, not how old the batch is.
            r = dict(r)
            if "tick" in r:
                r["age_ticks"] = max(0, snap_tick - int(r["tick"]))
            else:
                r["age_ticks"] = int(r.get("age_ticks", 0))
            outstanding.append(r)
    lost = [r for r in outstanding
            if int(r["age_ticks"]) > int(grace_ticks)]
    in_flight = len(outstanding)
    violations: dict[str, int] = {}
    for g in games:
        for kind, n in (g.get("violations_total") or {}).items():
            violations[kind] = violations.get(kind, 0) + int(n)
    problems: list[str] = []
    for r in lost:
        problems.append(
            f"lost EntityID {r['eid']} (seq {r['seq']}, migrated out "
            f"at tick {r.get('tick', '?')}, unmatched for "
            f"{r['age_ticks']} ticks)")
    balance = live + in_flight - (created - destroyed)
    if balance != 0:
        problems.append(
            f"conservation broken: live {live} + in-flight "
            f"{in_flight} != created {created} - destroyed "
            f"{destroyed} (off by {balance:+d})")
    for kind, n in sorted(violations.items()):
        if n:
            problems.append(f"{n} {kind} violation(s) recorded")
    out = {
        "games": len(games),
        "live": live,
        "created": created,
        "destroyed": destroyed,
        "in_flight": in_flight,
        "lost": lost,
        "violations_total": violations,
        "problems": problems,
        "ok": not problems,
    }
    if isinstance(dispatcher, dict) \
            and dispatcher.get("kind") == "dispatcher":
        out["dispatcher_entities"] = int(dispatcher.get("entities", 0))
        # the routing table lags by the in-flight window at most; a
        # larger divergence is a finding (named per-game upstream)
        drift = abs(out["dispatcher_entities"] - live)
        if drift > in_flight + len(lost):
            out["ok"] = False
            out["problems"] = problems + [
                f"dispatcher routes {out['dispatcher_entities']} "
                f"entities but games hold {live} "
                f"(in-flight {in_flight})"]
    return out


def first_divergent_eid(a: list[str] | dict | None,
                        b: list[str] | dict | None) -> str | None:
    """Name the first EntityID present in exactly one of two sorted
    eid lists (the ``?eids=1`` diff aid). ``None`` when either side
    was truncated or the sets agree."""
    if not isinstance(a, list) or not isinstance(b, list):
        return None
    diff = sorted(set(a) ^ set(b))
    return diff[0] if diff else None


# =======================================================================
# the per-world runtime: sampling worker, probe stats, scrub
# =======================================================================
class AuditPlane:
    """One world's audit runtime: the ledger plus the off-hot-path
    worker that judges sampled cohorts (AOI oracle + mirror probes)
    and scrubs SnapshotChain files. Submissions never block the tick:
    a full queue drops the sample and counts it
    (``audit_samples_dropped_total``)."""

    def __init__(self, name: str, sample_every: int = 64,
                 cohort: int = 64, grace_ticks: int = GRACE_TICKS):
        # loud validation, the GridSpec convention: a bad knob must
        # fail at construction, only runtime work degrades gracefully
        if sample_every < 1:
            raise ValueError(
                f"audit_sample_every must be >= 1, got {sample_every!r}")
        if cohort < 1:
            raise ValueError(
                f"audit_cohort must be >= 1, got {cohort!r}")
        self.name = name
        self.sample_every = int(sample_every)
        self.cohort = int(cohort)
        self.ledger = EntityLedger(name, grace_ticks=grace_ticks)
        self._lock = threading.Lock()
        self.oracle_stats = {"samples": 0, "entities_checked": 0,
                             "mismatches": 0, "skipped": {},
                             "last_tick": -1}
        self.probe_stats = {"samples": 0, "entities_checked": 0,
                            "mismatches": 0}
        self.scrub_stats = {"walks": 0, "files": 0, "corrupt": 0,
                            "last_error": None}
        self._sample_index = 0
        self._m_dropped = metrics.counter(
            "audit_samples_dropped_total",
            help="audit cohort samples dropped on a busy worker",
            game=name)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(
            target=self._run, name=f"audit-{name}", daemon=True)
        self._thread.start()

    # -- worker --------------------------------------------------------
    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                job()
            except Exception:
                logger.exception(
                    "[%s] audit worker job failed", self.name)
            self._q.task_done()

    def submit(self, job: Callable[[], None]) -> bool:
        try:
            self._q.put_nowait(job)
            return True
        except queue.Full:
            self._m_dropped.inc()
            return False

    def drain(self, timeout: float | None = None) -> None:
        """Block until queued work finished (tests, bench)."""
        self._q.join()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=2.0)

    # -- sampling ------------------------------------------------------
    def want_sample(self, tick: int) -> bool:
        return tick % self.sample_every == 0

    def skip_sample(self, reason: str, tick: int) -> None:
        """An honest non-check: the tick was sampled but could not be
        judged (degraded sweep, pipelined decode skew, mega tiles)."""
        with self._lock:
            sk = self.oracle_stats["skipped"]
            sk[reason] = sk.get(reason, 0) + 1
            self.oracle_stats["last_tick"] = int(tick)

    def next_cohort(self, slots: list[int]) -> list[int]:
        """Rotating cohort pick: successive samples walk the slot list
        so every entity is eventually audited, deterministically (no
        RNG — replayable under the chaos seed discipline)."""
        if not slots:
            return []
        slots = sorted(slots)
        k = min(self.cohort, len(slots))
        start = (self._sample_index * self.cohort) % len(slots)
        self._sample_index += 1
        picked = slots[start:start + k]
        if len(picked) < k:
            picked += slots[:k - len(picked)]
        return picked

    def judge_sample(self, *, tick: int, pos, alive, watch_radius,
                     radius: float, cohort_slots: list[int],
                     owner: dict[int, str],
                     interest: dict[str, set],
                     quant_step: float | None = None,
                     quant_hi: int = 0) -> None:
        """The worker-side oracle judgment (callers wrap this in
        ``submit``): recompute the cohort's interest rows brute-force
        and diff them against the decoded ``interested_in`` sets
        captured on the logic thread."""
        if quant_step is not None:
            pos = quantize_host(pos, quant_step, quant_hi)
        rows = cohort_oracle(pos, alive, radius, cohort_slots,
                             watch_radius=watch_radius)
        mismatches = 0
        for slot in cohort_slots:
            eid = owner.get(int(slot))
            if eid is None or eid not in interest:
                continue
            want = {owner[j] for j in rows.get(int(slot), set())
                    if j in owner}
            have = interest[eid]
            if have != want:
                mismatches += 1
                missing = sorted(want - have)[:4]
                extra = sorted(have - want)[:4]
                self.ledger.note_violation(
                    "aoi_oracle",
                    f"EntityID {eid}@slot{slot}: interest set diverges "
                    f"from oracle (missing {missing}, extra {extra}) "
                    f"at tick {tick}", tick)
        with self._lock:
            self.oracle_stats["samples"] += 1
            self.oracle_stats["entities_checked"] += len(cohort_slots)
            self.oracle_stats["mismatches"] += mismatches
            self.oracle_stats["last_tick"] = int(tick)

    def note_probe(self, checked: int, mismatches: int) -> None:
        with self._lock:
            self.probe_stats["samples"] += 1
            self.probe_stats["entities_checked"] += int(checked)
            self.probe_stats["mismatches"] += int(mismatches)

    # -- SnapshotChain scrub -------------------------------------------
    def scrub_snapshots(self, directory: str, game_id: int,
                        tick: int) -> None:
        """CRC-walk the world's SnapshotChain files (worker thread).
        ``read_freeze_file`` already refuses a damaged keyframe/delta
        (per-plane CRCs); here that refusal becomes a named violation
        instead of a surprise at the next ``-restore`` boot."""
        from goworld_tpu_torch import freeze as _freeze

        files = [
            os.path.join(directory, _freeze.chain_key_filename(game_id)),
            os.path.join(directory,
                         _freeze.chain_delta_filename(game_id)),
        ]
        walked = corrupt = 0
        err = None
        for path in files:
            if not os.path.exists(path):
                continue
            walked += 1
            try:
                _freeze.read_freeze_file(path)
            except Exception as exc:
                corrupt += 1
                err = f"{os.path.basename(path)}: {exc}"
                self.ledger.note_violation(
                    "snapshot_crc",
                    f"SnapshotChain scrub failed: {err}", tick)
        with self._lock:
            self.scrub_stats["walks"] += 1
            self.scrub_stats["files"] += walked
            self.scrub_stats["corrupt"] += corrupt
            if err:
                self.scrub_stats["last_error"] = err

    # -- reading -------------------------------------------------------
    def take_violation(self) -> str | None:
        return self.ledger.take_violation()

    def snapshot(self, tick: int = 0, eids: bool = False) -> dict:
        with self._lock:
            oracle = {
                "samples": self.oracle_stats["samples"],
                "entities_checked":
                    self.oracle_stats["entities_checked"],
                "mismatches": self.oracle_stats["mismatches"],
                "skipped": dict(self.oracle_stats["skipped"]),
                "last_tick": self.oracle_stats["last_tick"],
            }
            probes = dict(self.probe_stats)
            scrub = dict(self.scrub_stats)
        out = self.ledger.snapshot(tick=tick, eids=eids)
        out.update({
            "sample_every": self.sample_every,
            "cohort": self.cohort,
            "oracle": oracle,
            "probes": probes,
            "scrub": scrub,
            "samples_dropped": int(self._m_dropped.value),
        })
        return out

    def incident_context(self) -> dict:
        ctx = self.ledger.incident_context()
        with self._lock:
            ctx["oracle"] = dict(self.oracle_stats,
                                 skipped=dict(
                                     self.oracle_stats["skipped"]))
            ctx["probes"] = dict(self.probe_stats)
        return ctx


class CensusProbe:
    """Registry adapter for processes that hold an entity VIEW but no
    ledger (the dispatcher's routing table, a gate's client map): a
    snapshot provider called at scrape time. The provider receives
    ``eids`` and returns a plain dict; failures serve an honest
    ``{"error": ...}`` (observability must never take serving down)."""

    def __init__(self, provider: Callable[[bool], dict]):
        self._provider = provider

    def snapshot(self, tick: int = 0, eids: bool = False) -> dict:
        try:
            return self._provider(eids)
        except Exception as exc:
            return {"error": f"census provider failed: {exc!r}"}


# =======================================================================
# process-local registry (the ``/audit`` payload). Weak values: a plane
# belongs to its World and a discarded owner must not be pinned by the
# registry.
# =======================================================================
import weakref  # noqa: E402

_reg_lock = threading.Lock()
_planes: "weakref.WeakValueDictionary[str, Any]" = \
    weakref.WeakValueDictionary()


def register(name: str, plane):
    with _reg_lock:
        _planes[name] = plane
    return plane


def unregister(name: str) -> None:
    with _reg_lock:
        _planes.pop(name, None)


def get(name: str):
    with _reg_lock:
        return _planes.get(name)


def snapshot_all(eids: bool = False) -> dict:
    """``/audit``: every registered plane/probe's snapshot, or an
    honest absence."""
    with _reg_lock:
        planes = dict(_planes)
    if not planes:
        return {"error": "no audit plane in this process"}
    out: dict[str, Any] = {}
    for name, p in sorted(planes.items()):
        try:
            out[name] = p.snapshot(eids=eids)
        except Exception as exc:
            out[name] = {"error": f"snapshot failed: {exc!r}"}
    return out


def reset() -> None:
    """Drop registered planes (tests)."""
    with _reg_lock:
        _planes.clear()
