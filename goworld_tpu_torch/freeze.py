"""Freeze / restore — whole-game snapshot for hot reload, the port of
``goworld_tpu/freeze.py``.

Reference being rebuilt: ``engine/entity/EntityManager.go:520-617``
(``Freeze`` packs every entity's migrate-style data requiring exactly one
nil space; ``RestoreFreezedEntities`` rebuilds in 3 passes — nil space,
then spaces, then entities) plus ``components/game/GameService.go:220-269``
(``doFreeze`` drains pending work and writes ``game%d_freezed.dat``) and
``components/game/restore.go:16-34`` (read + unpack on ``-restore`` boot).

Device adaptation: the reference walks heap objects; here the canonical
hot state (positions, yaw, npc_moving) lives in device SoA lanes, so
freezing does ONE batched device-to-host copy of the relevant planes (the
World's ``_dget``) and joins them with the host-side attr trees / timers /
client bindings. Restore rebuilds the host object graph and lets the
normal staging path repopulate device rows on the first tick — the same
"spaces before entities" ordering the reference uses, because entities
need their target space's AOI shard to exist. A restored World's Verlet
cache starts invalid (its first tick rebuilds), as any fresh World's.

The torch seams: the World's flush writes staged rows into the live lanes
in place (and the resident carry overwrites them every tick), so the
asynchronous writers clone ``pos``/``yaw``/``npc_moving`` on the tick
thread (:func:`_pin_snapshot_planes`) and copy the clones on their worker
with a stream and event of their own (:func:`_fetch_planes`). The files
are MessagePack, written by :mod:`goworld_tpu_torch.utils.mpack`, byte
for byte the JAX package's. The reference's chaos crashpoint inside the
atomic write (``faults.maybe_crash``) belongs to the fault plane, which
is not ported (ROADMAP.md Queue A item 8).
"""

from __future__ import annotations

import os
import threading
from types import SimpleNamespace

import numpy as np
import torch

from goworld_tpu_torch.entity.attrs import load_into
from goworld_tpu_torch.entity.entity import Entity, GameClient
from goworld_tpu_torch.entity.manager import (
    World,
    _pack_words,
    _unpack_words,
)
from goworld_tpu_torch.entity.space import Space
from goworld_tpu_torch.utils import log, mpack

logger = log.get("freeze")

FREEZE_FORMAT_VERSION = 1


class CorruptSnapshotError(RuntimeError):
    """A freeze/checkpoint file exists but cannot be parsed (truncated
    write, disk fault, crash before the atomic rename of a pre-1 format
    writer). The restore path REJECTS such a file whole — half-loading a
    world is worse than falling back to an older snapshot or a cold
    boot."""


def freeze_filename(game_id: int) -> str:
    """Reference ``game%d_freezed.dat`` (``GameService.go:252``)."""
    return f"game{game_id}_freezed.dat"


# =======================================================================
# pack
# =======================================================================
def _device_snapshot(world: World) -> dict[str, np.ndarray]:
    """One batched transfer of every plane freeze needs (per-entity reads
    would pay the host<->device latency once per entity)."""
    st = world.state
    pos, yaw, mov = world._dget([st.pos, st.yaw, st.npc_moving])
    return {"pos": pos, "yaw": yaw, "npc_moving": mov}


# sentinel: pack device-resident pos/yaw/moving LATER from a state
# reference (async checkpoints patch the records off-thread)
_DEFER = object()


def _pack_entity(world: World, e: Entity, snap) -> dict:
    """Migrate-style record (``GetMigrateData``, ``Entity.go:1060-1101``)
    plus the space binding freeze needs and migrate doesn't."""
    live_slot = (
        e.slot is not None and e.shard is not None
        and e._pending_pos is None
    )
    extra: dict = {}
    if live_slot and snap is _DEFER:
        # placeholders; the checkpoint worker patches pos/yaw/moving
        # from the captured state off-thread (no device read here)
        pos, yaw, moving = [0.0, 0.0, 0.0], 0.0, False
        extra["_slot"] = [e.shard, e.slot]
    elif live_slot and snap is not None:
        shard, slot = e.shard, e.slot
        pos = [float(v) for v in snap["pos"][shard, slot]]
        yaw = float(snap["yaw"][shard, slot])
        moving = bool(snap["npc_moving"][shard, slot])
    else:
        pos = [float(v) for v in e.position]
        yaw = float(e._pending_yaw or 0.0)
        moving = False
    return extra | {
        "type": e.type_name,
        "id": e.id,
        "attrs": e.attrs.to_dict(),
        "client": (
            [e.client.gate_id, e.client.client_id]
            if e.client is not None else None
        ),
        "pos": pos,
        "yaw": yaw,
        "moving": moving,
        "space_id": e.space.id if e.space is not None else None,
        "timers": world.timers.dump(list(e.timer_ids)),
    }


def freeze_world(world: World, *, _snap=None, run_hooks: bool = True
                 ) -> dict:
    """Pack the entire world. Requires exactly one nil space (the same
    invariant the reference asserts, ``EntityManager.go:536-541``).

    ``_snap=_DEFER`` packs host state only, embedding (shard, slot) refs
    for the checkpoint worker to patch later; ``run_hooks=False`` skips
    OnFreeze (async checkpoints snapshot a RUNNING world — the reload
    hook contract doesn't apply)."""
    if world.nil_space is None:
        raise RuntimeError("cannot freeze: no nil space")
    # a pipelined world may hold one tick's outputs undecoded — the
    # snapshot must not lose their client sends / interest updates
    world.flush_pending_outputs()
    snap = _snap if _snap is not None else _device_snapshot(world)

    if run_hooks:
        for e in list(world.entities.values()):
            if not e.destroyed:
                try:
                    e.OnFreeze()
                except Exception:
                    logger.exception("OnFreeze failed for %s", e)

    spaces: list[dict] = []
    entities: list[dict] = []
    for e in world.entities.values():
        if e.destroyed:
            continue
        if e is world.nil_space:
            continue
        if isinstance(e, Space):
            spaces.append({
                "type": e.type_name,
                "id": e.id,
                "attrs": e.attrs.to_dict(),
                "use_aoi": e.shard is not None,
                "mega": e.is_mega,
                "timers": world.timers.dump(list(e.timer_ids)),
            })
        else:
            entities.append(_pack_entity(world, e, snap))

    nil = world.nil_space
    return {
        "version": FREEZE_FORMAT_VERSION,
        "game_id": world.game_id,
        "nil_space": {
            "attrs": nil.attrs.to_dict(),
            "timers": world.timers.dump(list(nil.timer_ids)),
        },
        "spaces": spaces,
        "entities": entities,
    }


# =======================================================================
# unpack
# =======================================================================
def _load_attrs_quiet(e: Entity, attrs: dict) -> None:
    """Fill the attr tree without journaling deltas: the restore path must
    not fan out attr-change messages (clients either reconnect fresh or
    already hold the values — reference 're-assign clients quietly')."""
    cb = e.attrs._root_cb
    e.attrs._root_cb = None
    try:
        load_into(e.attrs, attrs)
    finally:
        e.attrs._root_cb = cb


def restore_world(world: World, data: dict) -> None:
    """3-pass rebuild into a freshly constructed World (reference
    ``RestoreFreezedEntities``, ``EntityManager.go:556-617``)."""
    if data.get("version") != FREEZE_FORMAT_VERSION:
        raise ValueError(f"freeze format {data.get('version')!r} unsupported")
    if world.entities and not (
        len(world.entities) == 1 and world.nil_space is not None
    ):
        raise RuntimeError("restore requires an empty world")

    # pass 1: nil space (the migration anchor; its id is deterministic
    # from game_id so routing and CallNilSpaces keep working)
    nil = world.nil_space or world.create_nil_space()
    _load_attrs_quiet(nil, data["nil_space"].get("attrs", {}))
    for tid in world.timers.restore(data["nil_space"].get("timers", [])):
        nil.timer_ids.add(tid)

    # pass 2: spaces (entities need their shard to exist before entering)
    for sd in data["spaces"]:
        desc = world.registry.get(sd["type"])
        sp: Space = desc.cls()
        sp._type_desc = desc
        world._attach(sp, sd["id"])
        if sd.get("mega"):
            if world.mega is None:
                raise RuntimeError(
                    f"restore: space {sd['id']} is a megaspace but the "
                    "World was not built with megaspace=True"
                )
            for i in range(world.n_spaces):
                world._shard_space[i] = sp.id
            sp.is_mega = True
        elif sd.get("use_aoi", True):
            try:
                shard = world._shard_space.index(None)
            except ValueError:
                raise RuntimeError(
                    f"restore: no free shard for space {sd['id']} "
                    f"({world.n_spaces} configured)"
                ) from None
            world._shard_space[shard] = sp.id
            sp.shard = shard
        world.entities[sp.id] = sp
        world.spaces[sp.id] = sp
        _load_attrs_quiet(sp, sd.get("attrs", {}))
        for tid in world.timers.restore(sd.get("timers", [])):
            sp.timer_ids.add(tid)
        sp.OnRestored()

    # pass 3: entities — client bound BEFORE entering the space so the
    # spawn staging records has_client/client_gate in the same tick
    for ed in data["entities"]:
        desc = world.registry.get(ed["type"])
        e: Entity = desc.cls()
        e._type_desc = desc
        world._attach(e, ed["id"])
        world.entities[e.id] = e
        _load_attrs_quiet(e, ed.get("attrs", {}))
        if ed.get("client"):
            e.client = GameClient(ed["client"][0], ed["client"][1], world,
                                  owner=e)
        target = world.spaces.get(ed.get("space_id") or "") or world.nil_space
        world._enter_space_local(
            e, target, tuple(ed["pos"]), moving=bool(ed.get("moving"))
        )
        world.stage_pose(e, ed["pos"], float(ed.get("yaw", 0.0)))
        for tid in world.timers.restore(ed.get("timers", [])):
            e.timer_ids.add(tid)
        e.OnRestored()

    if world.audit is not None:
        # the direct rebuilds above bypass the ledger hooks: re-anchor
        # the audit census on the restored population (ISSUE 17)
        world.audit.ledger.resync(
            {e.id: e.type_name for e in world.entities.values()
             if not e.destroyed},
            world.tick_count)

    logger.info(
        "restored %d spaces + %d entities into game%d",
        len(data["spaces"]), len(data["entities"]), world.game_id,
    )


# =======================================================================
# file IO
# =======================================================================
def write_freeze_file(path: str, data: dict) -> None:
    """Atomic write (tmp + rename): a crash mid-freeze must never leave a
    truncated file that a ``-restore`` boot would half-load."""
    blob = mpack.packb(data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    logger.info("froze %d bytes -> %s", len(blob), path)


def read_freeze_file(path: str) -> dict:
    """Read + parse one snapshot. Version-2 (quantized/delta plane)
    files are RESOLVED here — a delta re-reads its keyframe, verifies
    the per-plane CRCs it recorded against the keyframe's actual
    planes, and reconstructs a version-1 record — so every caller
    (restore_world, has_restorable_snapshot, the candidate fallback
    walk) keeps working on the v1 shape, and ANY chain damage
    (truncated delta, missing/rewritten keyframe, CRC mismatch)
    surfaces as the same CorruptSnapshotError the freshest-parseable
    fallback already handles."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        data = mpack.unpackb(raw)
    except Exception as exc:
        raise CorruptSnapshotError(
            f"snapshot {path!r} is corrupt ({len(raw)} bytes): {exc}"
        ) from exc
    if not isinstance(data, dict) or "version" not in data:
        raise CorruptSnapshotError(
            f"snapshot {path!r} parsed but is not a freeze record"
        )
    if data.get("version") == SNAPSHOT_PLANE_VERSION:
        return _resolve_snapshot_v2(path, data)
    return data


def freeze_to_file(world: World, directory: str = ".") -> str:
    path = os.path.join(directory, freeze_filename(world.game_id))
    write_freeze_file(path, freeze_world(world))
    return path


def snapshot_candidates(game_id: int, directory: str = ".") -> list[str]:
    """Existing snapshot files for a game, freshest (by mtime) first:
    the freeze file (intentional reload), the periodic crash-recovery
    checkpoint, and the quantized/delta snapshot chain (delta first —
    it is the newest state; a corrupt or base-mismatched delta raises
    CorruptSnapshotError and the walk falls back to its keyframe).
    Mtime orders because any can be stale — a freeze file left over
    from an old reload must not shadow hours of newer checkpoints
    after a crash, and vice versa."""
    cands = []
    for p in (os.path.join(directory, freeze_filename(game_id)),
              os.path.join(directory, checkpoint_filename(game_id)),
              os.path.join(directory, chain_delta_filename(game_id)),
              os.path.join(directory, chain_key_filename(game_id))):
        try:
            cands.append((os.path.getmtime(p), p))
        except OSError:
            continue
    return [p for _, p in sorted(cands, reverse=True)]


def latest_snapshot_path(game_id: int, directory: str = ".") -> str | None:
    cands = snapshot_candidates(game_id, directory)
    return cands[0] if cands else None


def has_restorable_snapshot(game_id: int, directory: str = ".") -> bool:
    """True when at least one snapshot candidate PARSES. The boot path
    decides restore-vs-cold on this, so an all-corrupt snapshot set
    degrades to a loud cold boot instead of a supervisor crash loop."""
    for path in snapshot_candidates(game_id, directory):
        try:
            read_freeze_file(path)
            return True
        except CorruptSnapshotError as exc:
            logger.error("ignoring unrestorable snapshot: %s", exc)
    return False


def restore_from_file(world: World, directory: str = ".") -> None:
    """Restore for a ``-restore`` boot from the freshest PARSEABLE
    snapshot (:func:`snapshot_candidates`): a freeze file written by a
    reload, or a crash-recovery checkpoint written by the periodic
    cadence — the capability the reference lacks (a crashed, unfrozen
    game there loses everything since the last persistence save;
    SURVEY.md §5.3). A corrupt candidate (truncated write, disk fault)
    is rejected WHOLE and the next-freshest tried — recovery invariant:
    a damaged snapshot may cost freshness, never a half-loaded world or
    a supervisor crash loop."""
    cands = snapshot_candidates(world.game_id, directory)
    if not cands:
        raise FileNotFoundError(
            f"no freeze or checkpoint snapshot for game{world.game_id} "
            f"in {directory!r}"
        )
    data = None
    for path in cands:
        try:
            data = read_freeze_file(path)
            break
        except CorruptSnapshotError as exc:
            logger.error("rejecting snapshot: %s", exc)
    if data is None:
        raise CorruptSnapshotError(
            f"every snapshot candidate for game{world.game_id} is "
            f"corrupt: {cands}"
        )
    logger.info("restoring game%d from %s", world.game_id, path)
    restore_world(world, data)


# =======================================================================
# async checkpoint (crash recovery while the world keeps running)
# =======================================================================
def checkpoint_filename(game_id: int) -> str:
    return f"game{game_id}_checkpoint.dat"


class CheckpointHandle:
    """Handle to an in-flight async checkpoint: ``join()`` waits, then
    ``path``/``error`` report the outcome."""

    def __init__(self):
        self.path: str | None = None
        self.error: BaseException | None = None
        # seconds: the tick thread's capture, the worker's copy, patch
        # and write; bytes written
        self.capture_s = 0.0
        self.worker_s = 0.0
        self.nbytes = 0
        self._thread: threading.Thread | None = None

    def join(self, timeout: float | None = None) -> "CheckpointHandle":
        if self._thread is None:
            raise RuntimeError("checkpoint was never started")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint still in flight")
        if self.error is not None:
            raise self.error
        return self


def _pin_snapshot_planes(world):
    """Capture ``pos``/``yaw``/``npc_moving`` for a worker thread: device
    clones taken NOW, on the tick thread, between ticks (the flush writes
    staged rows into the live lanes in place, and the resident carry
    overwrites every lane each tick, so a captured reference would read
    a later tick), plus an event recorded after them on the compute
    stream, which :func:`_fetch_planes` waits on. The clones are fresh
    tensors no later tick touches."""
    st = world.state
    planes = SimpleNamespace(pos=st.pos.clone(), yaw=st.yaw.clone(),
                             npc_moving=st.npc_moving.clone(), ready=None)
    if st.pos.device.type == "cuda":
        planes.ready = torch.cuda.Event()
        planes.ready.record(torch.cuda.current_stream(st.pos.device))
    return planes


def _fetch_planes(planes) -> dict[str, np.ndarray]:
    """Worker-thread half of :func:`_pin_snapshot_planes`: the three
    clones to the host in one batched copy on a stream of the worker's
    own (after the capture's event), waited on by its own event."""
    lanes = [planes.pos, planes.yaw, planes.npc_moving]
    if planes.ready is None:
        got = _pack_words(lanes).numpy()
    else:
        dev = planes.pos.device
        stream = torch.cuda.Stream(dev)
        stream.wait_event(planes.ready)
        with torch.cuda.stream(stream):
            src = _pack_words(lanes)
            host = torch.empty(src.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        got = host.numpy()
    pos, yaw, mov = _unpack_words(got, lanes)
    return {"pos": pos, "yaw": yaw, "npc_moving": mov}


def _patch_records(data: dict, snap: dict) -> None:
    """Fill the deferred (shard, slot) records of a ``_DEFER`` freeze
    from fetched planes."""
    for rec in data["entities"]:
        ref = rec.pop("_slot", None)
        if ref is not None:
            sh, sl = ref
            rec["pos"] = [float(v) for v in snap["pos"][sh, sl]]
            rec["yaw"] = float(snap["yaw"][sh, sl])
            rec["moving"] = bool(snap["npc_moving"][sh, sl])


def checkpoint_async(world: World, directory: str = ".") -> CheckpointHandle:
    """Snapshot a RUNNING world without stalling its tick loop.

    The reference has only stop-the-world freeze (SIGHUP reload, SURVEY.md
    §3.6) plus per-entity attr persistence. Here the tick thread clones
    the three device planes and packs the host part (attrs, timers,
    client bindings) synchronously at the same tick boundary; the slow
    work — the device->host copy of the clones and the file write — runs
    on a background thread while ticks continue. The file is the
    standard freeze format (written atomically), restorable with
    :func:`restore_world` / :func:`restore_from_file`.

    Call from the logic thread, between ticks.
    """
    import time

    if getattr(world, "_ckpt_inflight", False):
        # overlapping checkpoints would race on the same output path;
        # calls come from the logic thread, so a plain flag suffices
        raise RuntimeError("a checkpoint is already in flight")
    t0 = time.perf_counter()
    world._ckpt_inflight = True
    planes = _pin_snapshot_planes(world)
    data = freeze_world(world, _snap=_DEFER, run_hooks=False)
    path = os.path.join(directory, checkpoint_filename(world.game_id))
    handle = CheckpointHandle()
    handle.capture_s = time.perf_counter() - t0

    def work() -> None:
        t1 = time.perf_counter()
        try:
            _patch_records(data, _fetch_planes(planes))
            write_freeze_file(path, data)   # already atomic (tmp+replace)
            handle.nbytes = os.path.getsize(path)
            handle.path = path
        except BaseException as exc:  # surfaced via join()
            handle.error = exc
            logger.exception("async checkpoint failed")
        finally:
            handle.worker_s = time.perf_counter() - t1
            world._ckpt_inflight = False

    t = threading.Thread(target=work, name="ckpt", daemon=True)
    handle._thread = t
    t.start()
    return handle


# =======================================================================
# quantized + delta-compressed snapshot chain (ISSUE 12)
# =======================================================================
# The monolithic msgpack snapshot re-serializes every entity's full
# f32 position/yaw each cadence. The chain writes the device planes
# QUANTIZED (int16 lattice coordinates — the same power-of-two lattice
# the precision sweep and the delta-sync wire use, GridSpec.quant_step)
# and DELTA-COMPRESSED: every `keyframe_every`-th write is a full
# keyframe, the writes between ship only the rows whose quantized
# planes changed, against the keyframe — with a per-plane CRC of the
# base recorded in each delta so a rewritten/damaged keyframe can
# never be silently merged (mismatch => CorruptSnapshotError => the
# candidate walk falls back to the keyframe itself, then the legacy
# files). Restore of a quantized snapshot is BIT-EXACT in the lattice
# domain: lattice points re-quantize to themselves, so
# write->restore->write produces byte-identical planes (tested in
# tests/test_freeze.py).

SNAPSHOT_PLANE_VERSION = 2
_PLANES = ("pos_xz", "pos_y", "yaw", "moving")
# yaw wire/plane step: full turn in 2^16 int16 steps (headings are
# modular, so int16 wraparound IS the mod-2pi wrap)
YAW_STEP = (2.0 * 3.141592653589793) / 65536.0


def chain_key_filename(game_id: int) -> str:
    return f"game{game_id}_ckpt_key.dat"


def chain_delta_filename(game_id: int) -> str:
    return f"game{game_id}_ckpt_delta.dat"


def _crc(b: bytes) -> int:
    import zlib

    return zlib.crc32(b) & 0xFFFFFFFF


def snapshot_quant_step(world: World) -> float:
    """The chain's position lattice step — GridSpec.quant_step, i.e.
    the EXACT step the precision sweep runs on when precision=q16
    (those worlds roundtrip bit-for-bit against their own AOI-visible
    positions), and the same <=2^15-points-per-axis power-of-two
    derivation for f32 worlds."""
    return world.cfg.grid.quant_step


def _extract_planes(data: dict, step: float,
                    origin: tuple = (0.0, 0.0)) -> dict:
    """Strip pos/yaw/moving out of a v1 record's entity list into
    quantized column planes (row i == entities[i]). ``origin`` is the
    grid origin — lattice coordinates are ORIGIN-RELATIVE so worlds
    with shifted/negative bounds quantize correctly (positions outside
    [origin, origin + 2^15*step) clamp into that window, the same
    clamp-into-bounds semantic the grid applies)."""
    ents = data["entities"]
    m = len(ents)
    ox, oz = float(origin[0]), float(origin[1])
    qxz = np.zeros((m, 2), np.int16)
    py = np.zeros((m,), np.float32)
    qyaw = np.zeros((m,), np.int16)
    mov = np.zeros((m,), np.uint8)
    hi = 32767
    for i, e in enumerate(ents):
        px, pyv, pz = e.pop("pos")
        qxz[i, 0] = min(max(int(np.floor((px - ox) / step)), 0), hi)
        qxz[i, 1] = min(max(int(np.floor((pz - oz) / step)), 0), hi)
        py[i] = np.float32(pyv)
        # modular wrap: int16 overflow of a heading is the 2pi wrap
        qyaw[i] = np.int16(
            np.uint16(int(round(e.pop("yaw") / YAW_STEP)) & 0xFFFF))
        mov[i] = 1 if e.pop("moving") else 0
    return {
        "pos_xz": qxz.tobytes(), "pos_y": py.tobytes(),
        "yaw": qyaw.tobytes(), "moving": mov.tobytes(),
    }


def _inject_planes(data: dict, planes: dict, step: float,
                   origin: tuple = (0.0, 0.0)) -> dict:
    """Inverse of :func:`_extract_planes`: dequantize the planes back
    into the entity records (v1 shape)."""
    ents = data["entities"]
    m = len(ents)
    ox, oz = float(origin[0]), float(origin[1])
    qxz = np.frombuffer(planes["pos_xz"], np.int16).reshape(m, 2)
    py = np.frombuffer(planes["pos_y"], np.float32)
    qyaw = np.frombuffer(planes["yaw"], np.int16)
    mov = np.frombuffer(planes["moving"], np.uint8)
    for i, e in enumerate(ents):
        e["pos"] = [float(np.float32(ox + int(qxz[i, 0]) * step)),
                    float(py[i]),
                    float(np.float32(oz + int(qxz[i, 1]) * step))]
        e["yaw"] = float((int(qyaw[i]) & 0xFFFF) * YAW_STEP)
        e["moving"] = bool(mov[i])
    return data


def _resolve_snapshot_v2(path: str, data: dict,
                         base: dict | None = None) -> dict:
    """Resolve a version-2 snapshot into the v1 record shape
    (read_freeze_file calls this; ALL failures — missing keys, wrong
    shapes, short planes — surface as CorruptSnapshotError so the
    freshest-parseable fallback walk handles them; a raw
    KeyError/ValueError here would crash the -restore boot instead of
    falling back)."""
    try:
        return _resolve_snapshot_v2_inner(path, data, base)
    except CorruptSnapshotError:
        raise
    except Exception as exc:
        raise CorruptSnapshotError(
            f"snapshot {path!r}: malformed v2 record ({exc!r})"
        ) from exc


def resolve_record(rec: dict, base: dict | None = None) -> dict:
    """A chain record (:meth:`SnapshotChain.build`) as the version-1
    freeze dict a restore takes, without the files: a delta resolves
    against ``base``, the keyframe record it was built against. Every
    failure is a :class:`CorruptSnapshotError`, as for a file."""
    return _resolve_snapshot_v2(f"<{rec.get('kind')} record>", rec, base)


def _resolve_snapshot_v2_inner(path: str, data: dict,
                               base: dict | None = None) -> dict:
    kind = data["kind"]
    step = float(data["quant"]["step"])
    origin = tuple(data["quant"].get("origin", (0.0, 0.0)))
    host = data["host"]
    planes = {nm: data["planes"][nm] for nm in _PLANES} \
        if kind == "key" else None
    if kind == "key":
        for nm in _PLANES:
            if _crc(planes[nm]) != data["plane_crcs"][nm]:
                raise CorruptSnapshotError(
                    f"snapshot {path!r}: plane {nm!r} CRC mismatch"
                )
    elif kind == "delta":
        base_path = os.path.join(os.path.dirname(path) or ".",
                                 data["base"]["file"])
        try:
            if base is None:
                with open(base_path, "rb") as f:
                    base = mpack.unpackb(f.read())
        except Exception as exc:
            raise CorruptSnapshotError(
                f"snapshot {path!r}: keyframe {base_path!r} "
                f"unreadable ({exc})"
            ) from exc
        if not isinstance(base, dict) or base.get("kind") != "key":
            raise CorruptSnapshotError(
                f"snapshot {path!r}: {base_path!r} is not a keyframe")
        for nm in _PLANES:
            if _crc(base["planes"][nm]) != data["base"]["plane_crcs"][nm]:
                # the keyframe moved on (or was damaged) under this
                # delta — merging would mix two worlds' planes
                raise CorruptSnapshotError(
                    f"snapshot {path!r}: base plane {nm!r} CRC "
                    f"mismatch vs {base_path!r}"
                )
        # reconstruct: each delta row either references a keyframe row
        # (by index) or ships its own values in the sparse section
        try:
            m = len(host["entities"])
            rows = np.frombuffer(data["rows"], np.int32)
            sparse = data["sparse"]
            widths = {"pos_xz": (np.int16, 2), "pos_y": (np.float32, 1),
                      "yaw": (np.int16, 1), "moving": (np.uint8, 1)}
            planes = {}
            for nm, (dt, w) in widths.items():
                bp = np.frombuffer(base["planes"][nm], dt)
                sp = np.frombuffer(sparse[nm], dt)
                bp = bp.reshape(-1, w)
                sp = sp.reshape(-1, w)
                out = np.zeros((m, w), dt)
                ref = rows >= 0
                out[ref] = bp[rows[ref]]
                out[~ref] = sp
                planes[nm] = out.tobytes()
        except Exception as exc:
            raise CorruptSnapshotError(
                f"snapshot {path!r}: delta reconstruction failed "
                f"({exc!r})"
            ) from exc
    else:
        raise CorruptSnapshotError(
            f"snapshot {path!r}: unknown v2 kind {kind!r}")
    return _inject_planes(dict(host), planes, step, origin)


class SnapshotChain:
    """Quantized/delta snapshot writer for one world (checkpoint
    cadence). ``write()`` freezes the world synchronously; every
    ``keyframe_every``-th write (and the first) is a full keyframe,
    the rest are deltas against the last WRITTEN keyframe (held in
    memory, so delta writes never re-read disk). Files are written
    atomically via the same tmp+rename path as every snapshot.

    Scope honesty: the DELTA treatment covers the DEVICE planes
    (pos/yaw/moving — the bulk at NPC scale); the host section (ids,
    attrs, timers, bindings) still serializes whole each write,
    because attrs mutate outside any dirty tracking this writer can
    see — attr-heavy worlds keep correctness but less of the byte
    win.

    Threading: ``write()`` stays the synchronous whole path. A worker
    (the reference's replication worker, not ported yet) splits it: the
    tick thread calls :meth:`capture` (cheap — host records with
    deferred plane refs), the worker calls :meth:`complete_capture`
    (the device fetch), :meth:`build` (quantize + diff) and
    :meth:`write_record` (disk).
    The keyframe memory (``_key_planes``/``_key_rows``) is touched
    only by build(), so exactly ONE thread may build — the worker's,
    or the caller's via write(), never both."""

    def __init__(self, world: World, directory: str = ".",
                 keyframe_every: int = 8):
        if keyframe_every < 1:
            raise ValueError(
                f"keyframe_every must be >= 1, got {keyframe_every!r}")
        self.world = world
        self.directory = directory
        self.keyframe_every = int(keyframe_every)
        self.step = snapshot_quant_step(world)
        # lattice coordinates are origin-relative (shifted/negative
        # worlds must not clamp to the zero corner)
        g = world.cfg.grid
        self.origin = (float(g.origin_x), float(g.origin_z))
        self._count = 0
        self._key_planes: dict | None = None
        self._key_crcs: dict | None = None
        self._key_rows: dict | None = None   # eid -> keyframe row

    def capture(self) -> tuple:
        """Tick-thread half of an off-thread chain write: host records
        with (shard, slot) plane refs deferred (no device read) plus
        the cloned planes to fetch them from later (see
        :func:`_pin_snapshot_planes`). Pair with
        :meth:`complete_capture` on the worker thread."""
        planes = _pin_snapshot_planes(self.world)
        data = freeze_world(self.world, _snap=_DEFER, run_hooks=False)
        return data, planes, int(self.world.tick_count)

    @staticmethod
    def complete_capture(captured: tuple) -> tuple[dict, int]:
        """Worker-thread half: one batched device fetch of the captured
        planes, patched into the deferred records (the checkpoint_async
        worker's exact dance). Returns ``(data, tick)`` ready for
        :meth:`build`."""
        data, planes, tick = captured
        _patch_records(data, _fetch_planes(planes))
        return data, tick

    def write(self) -> str:
        data = freeze_world(self.world, run_hooks=False)
        kind, rec = self.build(data)
        return self.write_record(kind, rec)

    def write_record(self, kind: str, rec: dict) -> str:
        """Write one built record to its chain file (atomic, same
        tmp+rename path as every snapshot)."""
        name = chain_key_filename(self.world.game_id) if kind == "key" \
            else chain_delta_filename(self.world.game_id)
        path = os.path.join(self.directory, name)
        write_freeze_file(path, rec)
        return path

    def build(self, data: dict, force_key: bool = False
              ) -> tuple[str, dict]:
        """Quantize + diff one captured v1 freeze dict into a chain
        record — ``("key"|"delta", record)`` — WITHOUT touching disk
        (the replication stream ships the same records in-band).
        Mutates the keyframe memory: single-builder-thread contract
        (class docstring). ``force_key`` forces a keyframe out of
        cadence (standby attach, CRC resync, backlog collapse)."""
        planes = _extract_planes(data, self.step,   # pops pos/yaw/moving
                                 self.origin)
        eids = [e["id"] for e in data["entities"]]
        is_key = (force_key or self._key_planes is None
                  or self._count % self.keyframe_every == 0)
        self._count += 1
        if is_key:
            crcs = {nm: _crc(planes[nm]) for nm in _PLANES}
            rec = {
                "version": SNAPSHOT_PLANE_VERSION, "kind": "key",
                "quant": {"step": self.step, "yaw_step": YAW_STEP,
                          "origin": list(self.origin)},
                "planes": planes, "plane_crcs": crcs, "host": data,
            }
            self._key_planes = planes
            self._key_crcs = crcs
            self._key_rows = {eid: i for i, eid in enumerate(eids)}
            return "key", rec
        # delta vs the remembered keyframe: a row is a REFERENCE when
        # the entity existed at the keyframe with identical quantized
        # planes, else its values ship in the sparse section
        widths = {"pos_xz": (np.int16, 2), "pos_y": (np.float32, 1),
                  "yaw": (np.int16, 1), "moving": (np.uint8, 1)}
        cur = {nm: np.frombuffer(planes[nm], dt).reshape(-1, w)
               for nm, (dt, w) in widths.items()}
        key = {nm: np.frombuffer(self._key_planes[nm], dt)
               .reshape(-1, w) for nm, (dt, w) in widths.items()}
        m = len(eids)
        # vectorized row diff: only the eid->row dict lookups loop;
        # the 4 plane compares run as whole-array numpy equality
        # (an O(entities) Python compare loop on the tick thread is
        # exactly the cost this chain exists to avoid)
        kr = np.asarray([self._key_rows.get(eid, -1) for eid in eids],
                        np.int32)
        same = kr >= 0
        krc = np.maximum(kr, 0)
        for nm in _PLANES:
            same &= (cur[nm][np.arange(m)] ==
                     key[nm][krc]).all(axis=1)
        rows = np.where(same, kr, np.int32(-1))
        sp_mask = rows < 0
        sparse = {nm: cur[nm][sp_mask].tobytes() for nm in _PLANES}
        rec = {
            "version": SNAPSHOT_PLANE_VERSION, "kind": "delta",
            "quant": {"step": self.step, "yaw_step": YAW_STEP,
                          "origin": list(self.origin)},
            "base": {
                "file": chain_key_filename(self.world.game_id),
                "plane_crcs": self._key_crcs,
            },
            "rows": rows.tobytes(), "sparse": sparse, "host": data,
        }
        return "delta", rec
