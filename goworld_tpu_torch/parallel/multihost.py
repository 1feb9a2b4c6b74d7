"""A game of several controller processes, the port of
``goworld_tpu/parallel/multihost.py``.

The JAX package forms one global device mesh over every process with
``jax.distributed`` and lets XLA route the ``all_to_all``, ``ppermute``
and ``psum`` legs that cross process boundaries. This port keeps the
design, one SPMD program a controller over one global mesh, and
changes the transport: the controllers form a ``torch.distributed``
process group on the gloo backend, and the steps
(:mod:`goworld_tpu_torch.parallel.step`,
:mod:`goworld_tpu_torch.parallel.megaspace`) and the World call the
group's collectives (:class:`Group`) where the JAX program has its
cross-process legs.

Gloo on the card as well: NCCL refuses two ranks on one GPU, which is
how a one-card host runs two controllers, and gloo takes CUDA tensors
for broadcast and all-reduce only. So every collective here stages
its CUDA tensors through pinned host memory: one device-to-host copy
and one wait on the stream (the host sync a JAX cross-process
collective also blocks on, counted in :data:`STATS`), the gloo call,
and one non-blocking copy back. Nothing switches backend, and a rank
that does not join within the timeout raises.

Rank ``r`` owns shards ``[r * n_local, (r + 1) * n_local)`` of the
global mesh, the order of ``jax.devices()`` over processes.
"""

from __future__ import annotations

import datetime
import time

import torch

from goworld_tpu_torch.core.state import resolve_device

# seconds a rank waits for the others to join, and for a collective
DEFAULT_TIMEOUT_S = 120.0

# host syncs the collectives made (one a staged collective on the card)
# and the seconds spent in them, from the caller's side; of those, the
# seconds of the device-to-host staging (the copies and the wait for the
# stream) and of gloo's calls (the wire, and the wait for the peers)
STATS = {"host_syncs": 0, "collectives": 0, "seconds": 0.0,
         "stage_seconds": 0.0, "wire_seconds": 0.0}

_GROUP: "Group | None" = None


def reset_stats() -> None:
    """Set every count of :data:`STATS` to 0."""
    STATS.update(host_syncs=0, collectives=0, seconds=0.0,
                 stage_seconds=0.0, wire_seconds=0.0)


def _add(key: str, t0: float) -> None:
    STATS[key] += time.perf_counter() - t0


class Group:
    """The controller group of this process: ``rank`` of ``size``, over
    the default ``torch.distributed`` process group. A group of one
    (``size == 1``) calls nothing: every collective is the identity."""

    def __init__(self, rank: int = 0, size: int = 1):
        self.rank = int(rank)
        self.size = int(size)

    # -- staging -------------------------------------------------------
    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.device.type != "cuda":
            return t
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        STATS["host_syncs"] += 1
        _add("stage_seconds", t0)
        return host

    @staticmethod
    def _pinned(shape, dtype, device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           pin_memory=device.type == "cuda")

    @staticmethod
    def _back(host: torch.Tensor, device) -> torch.Tensor:
        if device.type != "cuda":
            return host
        return host.to(device, non_blocking=True)

    def _timed(self, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            STATS["collectives"] += 1
            STATS["seconds"] += time.perf_counter() - t0

    # -- collectives ---------------------------------------------------
    def all_gather(self, t: torch.Tensor, host: bool = False) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` in rank order, on
        ``t``'s device, or in host memory with ``host`` (every rank
        passes the same shape and dtype)."""
        if self.size == 1:
            t = t.unsqueeze(0)
            return t.cpu() if host else t
        import torch.distributed as dist

        def run():
            src = self._to_host(t)
            out = self._pinned((self.size,) + tuple(t.shape), t.dtype,
                               t.device)
            t0 = time.perf_counter()
            dist.all_gather(list(out.unbind(0)), src)
            _add("wire_seconds", t0)
            return out if host else self._back(out, t.device)
        return self._timed(run)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``q`` of ``t`` (its leading axis has ``size`` blocks)
        goes to rank ``q``; returns the blocks received, in sender
        order."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: {t.shape[0]} blocks for "
                             f"{self.size} ranks")
        if self.size == 1:
            return t
        import torch.distributed as dist

        def run():
            src = self._to_host(t)
            out = self._pinned(tuple(t.shape), t.dtype, t.device)
            t0 = time.perf_counter()
            dist.all_to_all_single(out, src)
            _add("wire_seconds", t0)
            return self._back(out, t.device)
        return self._timed(run)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, on ``t``'s device."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        def run():
            host = self._to_host(t).clone()
            t0 = time.perf_counter()
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            _add("wire_seconds", t0)
            return self._back(host, t.device)
        return self._timed(run)

    def exchange(self, sends: dict, recvs: dict) -> dict:
        """Point-to-point legs: ``sends[q]`` (a tensor) goes to rank q,
        and ``recvs[p]`` (``(shape, dtype)``) is what rank p sends here;
        returns ``{p: tensor}`` on the device of the first send (or the
        CPU). Every rank calls it at the same point with matching
        legs."""
        if self.size == 1 or not (sends or recvs):
            return {}
        import torch.distributed as dist

        dev = next(iter(sends.values())).device if sends \
            else torch.device("cpu")

        def run():
            ops, out = [], {}
            if dev.type == "cuda":
                # every leg's copy, then one wait
                t0 = time.perf_counter()
                hosts = {}
                for q, t in sends.items():
                    hosts[q] = self._pinned(t.shape, t.dtype, dev)
                    hosts[q].copy_(t, non_blocking=True)
                if hosts:
                    torch.cuda.current_stream(dev).synchronize()
                    STATS["host_syncs"] += 1
                _add("stage_seconds", t0)
            else:
                hosts = {q: t.contiguous() for q, t in sends.items()}
            for q in sorted(hosts):
                ops.append(dist.P2POp(dist.isend, hosts[q], q))
            for p in sorted(recvs):
                shape, dtype = recvs[p]
                out[p] = self._pinned(shape, dtype, dev)
                ops.append(dist.P2POp(dist.irecv, out[p], p))
            t0 = time.perf_counter()
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            _add("wire_seconds", t0)
            return {p: self._back(h, dev) for p, h in out.items()}
        return self._timed(run)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     timeout: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join (or form) the controller group: ``torch.distributed`` on the
    gloo backend over ``tcp://<coordinator_address>`` (``host:port``;
    rank 0 listens there). Every rank blocks until all
    ``num_processes`` have joined, and raises after ``timeout`` seconds
    without them; a collective that waits longer raises too. Returns
    the group, which :func:`current_group` also gives."""
    import torch.distributed as dist

    global _GROUP
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    _GROUP = Group(process_id, num_processes)
    return _GROUP


def shutdown() -> None:
    """Leave the controller group (its process group destroyed)."""
    global _GROUP
    if _GROUP is not None and _GROUP.size > 1:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _GROUP = None


def current_group() -> Group:
    """This process's group (a group of one before
    :func:`init_distributed`)."""
    return _GROUP if _GROUP is not None else Group()


def global_mesh(n_devices: int, device="cuda"):
    """The mesh of ``n_devices`` shards over every controller, in
    process order: this rank owns ``n_devices`` over the group's size of
    them, on ``device`` (the card unless the caller asks for the CPU).
    Every rank builds the same mesh."""
    from goworld_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices, device=resolve_device(device),
                     group=current_group())


def local_shard_indices(mesh) -> list[int]:
    """Mesh positions owned by THIS process: the shards whose lanes
    live here and whose outputs this controller decodes."""
    return list(mesh.local_shards)


def local_shard_outputs(out_tree, mesh):
    """``(indices, [per-shard outputs])``: each of this controller's
    shards' outputs as a dataclass of numpy lanes, the leading shard
    axis stripped. The step's outputs hold the local shards only, so
    nothing crosses processes here."""
    import dataclasses

    idxs = local_shard_indices(mesh)

    def host(x, k):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: host(getattr(x, f.name), k)
                              for f in dataclasses.fields(x)})
        if x is None:
            return None
        return x[k].detach().cpu().numpy()

    return idxs, [host(out_tree, k) for k in range(len(idxs))]
