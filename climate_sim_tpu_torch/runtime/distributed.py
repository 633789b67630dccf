"""Multi-process runs over ``torch.distributed``: the port of the multi-host
part of ``climate_sim_tpu/runtime/driver.py`` (:45-127), the counterpart of
the reference's ``MPI_Init`` and rank-0 gating (main.cpp:24).

One process (rank) per card, each owning a contiguous run of the global
mesh's tiles (:mod:`..parallel.mesh`).  Two kinds of traffic:

* control, on the default group, which is gloo: barriers, scalar
  reductions, device discovery.  Its timeout, and the bound of
  :func:`bounded_sync`, is ``CLIMATE_SIM_SYNC_TIMEOUT_S`` (default 600 s),
  so a peer fails rather than hangs when a rank dies;
* the halo payloads, point to point (:class:`Transport`): an NCCL subgroup
  when every rank's tiles are on CUDA and no card is shared between ranks,
  else gloo through pinned host buffers (NCCL refuses two ranks on one
  card).  A failure to create the NCCL group raises; the run never drops
  to gloo in its place.

Nothing here gathers the field: :func:`fetch_global` exists for inspection
and the driver never calls it.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_spec: Optional[str] = None

SPEC_ERROR = "distributed must be 'auto' or 'coordinator:port,num_processes,process_id'"


def parse_spec(spec: str) -> Tuple[str, int, int]:
    """``(init_method, world_size, rank)`` of a ``"host:port,n,i"`` spec,
    raising the JAX package's errors for a malformed one."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(SPEC_ERROR)
    return f"tcp://{parts[0]}", int(parts[1]), int(parts[2])


def sync_timeout_s() -> float:
    return float(os.environ.get("CLIMATE_SIM_SYNC_TIMEOUT_S", "600"))


def maybe_init_distributed(cfg) -> None:
    """Join the process group of ``cfg.distributed`` (once per process):
    ``"auto"`` reads the torchrun environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), else ``"host:port,n,i"``.  A second,
    different spec raises, as in the JAX package."""
    global _spec
    if not cfg.distributed:
        return
    if _spec is not None:
        if cfg.distributed != _spec:
            raise RuntimeError(
                f"distributed already initialized with {_spec!r};"
                f" cannot re-initialize with {cfg.distributed!r}"
            )
        return
    timeout = datetime.timedelta(seconds=sync_timeout_s())
    if cfg.distributed == "auto":
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    else:
        init_method, world, rank = parse_spec(cfg.distributed)
        dist.init_process_group("gloo", init_method=init_method, world_size=world,
                                rank=rank, timeout=timeout)
    _spec = cfg.distributed


def shutdown() -> None:
    """Leave the process group (the CLI's last step)."""
    global _spec
    if initialized():
        dist.destroy_process_group()
    _spec = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_controller() -> bool:
    """True on the logging/IO process (rank 0)."""
    return rank() == 0


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK``, else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def default_devices() -> List[torch.device]:
    """This rank's devices when the caller names none: one card,
    ``cuda:(local_rank % device_count)``, made current."""
    if not torch.cuda.is_available():
        raise RuntimeError("no device named and torch.cuda.is_available() is False")
    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return [dev]


def chip_name(device: torch.device) -> str:
    """A card's name that every rank agrees on: its UUID on CUDA."""
    if device.type == "cuda":
        return f"cuda-{torch.cuda.get_device_properties(device).uuid}"
    return device.type


def global_devices(devices: Sequence[torch.device]) -> List[Tuple[int, str, str]]:
    """Every rank's devices, concatenated in rank order, as ``(rank,
    device, chip name)``; in one process, this process's list."""
    mine = [(str(d), chip_name(d)) for d in devices]
    if not initialized():
        return [(0, d, c) for d, c in mine]
    lists: List = [None] * world_size()
    dist.all_gather_object(lists, mine)
    return [(r, d, c) for r, lst in enumerate(lists) for d, c in lst]


def bounded_sync(name: str, timeout_s: Optional[float] = None) -> None:
    """A barrier of every rank that FAILS rather than hangs when a peer
    dies (``monitored_barrier`` on the gloo group), bounded by
    ``timeout_s`` (default ``CLIMATE_SIM_SYNC_TIMEOUT_S``).  No-op in one
    process."""
    if not initialized():
        return
    t = sync_timeout_s() if timeout_s is None else timeout_s
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=t))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {rank()}: {e}") from e


def reduce(values: Sequence[float], op: str) -> np.ndarray:
    """``values`` reduced over every rank (``op`` "min", "max" or "sum"),
    in float64 on the host."""
    t = torch.tensor(values, dtype=torch.float64)
    if initialized():
        dist.all_reduce(t, op={"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
                               "sum": dist.ReduceOp.SUM}[op])
    return t.numpy()


def raise_together(err: Optional[BaseException], what: str) -> None:
    """Every rank raises if any rank's ``what`` failed (``err`` is this
    rank's failure or None), so that no peer is left waiting in the next
    exchange."""
    failed = reduce([0.0 if err is None else 1.0], "max")[0]
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"{what} failed on another rank")


def fetch_global(tiles) -> np.ndarray:
    """The full field on this host, from every rank's tiles (a collective:
    every rank calls it).  For inspection only: the driver never calls it,
    and snapshots write each rank's own regions."""
    mine = [(y, x, t.to("cpu", torch.float64).numpy())
            for y, row in enumerate(tiles) for x, t in enumerate(row) if t is not None]
    if initialized():
        parts: List = [None] * world_size()
        dist.all_gather_object(parts, mine)
        mine = [p for part in parts for p in part]
    grid = {(y, x): a for y, x, a in mine}
    py = 1 + max(y for y, _ in grid)
    px = 1 + max(x for _, x in grid)
    return np.block([[grid[(y, x)] for x in range(px)] for y in range(py)])


class Transport:
    """The halo payloads between ranks, one batch of point-to-point
    operations per call (``dist.batch_isend_irecv``).

    ``kind`` "nccl": device tensors on an NCCL subgroup, matched in issue
    order (every rank walks the tiles in one order); waiting on the works
    orders the current stream after them, not the host.  Inside a chunk's
    CUDA graph capture (:mod:`.graphs`) the batch is recorded into the
    graph: the wait orders the capturing stream, the receive buffers come
    from the graph's pool, and the communicator is already live (the
    probe of :func:`make_transport`).  ``kind`` "gloo":
    each payload staged through a host tensor (pinned for a CUDA tile) on
    the default group, matched by tag, then copied to the destination's
    device.
    """

    def __init__(self, kind: str, group=None, why: str = ""):
        self.kind, self.group, self.why = kind, group, why

    def describe(self) -> str:
        return f"{self.kind} ({self.why})" if self.why else self.kind

    def exchange(self, sends: Iterable[Tuple[torch.Tensor, int, int]],
                 recvs: Iterable[Tuple[torch.Tensor, int, int]]) -> List[torch.Tensor]:
        """Send each ``(tensor, peer, tag)`` of ``sends`` and receive one
        tensor shaped like each ``(like, peer, tag)`` of ``recvs``; returns
        the received tensors, each on its ``like``'s device."""
        sends, recvs = list(sends), list(recvs)
        nccl = self.kind == "nccl"
        ops, keep, bufs = [], [], []
        for t, peer, tag in sends:
            buf = t.contiguous() if nccl else _host_copy(t)
            keep.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, peer, self.group, tag))
        for like, peer, tag in recvs:
            if nccl:
                buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            else:
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  pin_memory=like.device.type == "cuda")
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if nccl:
            return bufs
        return [b.to(like.device, non_blocking=True) for b, (like, _, _) in zip(bufs, recvs)]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` that is complete on return (pinned
    for a CUDA tensor); a contiguous CPU tensor is sent as it is."""
    if t.device.type != "cuda":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def make_transport(mesh) -> Transport:
    """The payload transport of a mesh spread over ranks (a collective:
    every rank calls it and takes the same branch)."""
    cards = [(mesh.devices[y][x], mesh.chips[y][x], mesh.owners[y][x])
             for y in range(mesh.shape["y"]) for x in range(mesh.shape["x"])]
    if any(d.type != "cuda" for d, _, _ in cards):
        return Transport("gloo", why="host-staged; tiles on the CPU")
    ranks_of = {}
    for _, chip, owner in cards:
        ranks_of.setdefault(chip, set()).add(owner)
    if any(len(r) > 1 for r in ranks_of.values()):
        return Transport("gloo", why="host-staged; ranks share a card")
    group = dist.new_group(backend="nccl")
    # Bring the communicator up on every rank at once, so the first
    # exchange, in which some ranks may have no payload, is not its first
    # operation.
    local = mesh.distinct_devices()
    dev = local[0] if local else torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    probe = torch.zeros(1, device=dev)
    dist.all_reduce(probe, group=group)
    torch.cuda.synchronize(dev)
    return Transport("nccl", group)
