"""Process groups and collectives for data parallelism across cards.

Port of ``acav100m_tpu/runtime/mesh.py``. The JAX package is one
controller over a ``Mesh``: its stages shard a batch axis and XLA inserts
the ``psum``s. PyTorch's model is one process per card instead, joined by
a ``torch.distributed`` process group (NCCL for CUDA tensors, gloo for CPU
ones) and launched by ``torchrun`` or ``torch.multiprocessing`` spawn. So
the counterpart of ``get_mesh`` is a ``Group`` handle (rank, world size,
device, backend) that ``initialize_runtime`` returns, and the stages call
the collectives below where the JAX package's ``psum`` and all-gather sit.
Where the JAX package shards a batch with ``P("data")`` under ``jit``,
``shard_rows`` cuts this rank's block, and ``all_gather_rows`` and
``sum_shares`` are the differentiable collectives of a sharded train
step.
The JAX ``cpu_mesh_env`` (virtual devices in one process) has no
counterpart: a CPU run here is several gloo processes.

Nothing switches backend or device on its own: a CUDA group without NCCL
raises, a missing card raises (``device.resolve_device``), and a tensor on
another device than the group's raises. ``backend="gloo"`` on a CUDA
device is allowed (several ranks sharing one card, where NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the data-parallel group. ``backend`` is None for a
    single process without a process group: every collective is then the
    identity."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       device=None,
                       backend: Optional[str] = None,
                       timeout_s: Optional[float] = None) -> Group:
    """Join (or, with one process, skip) the process group; returns this
    rank's ``Group``.

    Arguments left None come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK`` (else the rank), and ``MASTER_ADDR``/
    ``MASTER_PORT`` through ``env://``). One process without a ``coordinator_address`` is a no-op,
    as in the JAX package; one process with an address forms a real
    one-rank group. ``device`` defaults to ``cuda:LOCAL_RANK`` (``"cpu"``
    asks for the CPU, ``"cuda"`` means ``cuda:LOCAL_RANK``); ``backend`` to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU.
    """
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    local = int(env.get("LOCAL_RANK", rank))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if device is None or str(device) == "cuda":
        device = f"cuda:{local}"
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend nccl needs a CUDA device, not {device}")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA group asks for NCCL, which this torch lacks")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    if world == 1 and coordinator_address is None:
        return Group(0, 1, device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, **kwargs)
    return Group(rank, world, device, backend)


def shutdown_runtime(group: Group) -> None:
    """Leave the process group (a no-op for a group of one process)."""
    if group.distributed and dist.is_initialized():
        dist.destroy_process_group()


def placement(cfg_index, cfg_total, group: Optional[Group]):
    """(index, total) of this process's shards: the config's
    ``computation.index``/``total``, or the group's rank and world size. A
    config that names another placement than the group's raises; the
    defaults (0 of 1) defer to the group."""
    index, total = cfg_index or 0, cfg_total or 1
    if group is None:
        return index, total
    if (index, total) not in ((0, 1), (group.rank, group.world_size)):
        raise ValueError(
            f"computation.index/total = {index}/{total}, but this process is rank "
            f"{group.rank} of {group.world_size}"
        )
    return group.rank, group.world_size


def group_device(name, group: Optional[Group]) -> torch.device:
    """A stage's ``computation.device`` (default ``cuda``, raising without a
    card), or with a group the group's device, which must be of the type
    ``name`` names, if it names one."""
    if group is None:
        return resolve_device(name)
    device = resolve_device(name if name is not None else group.device.type)
    if group.device.type != device.type:
        raise ValueError(f"computation.device={device} but the group runs on "
                         f"{group.device}")
    return group.device


def _check(t: Tensor, group: Group) -> None:
    if t.device != group.device:
        raise ValueError(f"tensor on {t.device}, group on {group.device}")


def all_reduce_sum(t: Tensor, group: Optional[Group]) -> Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    if group is None or not group.distributed:
        return t
    _check(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_cat(t: Tensor, group: Optional[Group], dim: int = 0) -> Tensor:
    """Every rank's ``t`` (of one shape on all ranks) concatenated along
    ``dim`` in rank order."""
    if group is None or not group.distributed:
        return t
    _check(t, group)
    t = t.contiguous()
    parts: List[Tensor] = [torch.empty_like(t) for _ in range(group.world_size)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim)


def broadcast(t: Tensor, group: Optional[Group], src: int = 0) -> Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if group is None or not group.distributed:
        return t
    _check(t, group)
    dist.broadcast(t, src=src)
    return t


def barrier(group: Optional[Group]) -> None:
    if group is None or not group.distributed:
        return
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


def shard_rows(x, group: Optional[Group]):
    """This rank's contiguous block of a global batch's rows (numpy or
    tensor): rows ``[r*B/W, (r+1)*B/W)``, as ``P("data")`` places them. A
    batch the ranks cannot split evenly raises ``ValueError``, as the JAX
    package's ``jit`` refuses one; every rank raises before any collective."""
    if group is None:
        return x
    b, world = len(x), group.world_size
    if b % world:
        raise ValueError(f"a global batch of {b} rows does not split evenly over "
                         f"{world} ranks")
    per = b // world
    return x[group.rank * per:(group.rank + 1) * per]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_cat(t, group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        grad = all_reduce_sum(grad.clone(memory_format=torch.contiguous_format), group)
        per = grad.shape[0] // group.world_size
        return grad[group.rank * per:(group.rank + 1) * per], None


def all_gather_rows(t: Tensor, group: Optional[Group]) -> Tensor:
    """``all_gather_cat`` along the rows, differentiable: the backward sums
    the gathered rows' gradients over the ranks and keeps this rank's rows
    (the reference's ``diff_all_gather``). It all-reduces rather than
    reduce-scatters, which gloo cannot do on CUDA tensors."""
    if group is None or not group.distributed:
        return t
    return _GatherRows.apply(t, group)


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_shares(t: Tensor, group: Optional[Group]) -> Tensor:
    """The sum of every rank's ``t``, whose gradient flows back to this
    rank's ``t`` unchanged: ``t`` is the rank's share of a global sum, and
    summing the parameters' gradients over the ranks then gives the global
    sum's gradient."""
    if group is None or not group.distributed:
        return t
    return _SumShares.apply(t, group)


def _flat(tensors: Sequence[Tensor], op) -> None:
    """``op`` in place on one flat copy of ``tensors`` a dtype (dtypes in
    the order they first appear, alike on every rank), written back."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dtype]
        with torch.no_grad():
            flat = op(torch.cat([t.reshape(-1) for t in part]))
            offset = 0
            for t in part:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_sum_flat(tensors: Sequence[Tensor], group: Optional[Group]) -> None:
    """Sum each of ``tensors`` over the ranks, in place, in one all-reduce
    of one flat bucket a dtype (a train step's gradients)."""
    if group is not None and group.distributed:
        _flat(tensors, lambda flat: all_reduce_sum(flat, group))


def broadcast_flat(tensors: Sequence[Tensor], group: Optional[Group], src: int = 0) -> None:
    """Rank ``src``'s ``tensors`` on every rank, in place, in one broadcast
    of one flat bucket a dtype."""
    if group is not None and group.distributed:
        _flat(tensors, lambda flat: broadcast(flat, group, src))
