"""The collectives of a data-parallel step over ``torch.distributed``.

A data-parallel step (``dist/mesh.shard_train_step``) runs each rank's
network on its contiguous shard of the batch and must give what one
process gives on the whole batch. Inside :func:`data_parallel`, the norms
that take batch statistics (``layers.BatchNorm``,
``sparse/conv.MaskedBatchNorm``) read :func:`active_group` and sum their
statistics over the ranks with :func:`all_reduce_sum`, whose gradient is
the sum over the ranks of the ranks' gradients, so every rank normalises
with the global batch's statistics and backpropagates through them
exactly. Outside it (one process, evaluation) they are local.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.distributed as dist

__all__ = ["active_group", "data_parallel", "all_reduce_sum", "world", "shard_rows", "gather_rows"]

_GROUP: ContextVar = ContextVar("roreg_data_parallel_group", default=None)


def active_group():
    """The process group of the data-parallel step being run, or None."""
    return _GROUP.get()


@contextlib.contextmanager
def data_parallel(group):
    """Batch statistics are summed over ``group``'s ranks while active."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def world(group) -> tuple[int, int]:
    """(size, rank) of ``group`` (the default group for None); (1, 0)
    where no process group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks on every rank; its gradient
    is the sum of the ranks' gradients (each rank holds one part of one
    computation)."""
    return _AllReduceSum.apply(x, group)


def shard_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading axis, which must
    divide evenly among the ranks."""
    size, rank = world(group)
    if x.shape[0] % size:
        raise ValueError(f"a leading axis of {x.shape[0]} does not divide among {size} ranks")
    per = x.shape[0] // size
    return x[rank * per:(rank + 1) * per]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along the leading axis
    in rank order. This rank's part is ``x`` itself and keeps its autograd
    history; the others arrive as constants, so a loss that every rank
    computes alike on the result backpropagates to each rank's own rows."""
    if not dist.is_available() or not dist.is_initialized():
        return x
    size, rank = world(group)
    wire = x.detach().contiguous()
    cast = wire.dtype == torch.bool  # carried as bytes
    if cast:
        wire = wire.to(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    if cast:
        parts = [p.bool() for p in parts]
    parts[rank] = x
    return torch.cat(parts, 0)
