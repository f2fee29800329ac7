"""Data-parallel training over a world of processes.

Counterpart of ``roreg_tpu/dist/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` and lets XLA's SPMD partitioner run the global-batch
step over it; here a :class:`Mesh` names the ``torch.distributed`` group
(one process a device: gloo on the CPU, NCCL on the cards), and
:func:`shard_train_step` runs a head's step so that it gives what one
process gives on the whole batch:

* every rank holds the whole batch (its data iterator is seeded alike);
  the trained network's forward takes this rank's contiguous shard of
  each batch-shaped input and hands back every rank's outputs in order,
  this rank's keeping their gradient (``collectives.gather_rows``);
* the batch norms inside take their statistics over all ranks' rows
  (``collectives.data_parallel``);
* so every rank computes the same global loss, and backpropagates it to
  its own rows; the optimizer then steps on the sum of the ranks'
  gradients, which is the whole batch's gradient (a sum, not a mean:
  each rank's gradient is one part of the one loss, since GF's loss
  couples all pairs of a batch through its in-batch negatives).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from roreg_tpu_torch.device import resolve_device
from roreg_tpu_torch.dist.collectives import data_parallel, gather_rows, shard_rows, world
from roreg_tpu_torch.dist.multihost import collective_device

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch", "shard_train_step"]


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh over the default process group (or this process
    alone): its size, this process's rank in it, and the device this
    process computes on."""

    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialized world (``multihost.initialize``), or of
    this process alone. ``n_devices`` must equal the world's size (a world
    of n is started with ``torchrun --nproc_per_node n``). ``device``: the
    collectives' device (the process's card under NCCL, else the CPU)
    unless given; a single process computes on CUDA unless told ``cpu``."""
    size, rank = world(None)
    n = n_devices or size
    if n != size:
        raise ValueError(f"a mesh of {n} devices needs a torch.distributed world of {n} processes "
                         f"(torchrun --nproc_per_node {n}); this process is in a world of {size}")
    if device is None:
        dev = collective_device() if dist.is_initialized() else resolve_device(None)
    else:
        dev = resolve_device(device)
    return Mesh(size=size, rank=rank, device=dev)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Rank 0's values on every rank: a module's parameters and buffers are
    overwritten in place (and the module returned), tensors in a pytree
    come back as copies on ``mesh.device``."""
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            if mesh.size > 1:
                with torch.no_grad():
                    dist.broadcast(t.data, src=0)
        return tree

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.detach().to(mesh.device).clone()
        if mesh.size > 1:
            dist.broadcast(y, src=0)
        return y

    return _map(put, tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's contiguous slice of every array's and tensor's leading
    axis (which must divide among the ranks); scalars as they are."""
    def cut(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            return shard_rows(x, None)
        if isinstance(x, np.ndarray) and x.ndim >= 1:
            if x.shape[0] % mesh.size:
                raise ValueError(f"a leading axis of {x.shape[0]} does not divide among {mesh.size} ranks")
            per = x.shape[0] // mesh.size
            return x[mesh.rank * per:(mesh.rank + 1) * per]
        return x

    return _map(cut, batch)


@contextlib.contextmanager
def _sharded_forward(net: nn.Module, mesh: Mesh):
    """While active, ``net``'s forward takes this rank's shard of its tensor
    arguments and returns every rank's tensor outputs gathered in rank
    order. Every tensor argument must lead with the batch axis, and every
    tensor output with the shard's: a forward that takes or returns any
    other tensor raises, since cutting or gathering it would be wrong."""
    shard = []

    def pre(module, args, kwargs):
        tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
        rows = tensors[0].shape[0] if tensors and tensors[0].dim() else None
        if rows is None or any(t.dim() == 0 or t.shape[0] != rows for t in tensors):
            raise ValueError(f"a sharded forward takes tensors that all lead with the batch axis; got shapes "
                             f"{[tuple(t.shape) for t in tensors]}")
        cut = lambda a: shard_rows(a, None) if isinstance(a, torch.Tensor) else a  # noqa: E731
        args, kwargs = tuple(cut(a) for a in args), {k: cut(v) for k, v in kwargs.items()}
        shard[:] = [rows // mesh.size]
        return args, kwargs

    def post(module, args, kwargs, out):
        def gather(t):
            if not isinstance(t, torch.Tensor):
                return t
            if t.dim() == 0 or t.shape[0] != shard[0]:
                raise ValueError(f"a sharded forward returns tensors that lead with the shard's {shard[0]} "
                                 f"rows; got shape {tuple(t.shape)}")
            return gather_rows(t, None)

        return _map(gather, out)

    handles = [net.register_forward_pre_hook(pre, with_kwargs=True),
               net.register_forward_hook(post, with_kwargs=True)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _summed_gradients(optimizer: torch.optim.Optimizer, mesh: Mesh):
    """While active, each optimizer step first sums every parameter's
    gradient over the ranks (in one fixed order on every rank)."""
    def pre(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    dist.all_reduce(p.grad, op=dist.ReduceOp.SUM)

    handle = optimizer.register_step_pre_hook(pre)
    try:
        yield
    finally:
        handle.remove()


def shard_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a head's ``(state, batch) -> metrics`` step (``train.trainer``:
    ``state.net`` and ``state.optimizer``) for the mesh, as the module
    docstring says: each rank runs the network on its shard of the whole
    batch it is given, and the update equals the single-process update on
    that batch. A process outside any world runs the step as it is; a
    world of one runs its collectives too."""
    if not dist.is_initialized():
        return step_fn

    @functools.wraps(step_fn)
    def wrapped(state, batch):
        with data_parallel(dist.group.WORLD), \
                _sharded_forward(state.net, mesh), _summed_gradients(state.optimizer, mesh):
            return step_fn(state, batch)

    return wrapped
