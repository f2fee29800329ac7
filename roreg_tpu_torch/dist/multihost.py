"""Multi-process execution helpers on ``torch.distributed``.

Counterpart of ``roreg_tpu/dist/multihost.py``. After :func:`initialize`
the processes form one world (gloo on the CPU, NCCL on CUDA cards); each
feeds its own work (:func:`host_local_shard`) and small per-process
metrics cross once per call (:func:`all_gather_metrics`). A single
process needs no initialization: every helper answers for a world of one.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

from roreg_tpu_torch.dist.collectives import world

__all__ = ["initialize", "is_primary", "process_count", "process_index", "host_local_shard",
           "all_gather_metrics", "default_backend", "collective_device", "primary_first"]


def default_backend() -> str:
    """NCCL where a CUDA device is present, else gloo."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> bool:
    """Join the world: from the arguments (``coordinator`` an
    ``init_method`` such as ``tcp://host:port`` or ``file:///path``), or
    from ``torchrun``'s environment (``WORLD_SIZE`` above 1). A single
    process without arguments, or a process already in a world, does
    nothing. Under NCCL each process takes the card of its ``LOCAL_RANK``
    (else its rank) as its current device. Returns whether a process group
    is initialized afterwards."""
    if dist.is_initialized():
        return True
    if coordinator is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    backend = backend or default_backend()
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=coordinator, world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
    return True


def process_count() -> int:
    return world(None)[0]


def process_index() -> int:
    return world(None)[1]


def is_primary() -> bool:
    return process_index() == 0


@contextlib.contextmanager
def primary_first():
    """The block runs on the first process, then on the others (files the
    first writes and the others read, such as synthetic scenes)."""
    several = process_count() > 1
    if several and not is_primary():
        dist.barrier()
    yield
    if several and is_primary():
        dist.barrier()


def host_local_shard(items: Sequence[Any]) -> list[Any]:
    """This process's contiguous slice of a global work list (scan pairs,
    clouds to describe, ...): ``ceil(len / processes)`` items each, the
    last process taking what remains."""
    n, i = process_count(), process_index()
    per = (len(items) + n - 1) // n
    return list(items[i * per:(i + 1) * per])


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_metrics(local: dict[str, float]) -> dict[str, list[float]]:
    """Each process's scalar metrics given to every process, as one list a
    key in process order (keys sorted; every process passes the same
    keys; values travel as f32). A process outside any world answers for
    itself; a world of one runs the collective."""
    if not dist.is_initialized():
        return {k: [v] for k, v in local.items()}
    keys = sorted(local)
    vec = torch.tensor([float(local[k]) for k in keys], dtype=torch.float32, device=collective_device())
    parts = [torch.empty_like(vec) for _ in range(process_count())]
    dist.all_gather(parts, vec)
    rows = torch.stack(parts).cpu()
    return {k: rows[:, i].tolist() for i, k in enumerate(keys)}
