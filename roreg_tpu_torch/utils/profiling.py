"""Observability: per-stage wall-clock accounting and JSONL metric logs.

Counterpart of ``roreg_tpu/utils/profiling.py``: :class:`StageTimer` waits
for the device with ``torch.cuda.synchronize`` where the JAX one calls
``jax.block_until_ready`` (kernel launches return before the device has
finished), and :class:`JsonlLogger` is a copy.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["StageTimer", "JsonlLogger"]


def _wait(value) -> None:
    """Wait until the device has computed every CUDA tensor in ``value``
    (a tensor, or a tuple, list or dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _wait(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _wait(v)


class StageTimer:
    """Accumulates wall time per named stage; waits for the device when
    given a value to wait on (otherwise asynchronous launches hide the
    cost)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def block(self, name: str, value):
        """Time the wait for the device's ``value`` under ``name``."""
        t0 = time.perf_counter()
        _wait(value)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return value

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in self.totals
        }


class JsonlLogger:
    """Append-only JSONL metrics file (the tensorboardX Recorder analog,
    utils/utils.py:164-215)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict):
        rec = {"ts": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
