"""Normalisation layer shared by the backbone and the group-conv heads."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BatchNorm"]


class BatchNorm(nn.Module):
    """Inference batch norm over the last axis with running statistics:
    ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.

    Counterpart of flax ``nn.BatchNorm`` and the reference's
    ``MaskedBatchNorm`` with ``use_running_average=True``; this slice runs
    inference only, so batch statistics are never taken.
    """

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps
        ) * self.weight + self.bias
