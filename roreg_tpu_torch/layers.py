"""Normalisation layer shared by the backbone and the group-conv heads."""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.dist.collectives import active_group, all_reduce_sum

__all__ = ["BatchNorm"]


class BatchNorm(nn.Module):
    """Batch norm over the last axis, flax ``nn.BatchNorm``'s rule
    (momentum 0.9, epsilon 1e-5).

    In eval mode (inference): ``(x - running_mean) * rsqrt(running_var +
    eps) * weight + bias``, as flax with ``use_running_average=True`` and
    the reference's ``MaskedBatchNorm`` at test time.

    In training mode: normalise with the batch statistics over every axis
    but the last, the mean and the **biased** variance, computed as flax
    computes them (``E[x^2] - E[x]^2``, clipped at 0), and update
    ``running = 0.9 * running + 0.1 * batch`` for both, with that biased
    variance. (``torch.nn.BatchNorm*`` updates ``running_var`` with the
    unbiased variance, which flax does not.) Inside a data-parallel step
    (``dist.collectives.data_parallel``) the sums behind both statistics
    are taken over every rank's rows, so that each rank normalises with the
    whole batch's statistics, as one process on the whole batch does.
    """

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (x - self.running_mean) * torch.rsqrt(
                self.running_var + self.eps
            ) * self.weight + self.bias
        axes = tuple(range(x.dim() - 1))
        group = active_group()
        if group is None:
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
        else:
            count = x.new_full((x.shape[-1],), x.numel() // x.shape[-1])
            s = all_reduce_sum(torch.stack([x.sum(axes), (x * x).sum(axes), count]), group)
            mean = s[0] / s[2]
            var = (s[1] / s[2] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
