"""Sparse convolution layers over precomputed kernel maps.

Counterparts of ``unpack_occupancy``, ``OccupancyConv``,
``MaskedBatchNorm``, ``MaskedInstanceNorm`` and ``SparseConv`` in
``roreg_tpu/sparse/conv.py``, for inference and training. Every
``SparseConv`` goes through :func:`roreg_tpu_torch.kernels.gather_conv.gather_conv`:
the plain version for CPU tensors, the CUDA kernel for GPU tensors, and
with a gradient the kernels of its backward.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.dist.collectives import active_group, all_reduce_sum
from roreg_tpu_torch.kernels.gather_conv import gather_conv
from roreg_tpu_torch.layers import BatchNorm

__all__ = ["BN_MOMENTUM", "unpack_occupancy", "MaskedBatchNorm", "MaskedInstanceNorm", "OccupancyConv", "SparseConv"]


def _dtype(name: str | None) -> torch.dtype | None:
    return None if name is None else getattr(torch, name)


def unpack_occupancy(words: torch.Tensor, kernel_volume: int) -> torch.Tensor:
    """(M, ceil(K/32)) packed occupancy words (uint32 bits in an int32
    tensor) -> (M, K) float 0/1. Bit j of word w is kernel offset 32*w + j."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :kernel_volume].float()


def _zero_pad(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))


# running-statistics momentum of every FCGF backbone's masked batch norm
# (torch's convention; the reference's ``bn_momentum``)
BN_MOMENTUM = 0.05


def _masked_stats(
    x: torch.Tensor, mask: torch.Tensor, groups: int, process_group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance per channel over the rows where ``mask``
    holds, for each of ``groups`` equal stacks of rows: (groups, 1, C)
    each (``denom = max(sum(mask), 1)``; the mean first, then the variance
    in a second pass). With ``process_group`` each sum is taken over every
    rank's rows as well."""
    xg = x.reshape(groups, -1, x.shape[-1])
    w = mask.reshape(groups, -1, 1).to(x.dtype)
    if process_group is None:
        denom = w.sum(1, keepdim=True).clamp_min(1.0)
        mean = (xg * w).sum(1, keepdim=True) / denom
        return mean, (((xg - mean) ** 2) * w).sum(1, keepdim=True) / denom
    sums = all_reduce_sum(torch.cat([(xg * w).sum(1, keepdim=True), w.sum(1, keepdim=True)], -1), process_group)
    denom = sums[..., -1:].clamp_min(1.0)
    mean = sums[..., :-1] / denom
    return mean, all_reduce_sum((((xg - mean) ** 2) * w).sum(1, keepdim=True), process_group) / denom


def _affine(norm: nn.Module, x, mask, mean, var, groups: int) -> torch.Tensor:
    y = (x.reshape(groups, -1, x.shape[-1]) - mean) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias
    return _zero_pad(y.reshape(x.shape), mask)


class MaskedBatchNorm(BatchNorm):
    """Batch norm over the valid rows (``mask`` True; its shape is that of
    ``x`` without the last axis); pad rows come out zero (eps 1e-5).

    Eval: the running statistics. Training (the module's mode): the mean
    and biased variance over the valid rows only, pooled over every stacked
    group, and the running statistics move by torch's convention, ``(1 - m)
    * old + m * batch`` with m = ``BN_MOMENTUM``, as the reference's
    ``MaskedBatchNorm``. (``layers.BatchNorm``, the heads' norm, keeps
    flax's rule over every row.) Inside a data-parallel step
    (``dist.collectives.data_parallel``) the sums behind the statistics run
    over every rank's rows."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor, groups: int = 1) -> torch.Tensor:
        if not self.training:
            return _affine(self, x, mask, self.running_mean, self.running_var, 1)
        mean, var = _masked_stats(x, mask, 1, active_group())
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.view(-1))
            self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var.view(-1))
        return _affine(self, x, mask, mean, var, 1)


class MaskedInstanceNorm(nn.Module):
    """Instance norm over each cloud's valid rows, per channel: no running
    statistics, train and eval alike; pad rows come out zero (eps 1e-5).
    ``groups`` stacked clouds of equal capacity (a batched pyramid) are
    normalised each on its own rows."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, groups: int = 1) -> torch.Tensor:
        return _affine(self, x, mask, *_masked_stats(x, mask, groups), groups)


class OccupancyConv(nn.Module):
    """First conv over FCGF's all-ones 1-channel input: one dense
    ``(M, K) @ (K, Cout)`` product of the 0/1 occupancy with the flattened
    kernel (a plain matmul, as the reference left it to XLA). With a
    ``compute_dtype`` the kernel is rounded to it first and the product
    accumulates in f32. The kernel keeps the ``(K, 1, Cout)`` layout."""

    def __init__(self, out_channels: int, kernel_volume: int, compute_dtype: str | None = None):
        super().__init__()
        self.kernel_volume = kernel_volume
        self.compute_dtype = _dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, 1, out_channels))

    def forward(self, occ_words: torch.Tensor, out_mask: torch.Tensor) -> torch.Tensor:
        occ = unpack_occupancy(occ_words, self.kernel_volume)
        w = self.kernel.reshape(self.kernel_volume, -1)
        if self.compute_dtype is not None:
            w = w.to(self.compute_dtype)
        return _zero_pad(occ @ w.float(), out_mask)


class SparseConv(nn.Module):
    """One sparse conv over a gather table: ``(K, Cin, Cout)`` kernel, no
    bias. With ``compute_dtype`` (bf16 on the GPU) features and kernel are
    cast to it and the gather-GEMM accumulates in f32; their gradients are
    rounded to it once, where the casts' backward passes them."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_volume: int = 27,
        compute_dtype: str | None = None,
    ):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, in_channels, out_channels))

    def forward(
        self, feats: torch.Tensor, nbr: torch.Tensor, out_mask: torch.Tensor
    ) -> torch.Tensor:
        w = self.kernel
        if self.compute_dtype is not None:
            feats, w = feats.to(self.compute_dtype), w.to(self.compute_dtype)
        return _zero_pad(gather_conv(feats.contiguous(), nbr, w.contiguous()), out_mask)
