"""Sparse convolution layers over precomputed kernel maps (inference).

Counterparts of ``unpack_occupancy``, ``OccupancyConv``,
``MaskedBatchNorm`` and ``SparseConv`` in ``roreg_tpu/sparse/conv.py``.
Every ``SparseConv`` goes through :func:`roreg_tpu_torch.kernels.gather_conv.gather_conv`:
the plain version for CPU tensors, the CUDA kernel for GPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.kernels.gather_conv import gather_conv
from roreg_tpu_torch.layers import BatchNorm

__all__ = ["unpack_occupancy", "MaskedBatchNorm", "OccupancyConv", "SparseConv"]


def _dtype(name: str | None) -> torch.dtype | None:
    return None if name is None else getattr(torch, name)


def unpack_occupancy(words: torch.Tensor, kernel_volume: int) -> torch.Tensor:
    """(M, ceil(K/32)) packed occupancy words (uint32 bits in an int32
    tensor) -> (M, K) float 0/1. Bit j of word w is kernel offset 32*w + j."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :kernel_volume].float()


class MaskedBatchNorm(BatchNorm):
    """Batch norm with running statistics over the last axis; pad rows
    (``mask`` False, the shape of ``x`` without its last axis) are zeroed
    (eps 1e-5)."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))


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
        y = occ @ w.float()
        return torch.where(out_mask[:, None], y, torch.zeros((), device=y.device))


class SparseConv(nn.Module):
    """One sparse conv over a gather table: ``(K, Cin, Cout)`` kernel, no
    bias. With ``compute_dtype`` (bf16 on the GPU) features and kernel are
    cast to it and the gather-GEMM accumulates in f32."""

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
        y = gather_conv(feats.contiguous(), nbr, w.contiguous())
        return torch.where(out_mask[:, None], y, torch.zeros((), device=y.device))
