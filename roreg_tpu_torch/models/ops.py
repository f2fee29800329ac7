"""SO(3) group-convolution primitives, channels last: features (B, G, C).

Counterparts of ``roreg_tpu/models/ops.py``. A group conv gathers each
element's K neighbours on the G axis and contracts them with one
``(K*C_in, C_out)`` matrix, held as an ``nn.Linear``. Batch norm is
applied before the gather, as in the reference. Inference only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from roreg_tpu_torch.layers import BatchNorm

__all__ = ["so3_gather", "GroupConv", "CombConv", "ResidualCombConv", "group_correlation"]


def so3_gather(x: torch.Tensor, nei: torch.Tensor) -> torch.Tensor:
    """(…, G, C), (G, K) long -> (…, G, K, C) neighbourhood gather on the G
    axis."""
    return x[..., nei, :]


class GroupConv(nn.Linear):
    """Gather K group neighbours, then one linear map of the (K*C_in) row.
    ``weight`` is (C_out, K*C_in): the reference's kernel transposed."""

    def __init__(self, in_dim: int, out_dim: int, nei: np.ndarray):
        k = nei.shape[1]
        super().__init__(k * in_dim, out_dim, bias=True)
        self.register_buffer("nei", torch.as_tensor(np.asarray(nei), dtype=torch.long), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = so3_gather(x, self.nei)  # (..., G, K, C)
        return super().forward(h.reshape(h.shape[:-2] + (-1,)))


class CombConv(nn.Module):
    """BN -> ReLU -> group conv (reference Comb_Conv)."""

    def __init__(self, in_dim: int, out_dim: int, nei: np.ndarray):
        super().__init__()
        self.bn = BatchNorm(in_dim)
        self.conv = GroupConv(in_dim, out_dim, nei)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.bn(x)))


class ResidualCombConv(nn.Module):
    """Pre-activation residual SO(3) conv (Residual_Comb_Conv). Its
    submodules keep the reference's names ``in``, ``out``, ``short_cut``."""

    def __init__(self, in_dim: int, mid_dim: int, out_dim: int, nei: np.ndarray):
        super().__init__()
        self.add_module("in", CombConv(in_dim, mid_dim, nei))
        self.add_module("out", CombConv(mid_dim, out_dim, nei))
        if in_dim != out_dim:
            self.add_module("short_cut", CombConv(in_dim, out_dim, nei))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._modules["out"](self._modules["in"](x))
        sc = self._modules.get("short_cut")
        return h + (sc(x) if sc is not None else x)


def group_correlation(
    permuted: torch.Tensor, fixed: torch.Tensor, cayley: torch.Tensor
) -> torch.Tensor:
    """cor[…, a] = sum_{g,c} permuted[…, cayley[a, g], c] * fixed[…, g, c],
    through the (…, G, G) gram matrix so the (…, A, G, C) gather is never
    formed. ``cayley`` is an (A, G) long tensor on the features' device."""
    S = torch.einsum("...gc,...hc->...gh", fixed, permuted)
    g = torch.arange(cayley.shape[1], device=S.device)
    return S[..., g[None, :], cayley].sum(-1)
