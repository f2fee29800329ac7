"""RD: the rotation-guided keypoint detector, inference.

Counterpart of ``roreg_tpu/models/rd.py`` ``RotationDetector``: an SO(3)
residual conv 32 -> 64 -> 16, channel L2 norm, then the unbiased std of
the G self-correlations as the saliency score.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.core.group import IcosahedralGroup
from roreg_tpu_torch.models.ops import ResidualCombConv, group_correlation

__all__ = ["RotationDetector"]


class RotationDetector(nn.Module):
    def __init__(self, group: IcosahedralGroup, in_dim: int = 32, mid_dim: int = 64, out_dim: int = 16):
        super().__init__()
        self.enc = ResidualCombConv(in_dim, mid_dim, out_dim, group.nei13)
        self.register_buffer(
            "cayley", torch.as_tensor(group.cayley, dtype=torch.long), persistent=False
        )

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, G, 32) group features -> (B,) saliency scores."""
        x = self.enc(feats)
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        cor = group_correlation(x, x, self.cayley)
        return cor.std(-1, unbiased=True)
