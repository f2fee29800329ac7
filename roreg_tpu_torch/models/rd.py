"""RD: the rotation-guided keypoint detector.

Counterparts of ``roreg_tpu/models/rd.py``: ``RotationDetector``, an SO(3)
residual conv 32 -> 64 -> 16, channel L2 norm, then the unbiased std of
the G self-correlations as the saliency score; and the legacy
``RotationDetectorFormer``, an SO(3) residual conv 32 -> 64 -> 1 whose G
values feed a sigmoid MLP G -> 32 -> 1 with a batch norm (flax's rule,
``layers.BatchNorm``). Batch norms follow the module's train/eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.core.group import IcosahedralGroup
from roreg_tpu_torch.layers import BatchNorm
from roreg_tpu_torch.models.ops import ResidualCombConv, group_correlation

__all__ = ["RotationDetector", "RotationDetectorFormer"]


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


class RotationDetectorFormer(nn.Module):
    """The reference's shipped ``RD_former`` detector: (B, G, 32) group
    features -> (B,) sigmoid saliency scores."""

    def __init__(self, group: IcosahedralGroup, in_dim: int = 32, mid_dim: int = 64):
        super().__init__()
        g = group.cayley.shape[0]
        self.enc = ResidualCombConv(in_dim, mid_dim, 1, group.nei13)
        self.score0 = nn.Linear(g, 32)
        self.score_bn = BatchNorm(32)
        self.score1 = nn.Linear(32, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.enc(feats)[..., 0]  # (B, G): one channel per group element
        h = torch.relu(self.score_bn(self.score0(x)))
        return torch.sigmoid(self.score1(h)[..., 0])
