"""GF: the group-feature (RoReg-Desc) network, inference.

Counterpart of ``roreg_tpu/models/gf.py`` ``GroupFeatNetwork``: an SO(3)
conv stack 32 -> 256 -> residual(512/256) -> 32 with an input residual;
returns the channel-normalised equivariant descriptor ``eqv`` (B, G, 32)
and the group-mean invariant ``inv`` (B, 32).
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.core.group import IcosahedralGroup
from roreg_tpu_torch.models.ops import CombConv, GroupConv, ResidualCombConv

__all__ = ["GroupFeatNetwork"]


class GroupFeatNetwork(nn.Module):
    def __init__(self, group: IcosahedralGroup, channels: int = 32, width: int = 256):
        super().__init__()
        nei = group.nei13
        self.conv_in = GroupConv(channels, width, nei)
        self.res0 = ResidualCombConv(width, width * 2, width, nei)
        self.conv_out = CombConv(width, channels, nei)

    def forward(self, feats: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.conv_out(self.res0(self.conv_in(feats)))
        eqv = x + feats
        inv = eqv.mean(-2)
        eqv = eqv / torch.linalg.norm(eqv, dim=-1, keepdim=True).clamp_min(1e-4)
        inv = inv / torch.linalg.norm(inv, dim=-1, keepdim=True).clamp_min(1e-4)
        return {"eqv": eqv, "inv": inv}
