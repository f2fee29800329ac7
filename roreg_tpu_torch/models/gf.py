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
from roreg_tpu_torch.models.ops import CombConv, GroupConv, ResidualCombConv, group_correlation

__all__ = ["GroupFeatNetwork", "des_to_dr_index", "GFOutput"]


def des_to_dr_index(eqv0: torch.Tensor, eqv1: torch.Tensor, cayley: torch.Tensor) -> torch.Tensor:
    """argmax_a sum_g <eqv0[cayley[a, g]], eqv1[g]>: the predicted group
    index a such that cloud1 ~ R_a · cloud0 (the Des2DR correlation).
    ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    return group_correlation(eqv0, eqv1, cayley).argmax(-1)


# the network's output: {"eqv": (B, G, C), "inv": (B, C)}
GFOutput = dict


class GroupFeatNetwork(nn.Module):
    def __init__(self, group: IcosahedralGroup, channels: int = 32, width: int = 256):
        super().__init__()
        nei = group.nei13
        self.conv_in = GroupConv(channels, width, nei)
        self.res0 = ResidualCombConv(width, width * 2, width, nei)
        self.conv_out = CombConv(width, channels, nei)

    def forward(self, feats: torch.Tensor) -> GFOutput:
        x = self.conv_out(self.res0(self.conv_in(feats)))
        eqv = x + feats
        inv = eqv.mean(-2)
        eqv = eqv / torch.linalg.norm(eqv, dim=-1, keepdim=True).clamp_min(1e-4)
        inv = inv / torch.linalg.norm(inv, dim=-1, keepdim=True).clamp_min(1e-4)
        return {"eqv": eqv, "inv": inv}
