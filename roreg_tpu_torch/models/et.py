"""ET: the equivariant local-transformation estimator, inference.

Counterpart of ``roreg_tpu/models/et.py`` ``EquivariantTransformer``: the
backbone and descriptor group features of a correspondence, side 0
aligned through its coarse group index, go through an SO(3) conv stack
128 -> 256 -> residual(512/256) and an MLP head on the identity element to
a residual quaternion.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.core.group import IcosahedralGroup
from roreg_tpu_torch.layers import BatchNorm
from roreg_tpu_torch.models.ops import CombConv, ResidualCombConv

__all__ = ["EquivariantTransformer", "align_by_index"]


def align_by_index(feats: torch.Tensor, idx: torch.Tensor, cayley: torch.Tensor) -> torch.Tensor:
    """out[b, g] = feats[b, cayley[idx_b, g]]."""
    perm = cayley[idx]  # (B, G)
    return torch.gather(feats, -2, perm[..., None].expand(*perm.shape, feats.shape[-1]))


class EquivariantTransformer(nn.Module):
    def __init__(
        self, group: IcosahedralGroup, in_dim: int = 32, width: int = 256,
        head_dims: tuple[int, ...] = (512, 128),
    ):
        super().__init__()
        nei = group.nei13
        self.register_buffer(
            "cayley", torch.as_tensor(group.cayley, dtype=torch.long), persistent=False
        )
        self.conv_init = CombConv(4 * in_dim, width, nei)
        self.res0 = ResidualCombConv(width, width * 2, width, nei)
        self.head_dims = tuple(head_dims)
        d_in = width
        for i, d in enumerate(self.head_dims):
            self.add_module(f"fc{i}", nn.Linear(d_in, d))
            self.add_module(f"fc_bn{i}", BatchNorm(d))
            d_in = d
        self.fc_out = nn.Linear(d_in, 4)

    def forward(
        self, before0, before1, after0, after1, idx, normalize: bool = True
    ) -> torch.Tensor:
        """(B, G, 32) x4 + (B,) group index -> (B, 4) quaternion."""
        b0 = align_by_index(before0, idx, self.cayley)
        a0 = align_by_index(after0, idx, self.cayley)
        x = torch.cat([b0, before1, a0, after1], -1)
        x = self.res0(self.conv_init(x))
        h = x[..., 0, :]
        for i in range(len(self.head_dims)):
            h = torch.relu(self._modules[f"fc_bn{i}"](self._modules[f"fc{i}"](h)))
        q = self.fc_out(h)
        if normalize:
            q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
        return q
