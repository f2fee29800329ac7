"""FCGF ResUNet backbone over host-built kernel maps (inference).

Counterpart of ``BasicBlock`` and ``ResUNet`` in
``roreg_tpu/sparse/resunet.py`` for the BN variants of
``RESUNET_VARIANTS``. Submodules carry the reference's flax names, so
``weights.py`` maps parameters one to one. The forward consumes a
:class:`DevicePyramid`, which may stack several rotations: a batch of B
pyramids becomes one pyramid of B*capacity rows per level, with every
table entry offset by its rotation's row base, so each conv is one kernel
launch per batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from roreg_tpu_torch.sparse.conv import MaskedBatchNorm, OccupancyConv, SparseConv

__all__ = [
    "ResUNet",
    "BasicBlock",
    "DevicePyramid",
    "flatten_batch",
    "offset_table",
    "RESUNET_VARIANTS",
]

# name -> (CHANNELS[1:], TR_CHANNELS[1:], block_norm), as in the reference
RESUNET_VARIANTS = {
    "ResUNetBN2": ([32, 64, 128, 256], [32, 64, 64, 128], "BN"),
    "ResUNetBN2B": ([32, 64, 128, 256], [64, 64, 64, 64], "BN"),
    "ResUNetBN2C": ([32, 64, 128, 256], [64, 64, 64, 128], "BN"),
    "ResUNetBN2D": ([32, 64, 128, 256], [64, 64, 128, 128], "BN"),
    "ResUNetBN2E": ([128, 128, 128, 256], [64, 128, 128, 128], "BN"),
}


class DevicePyramid(NamedTuple):
    """Tensors of one (possibly batched) pyramid on the compute device.

    masks: per level (R_l,) bool. conv1_occ: (R_0, W) int32 occupancy words.
    same: per level (R_l, 27) rows of level l. down: l -> l+1, (R_{l+1}, 27)
    rows of level l. up: l+1 -> l, (R_l, 27) rows of level l+1.
    """

    masks: tuple
    conv1_occ: torch.Tensor
    same: tuple
    down: tuple
    up: tuple


def offset_table(tbl: torch.Tensor, n_src: int) -> torch.Tensor:
    """(B, M, K) tables -> (B*M, K) int32 with batch b's entries + b*n_src."""
    b = tbl.shape[0]
    t = tbl.to(torch.int32)
    base = (torch.arange(b, device=t.device, dtype=torch.int32) * n_src).view(b, 1, 1)
    t = torch.where(t >= 0, t + base, torch.full((), -1, dtype=torch.int32, device=t.device))
    return t.reshape(-1, t.shape[-1])


def flatten_batch(masks, conv1_occ, same, down, up) -> DevicePyramid:
    """Stack B pyramids (every tensor with a leading axis B) into one."""
    caps = [m.shape[1] for m in masks]
    return DevicePyramid(
        masks=tuple(m.reshape(-1) for m in masks),
        conv1_occ=conv1_occ.reshape(-1, conv1_occ.shape[-1]),
        same=tuple(offset_table(t, caps[l]) for l, t in enumerate(same)),
        down=tuple(offset_table(t, caps[l]) for l, t in enumerate(down)),
        up=tuple(offset_table(t, caps[l + 1]) for l, t in enumerate(up)),
    )


def _zero_pad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class BasicBlock(nn.Module):
    """Pre-norm residual block (BasicBlockBN): conv-BN-ReLU-conv-BN + x."""

    def __init__(self, channels: int, compute_dtype: str | None = None):
        super().__init__()
        self.conv1 = SparseConv(channels, channels, 27, compute_dtype)
        self.norm1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv(channels, channels, 27, compute_dtype)
        self.norm2 = MaskedBatchNorm(channels)

    def forward(self, x, nbr, mask):
        y = torch.relu(self.norm1(self.conv1(x, nbr, mask), mask))
        y = self.norm2(self.conv2(y, nbr, mask), mask)
        return _zero_pad(torch.relu(y + x), mask)


class ResUNet(nn.Module):
    """4-level sparse ResUNet; ``variant`` selects the FCGF channel plan.
    20 gather convs: 11 in the encoder, 9 in the decoder."""

    def __init__(
        self,
        variant: str = "ResUNetBN2C",
        out_channels: int = 32,
        conv1_kernel_size: int = 7,
        normalize_feature: bool = True,
        compute_dtype: str | None = None,
    ):
        super().__init__()
        if variant not in RESUNET_VARIANTS:
            raise NotImplementedError(
                f"backbone {variant!r} is not ported (ROADMAP.md queue A, item A8)"
            )
        ch, tr, _ = RESUNET_VARIANTS[variant]
        cd = compute_dtype
        self.normalize_feature = normalize_feature
        self.conv1 = OccupancyConv(ch[0], conv1_kernel_size**3, cd)
        self.norm1 = MaskedBatchNorm(ch[0])
        self.block1 = BasicBlock(ch[0], cd)
        self.conv2 = SparseConv(ch[0], ch[1], 27, cd)
        self.norm2 = MaskedBatchNorm(ch[1])
        self.block2 = BasicBlock(ch[1], cd)
        self.conv3 = SparseConv(ch[1], ch[2], 27, cd)
        self.norm3 = MaskedBatchNorm(ch[2])
        self.block3 = BasicBlock(ch[2], cd)
        self.conv4 = SparseConv(ch[2], ch[3], 27, cd)
        self.norm4 = MaskedBatchNorm(ch[3])
        self.block4 = BasicBlock(ch[3], cd)

        self.conv4_tr = SparseConv(ch[3], tr[3], 27, cd)
        self.norm4_tr = MaskedBatchNorm(tr[3])
        self.block4_tr = BasicBlock(tr[3], cd)
        self.conv3_tr = SparseConv(tr[3] + ch[2], tr[2], 27, cd)
        self.norm3_tr = MaskedBatchNorm(tr[2])
        self.block3_tr = BasicBlock(tr[2], cd)
        self.conv2_tr = SparseConv(tr[2] + ch[1], tr[1], 27, cd)
        self.norm2_tr = MaskedBatchNorm(tr[1])
        self.block2_tr = BasicBlock(tr[1], cd)
        # kernel-1 convs are plain dense layers
        self.conv1_tr = nn.Linear(tr[1] + ch[0], tr[0], bias=False)
        self.final = nn.Linear(tr[0], out_channels, bias=True)

    def forward(self, pyr: DevicePyramid) -> torch.Tensor:
        """-> (R_0, out_channels) level-0 features, zero on pad rows."""
        m = pyr.masks
        x = self.norm1(self.conv1(pyr.conv1_occ, m[0]), m[0])
        out_s1 = self.block1(x, pyr.same[0], m[0])
        x = torch.relu(out_s1)

        x = self.norm2(self.conv2(x, pyr.down[0], m[1]), m[1])
        out_s2 = self.block2(x, pyr.same[1], m[1])
        x = torch.relu(out_s2)

        x = self.norm3(self.conv3(x, pyr.down[1], m[2]), m[2])
        out_s4 = self.block3(x, pyr.same[2], m[2])
        x = torch.relu(out_s4)

        x = self.norm4(self.conv4(x, pyr.down[2], m[3]), m[3])
        out_s8 = self.block4(x, pyr.same[3], m[3])
        x = torch.relu(out_s8)

        x = self.norm4_tr(self.conv4_tr(x, pyr.up[2], m[2]), m[2])
        x = torch.relu(self.block4_tr(x, pyr.same[2], m[2]))

        x = torch.cat([x, out_s4], -1)
        x = self.norm3_tr(self.conv3_tr(x, pyr.up[1], m[1]), m[1])
        x = torch.relu(self.block3_tr(x, pyr.same[1], m[1]))

        x = torch.cat([x, out_s2], -1)
        x = self.norm2_tr(self.conv2_tr(x, pyr.up[0], m[0]), m[0])
        x = torch.relu(self.block2_tr(x, pyr.same[0], m[0]))

        x = torch.cat([x, out_s1], -1)
        x = torch.relu(self.conv1_tr(x))
        x = self.final(x)
        if self.normalize_feature:
            x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        return _zero_pad(x, m[0])
