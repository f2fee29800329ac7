"""FCGF backbones over host-built kernel maps: the ResUNets and SimpleNets.

Counterpart of ``BasicBlock``, ``ResUNet`` and ``SimpleNet`` in
``roreg_tpu/sparse/resunet.py``: every variant of ``RESUNET_VARIANTS``
(batch norm outside the residual blocks, batch or instance norm inside)
and of ``SIMPLENET_VARIANTS``, for inference and training (the module's
``.train()`` puts every norm in training mode). Submodules carry the
reference's flax names, so ``weights.py`` maps parameters one to one. The
forward consumes a :class:`DevicePyramid`, which may stack several
rotations: a batch of B pyramids becomes one pyramid of B*capacity rows
per level, with every table entry offset by its rotation's row base, so
each conv is one kernel launch per batch (instance norms keep each
rotation's statistics apart).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from roreg_tpu_torch.sparse.conv import MaskedBatchNorm, MaskedInstanceNorm, OccupancyConv, SparseConv

__all__ = [
    "ResUNet",
    "SimpleNet",
    "BasicBlock",
    "DevicePyramid",
    "flatten_batch",
    "offset_table",
    "RESUNET_VARIANTS",
    "SIMPLENET_VARIANTS",
]

# name -> (CHANNELS[1:], TR_CHANNELS[1:], block_norm), as in the reference
# (the IN variants keep batch norm on the outer norms)
RESUNET_VARIANTS = {
    "ResUNetBN2": ([32, 64, 128, 256], [32, 64, 64, 128], "BN"),
    "ResUNetBN2B": ([32, 64, 128, 256], [64, 64, 64, 64], "BN"),
    "ResUNetBN2C": ([32, 64, 128, 256], [64, 64, 64, 128], "BN"),
    "ResUNetBN2D": ([32, 64, 128, 256], [64, 64, 128, 128], "BN"),
    "ResUNetBN2E": ([128, 128, 128, 256], [64, 128, 128, 128], "BN"),
    "ResUNetIN2": ([32, 64, 128, 256], [32, 64, 64, 128], "IN"),
    "ResUNetIN2B": ([32, 64, 128, 256], [64, 64, 64, 64], "IN"),
    "ResUNetIN2C": ([32, 64, 128, 256], [64, 64, 64, 128], "IN"),
    "ResUNetIN2D": ([32, 64, 128, 256], [64, 64, 128, 128], "IN"),
    "ResUNetIN2E": ([128, 128, 128, 256], [64, 128, 128, 128], "IN"),
}

# name -> (CHANNELS[1:], TR_CHANNELS[1:], norm, levels), as in the
# reference: no residual blocks, the norm after every conv
SIMPLENET_VARIANTS = {
    "SimpleNetBN": ([32, 64, 128], [32, 32, 64], "BN", 3),
    "SimpleNetIN": ([32, 64, 128], [32, 32, 64], "IN", 3),
    "SimpleNetBNE": ([16, 32, 32], [16, 16, 32], "BN", 3),
    "SimpleNetINE": ([16, 32, 32], [16, 16, 32], "IN", 3),
    "SimpleNetBN2": ([32, 64, 128, 256], [32, 32, 64, 64], "BN", 4),
    "SimpleNetIN2": ([32, 64, 128, 256], [32, 32, 64, 64], "IN", 4),
}


class DevicePyramid(NamedTuple):
    """Tensors of one (possibly batched) pyramid on the compute device.

    masks: per level (R_l,) bool. conv1_occ: (R_0, W) int32 occupancy words.
    same: per level (R_l, 27) rows of level l. down: l -> l+1, (R_{l+1}, 27)
    rows of level l. up: l+1 -> l, (R_l, 27) rows of level l+1. batch: the
    number of pyramids stacked (R_l = batch * capacity_l).
    """

    masks: tuple
    conv1_occ: torch.Tensor
    same: tuple
    down: tuple
    up: tuple
    batch: int = 1


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
        batch=masks[0].shape[0],
    )


def _zero_pad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _norm(kind: str, channels: int) -> nn.Module:
    """A masked norm; both are called ``norm(x, mask, groups)``."""
    if kind == "BN":
        return MaskedBatchNorm(channels)
    if kind == "IN":
        return MaskedInstanceNorm(channels)
    raise ValueError(kind)


class BasicBlock(nn.Module):
    """Pre-norm residual block (BasicBlockBN / BasicBlockIN):
    conv-norm-ReLU-conv-norm + x."""

    def __init__(self, channels: int, compute_dtype: str | None = None, norm: str = "BN"):
        super().__init__()
        self.conv1 = SparseConv(channels, channels, 27, compute_dtype)
        self.norm1 = _norm(norm, channels)
        self.conv2 = SparseConv(channels, channels, 27, compute_dtype)
        self.norm2 = _norm(norm, channels)

    def forward(self, x, nbr, mask, batch: int = 1):
        y = self.norm1(self.conv1(x, nbr, mask), mask, batch)
        y = self.norm2(self.conv2(torch.relu(y), nbr, mask), mask, batch)
        return _zero_pad(torch.relu(y + x), mask)


class ResUNet(nn.Module):
    """4-level sparse ResUNet; ``variant`` selects the FCGF channel plan and
    the residual blocks' norm. 20 gather convs: 11 in the encoder, 9 in the
    decoder."""

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
            raise ValueError(f"unknown ResUNet variant {variant!r}")
        ch, tr, blk = RESUNET_VARIANTS[variant]
        cd = compute_dtype
        self.normalize_feature = normalize_feature
        self.conv1 = OccupancyConv(ch[0], conv1_kernel_size**3, cd)
        self.norm1 = MaskedBatchNorm(ch[0])
        self.block1 = BasicBlock(ch[0], cd, blk)
        self.conv2 = SparseConv(ch[0], ch[1], 27, cd)
        self.norm2 = MaskedBatchNorm(ch[1])
        self.block2 = BasicBlock(ch[1], cd, blk)
        self.conv3 = SparseConv(ch[1], ch[2], 27, cd)
        self.norm3 = MaskedBatchNorm(ch[2])
        self.block3 = BasicBlock(ch[2], cd, blk)
        self.conv4 = SparseConv(ch[2], ch[3], 27, cd)
        self.norm4 = MaskedBatchNorm(ch[3])
        self.block4 = BasicBlock(ch[3], cd, blk)

        self.conv4_tr = SparseConv(ch[3], tr[3], 27, cd)
        self.norm4_tr = MaskedBatchNorm(tr[3])
        self.block4_tr = BasicBlock(tr[3], cd, blk)
        self.conv3_tr = SparseConv(tr[3] + ch[2], tr[2], 27, cd)
        self.norm3_tr = MaskedBatchNorm(tr[2])
        self.block3_tr = BasicBlock(tr[2], cd, blk)
        self.conv2_tr = SparseConv(tr[2] + ch[1], tr[1], 27, cd)
        self.norm2_tr = MaskedBatchNorm(tr[1])
        self.block2_tr = BasicBlock(tr[1], cd, blk)
        # kernel-1 convs are plain dense layers
        self.conv1_tr = nn.Linear(tr[1] + ch[0], tr[0], bias=False)
        self.final = nn.Linear(tr[0], out_channels, bias=True)

    def forward(self, pyr: DevicePyramid) -> torch.Tensor:
        """-> (R_0, out_channels) level-0 features, zero on pad rows. In
        training mode every norm takes batch statistics and updates its
        running statistics."""
        m, b = pyr.masks, pyr.batch

        def enc(l, conv, norm, block, x, tbl):
            x = norm(conv(x, tbl, m[l]), m[l], b)
            return block(x, pyr.same[l], m[l], b)

        x = self.norm1(self.conv1(pyr.conv1_occ, m[0]), m[0], b)
        out_s1 = self.block1(x, pyr.same[0], m[0], b)
        out_s2 = enc(1, self.conv2, self.norm2, self.block2, torch.relu(out_s1), pyr.down[0])
        out_s4 = enc(2, self.conv3, self.norm3, self.block3, torch.relu(out_s2), pyr.down[1])
        out_s8 = enc(3, self.conv4, self.norm4, self.block4, torch.relu(out_s4), pyr.down[2])

        x = torch.relu(enc(2, self.conv4_tr, self.norm4_tr, self.block4_tr, torch.relu(out_s8), pyr.up[2]))
        x = torch.cat([x, out_s4], -1)
        x = torch.relu(enc(1, self.conv3_tr, self.norm3_tr, self.block3_tr, x, pyr.up[1]))
        x = torch.cat([x, out_s2], -1)
        x = torch.relu(enc(0, self.conv2_tr, self.norm2_tr, self.block2_tr, x, pyr.up[0]))

        x = torch.cat([x, out_s1], -1)
        x = torch.relu(self.conv1_tr(x))
        return _normalize(self.final(x), self.normalize_feature, m[0])


def _normalize(x: torch.Tensor, normalize: bool, mask: torch.Tensor) -> torch.Tensor:
    if normalize:
        x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    return _zero_pad(x, mask)


class SimpleNet(nn.Module):
    """FCGF SimpleNet family: a plain 3- or 4-level UNet (no residual
    blocks) whose norm (``variant``'s BN or IN) follows every conv,
    conv1 included, with skip concatenations taken before the ReLU. Uses
    the first ``levels`` levels of the pyramid. 2 * levels - 1 gather convs
    (conv1 is the occupancy product)."""

    def __init__(
        self,
        variant: str = "SimpleNetBN",
        out_channels: int = 32,
        conv1_kernel_size: int = 7,
        normalize_feature: bool = True,
        compute_dtype: str | None = None,
    ):
        super().__init__()
        if variant not in SIMPLENET_VARIANTS:
            raise ValueError(f"unknown SimpleNet variant {variant!r}")
        ch, tr, norm, nlev = SIMPLENET_VARIANTS[variant]
        cd = compute_dtype
        self.levels = nlev
        self.normalize_feature = normalize_feature
        self.conv1 = OccupancyConv(ch[0], conv1_kernel_size**3, cd)
        self.norm1 = _norm(norm, ch[0])
        for l in range(1, nlev):
            self.add_module(f"conv{l + 1}", SparseConv(ch[l - 1], ch[l], 27, cd))
            self.add_module(f"norm{l + 1}", _norm(norm, ch[l]))
        for l in range(nlev - 1, 0, -1):
            cin = ch[l] if l == nlev - 1 else tr[l + 1] + ch[l]
            self.add_module(f"conv{l + 1}_tr", SparseConv(cin, tr[l], 27, cd))
            self.add_module(f"norm{l + 1}_tr", _norm(norm, tr[l]))
        self.conv1_tr = SparseConv(tr[1] + ch[0], tr[0], 27, cd)
        self.norm1_tr = _norm(norm, tr[0])
        self.final = nn.Linear(tr[0], out_channels, bias=True)

    def forward(self, pyr: DevicePyramid) -> torch.Tensor:
        m, b = pyr.masks, pyr.batch
        mod = self._modules

        def norm(name, x, mask):
            return mod[name](x, mask, b)

        x = norm("norm1", self.conv1(pyr.conv1_occ, m[0]), m[0])
        skips = [x]
        x = torch.relu(x)
        for l in range(1, self.levels):
            x = norm(f"norm{l + 1}", mod[f"conv{l + 1}"](x, pyr.down[l - 1], m[l]), m[l])
            skips.append(x)
            x = torch.relu(x)
        for l in range(self.levels - 1, 0, -1):
            x = norm(f"norm{l + 1}_tr", mod[f"conv{l + 1}_tr"](x, pyr.up[l - 1], m[l - 1]), m[l - 1])
            x = torch.cat([torch.relu(x), skips[l - 1]], -1)
        x = torch.relu(norm("norm1_tr", self.conv1_tr(x, pyr.same[0], m[0]), m[0]))
        return _normalize(self.final(x), self.normalize_feature, m[0])
