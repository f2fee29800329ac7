"""Block-dense sparse convolution engine (inference): the JAX default
describe's backbone.

Counterpart of ``roreg_tpu/sparse/block.py``. Each level's voxels are
grouped into 4x4x4-cell blocks whose features are stored dense,
``(B, 64, C)`` with cell id ``cx*16 + cy*4 + cz``; (B, 27) block tables in
hypercube order (dx slowest) give each block's neighbours. The four conv
types:

* same-level 3^3 (``conv_same``) and stride-2 (``conv_down``): a gather of
  each output block's span^3 halo and a dense 3^3 conv over it, both in the
  hand-written Hopper kernel of ``kernels/halo_conv.py`` on the GPU;
* transposed (``conv_up``): a gather of the 27 coarse cells of each fine
  block's 3^3 region (``kernels/block_gather.py``), then its 8 parity-class
  products, permutation and mask in ``kernels/up_conv.py``;
* the first 7^3 conv over FCGF's all-ones input (``conv1_occupancy``): a
  gather of the neighbour blocks' occupancy (``block_gather``), then one
  GEMM with the folded (27*64, 64*Cout) weight in ``torch.matmul``.

Every conv returns f32 (B, 64, Cout), zero at unoccupied cells; features
and weights are cast to ``compute_dtype`` where the JAX code casts them, and
the matmuls take bf16 operands into f32 products (the JAX package's
``preferred_element_type=jnp.float32``). The decoder's first two skip
concatenations write the bf16 input of the up conv that follows
(``kernels/skip_concat.py``) when that conv computes in bf16, and the
per-cell dense layers ``conv1_tr`` and ``final`` run in f32 through
``kernels/cell_dense.py``, ``conv1_tr`` reading its two inputs as two
K-slices in place of their concatenation; both take the level-0 cell mask
and compute only the rows of occupied cells, zeros elsewhere, which the
final mask of the output makes the same function.

:class:`BlockResUNet` has exactly the parameter names of
:class:`roreg_tpu_torch.sparse.resunet.ResUNet`, so one set of converted
variables drives both engines. A rotation chunk runs as one batch: the
chunk's tables are offset by each rotation's row base (-1 kept) and the
features of all its rotations are stacked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from roreg_tpu_torch.kernels.block_gather import block_gather
from roreg_tpu_torch.kernels.cell_dense import cell_dense
from roreg_tpu_torch.kernels.halo_conv import BLOCK, CELLS, halo_conv
from roreg_tpu_torch.kernels.halo_conv import halo_maps as _halo_maps
from roreg_tpu_torch.kernels.skip_concat import skip_concat
from roreg_tpu_torch.kernels.up_conv import up_conv
from roreg_tpu_torch.sparse.conv import MaskedBatchNorm, _dtype
from roreg_tpu_torch.sparse.resunet import RESUNET_VARIANTS, offset_table

__all__ = [
    "BLOCK",
    "CELLS",
    "BlockLevelDev",
    "BlockPyramidDev",
    "unpack_block_payload",
    "unpack_cell_occupancy",
    "flatten_block_batch",
    "conv1_occupancy",
    "conv_same",
    "conv_down",
    "conv_up",
    "BlockResUNet",
]


class BlockLevelDev(NamedTuple):
    """One level's block structure.

    occ_words: (Bcap, 2) 64-bit cell occupancy as two 32-bit words (uint32
               on the host, viewed as int32 on the device), bit c of the row
               = cell c. Pad blocks are all-zero.
    same_tbl:  (Bcap, 27) block row of neighbour block b+delta, -1 absent.
    """

    occ_words: object
    same_tbl: object


class BlockPyramidDev(NamedTuple):
    """One rotation's (or a batch's) block pyramid.

    levels:    per-level BlockLevelDev, finest first.
    down_tbl:  (Bcap_{l+1}, 27) level-l block rows at 2*B+delta.
    up_tbl:    (Bcap_l, 27) flat coarse cell rows (block*64 + cell) of the
               3^3 coarse-unit region [2b, 2b+2]; -1 absent.
    l0_coords: (Bcap_0, 3) int16 level-0 block coords.
    origin:    (3,) int32 integer voxel coords of the grid origin.
    """

    levels: tuple
    down_tbl: tuple
    up_tbl: tuple
    l0_coords: object
    origin: object


_TORCH_DTYPE = {
    np.dtype(np.uint32): torch.int32,  # torch has few uint32 ops: carry the bits
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
}


def unpack_block_payload(
    payload: torch.Tensor, block_caps: tuple[int, ...], batch: int | None = None,
    num_levels: int = 4,
) -> BlockPyramidDev:
    """Inverse of ``native/blockpyr.alloc_block_buffers_packed_rows`` for
    one row: slice the (total,) uint8 payload and view each field as its
    dtype (uint32 occupancy words as int32). No copies."""
    from roreg_tpu_torch.native.blockpyr import _tree_from_fields, payload_spec

    spec, total = payload_spec(block_caps, batch, num_levels)
    if payload.dtype != torch.uint8 or tuple(payload.shape) != (total,):
        raise ValueError(f"payload must be ({total},) uint8, got {tuple(payload.shape)} {payload.dtype}")
    fields = {}
    for name, shape, dt, off in spec:
        raw = payload[off: off + int(np.prod(shape)) * dt.itemsize]
        fields[name] = raw.view(_TORCH_DTYPE[dt]).view(shape)
    return _tree_from_fields(fields, num_levels)


def unpack_cell_occupancy(words: torch.Tensor) -> torch.Tensor:
    """(B, 2) occupancy words (uint32 bits in int32) -> (B, 64) bool cell
    mask. The shift is arithmetic for a set bit 31, so each bit is taken
    with ``& 1`` after the shift."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], CELLS).bool()


def flatten_block_batch(tree: BlockPyramidDev, block_caps: tuple[int, ...]) -> BlockPyramidDev:
    """Stack a chunk's B pyramids (every leaf with a leading axis B) into
    one: occupancy rows concatenated, every table offset by its rotation's
    row base with -1 kept (int16 tables become int32). Same and down tables
    index blocks of their source level, up tables flat cells of the coarser
    level (block*64 + cell)."""
    n = len(tree.levels)
    return BlockPyramidDev(
        levels=tuple(
            BlockLevelDev(
                occ_words=lvl.occ_words.reshape(-1, 2),
                same_tbl=offset_table(lvl.same_tbl, block_caps[l]),
            )
            for l, lvl in enumerate(tree.levels)
        ),
        down_tbl=tuple(offset_table(tree.down_tbl[l], block_caps[l]) for l in range(n - 1)),
        up_tbl=tuple(offset_table(tree.up_tbl[l], block_caps[l + 1] * CELLS) for l in range(n - 1)),
        l0_coords=tree.l0_coords.reshape(-1, 3),
        origin=tree.origin,
    )


_CONV1_DENSE_MAPS: dict = {}


def _conv1_dense_map(ksize: int) -> np.ndarray:
    """Static tap map of the dense-GEMM conv1 (a copy of the JAX package's
    ``_conv1_dense_map``): ``tapidx[n, c, u]`` (27, 64, 64) is the kernel
    row of ``w`` connecting source cell ``c`` of neighbour block ``n`` to
    output cell ``u``, or ``ksize**3`` (a zero row) outside the support."""
    if ksize not in _CONV1_DENSE_MAPS:
        koff, cell, _ = _halo_maps(ksize, 1)
        span = BLOCK - 1 + ksize
        kv = ksize**3
        tap = np.full((27, CELLS, CELLS), kv, np.int32)
        s = np.arange(span)
        hx, hy, hz = (m.reshape(-1) for m in np.meshgrid(s, s, s, indexing="ij"))
        for u_flat in range(CELLS):
            x, y, z = u_flat // 16, (u_flat // 4) % 4, u_flat % 4
            i, j, k = hx - x, hy - y, hz - z
            ok = (i >= 0) & (i < ksize) & (j >= 0) & (j < ksize) & (k >= 0) & (k < ksize)
            t = i * ksize * ksize + j * ksize + k
            tap[koff[ok], cell[ok], u_flat] = t[ok]
        _CONV1_DENSE_MAPS[ksize] = tap
    return _CONV1_DENSE_MAPS[ksize]


def _masked(out: torch.Tensor, cell_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(cell_mask[..., None], out, torch.zeros((), device=out.device))


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.long, device=device)


def conv1_occupancy(occ, tbl, w, cell_mask, kernel_size=7, compute_dtype=None):
    """First conv over FCGF's all-ones input: occupancy in, one GEMM out.
    occ (B, 64) bool, tbl (B, 27), w (K^3, 1, Cout) -> (B, 64, Cout) f32.

    The static conv structure is folded into a (27*64, 64*Cout) matrix
    ``M[n*64+c, u*Cout+o] = w[tap(n,c,u), o]``, so the conv is the single
    product of the gathered neighbour occupancy (B, 27*64) with M.
    """
    ks = kernel_size
    if ks > 9:
        raise ValueError("kernel must fit the 27-neighbour halo")
    b = tbl.shape[0]
    cout = w.shape[2]
    cd = compute_dtype or torch.float32
    wq = w.reshape(ks**3, cout)
    if compute_dtype is not None:
        wq = wq.to(compute_dtype)
    tap = _index(_conv1_dense_map(ks).reshape(-1), w.device)
    w_pad = torch.cat([wq, torch.zeros((1, cout), dtype=wq.dtype, device=wq.device)])
    m = w_pad[tap].reshape(27 * CELLS, CELLS * cout)
    nbr = block_gather(occ.to(cd).contiguous(), tbl)  # (B, 27, 64)
    out = nbr.reshape(b, 27 * CELLS).float() @ m.float()
    return _masked(out.reshape(b, CELLS, cout), cell_mask)


def _halo_dense_conv(feats, tbl, w, cell_mask, span, stride, compute_dtype):
    if compute_dtype is not None:
        feats, w = feats.to(compute_dtype), w.to(compute_dtype)
    return halo_conv(feats.contiguous(), tbl, w.contiguous(), cell_mask, span, stride)


def conv_same(feats, tbl, w, cell_mask, compute_dtype=None):
    """Same-level 3^3 conv. feats (B, 64, Cin), w (27, Cin, Cout) ->
    (B, 64, Cout) f32: out[u] = sum_d feats[u + d] @ w[d]."""
    return _halo_dense_conv(feats, tbl, w, cell_mask, 6, 1, compute_dtype)


def conv_down(feats_src, down_tbl, w, dst_cell_mask, compute_dtype=None):
    """Stride-2 conv level l -> l+1: out[w] = sum_d src[2w + d] @ w[d],
    over the 9^3 halo of the source blocks at 2B + delta."""
    return _halo_dense_conv(feats_src, down_tbl, w, dst_cell_mask, 9, 2, compute_dtype)


def conv_up(feats_coarse, up_tbl, w, dst_cell_mask, compute_dtype=None):
    """Transposed conv level l+1 -> l: out[u] = sum over d with u+d even of
    coarse[(u+d)/2] @ w[d]: a gather of each fine block's (B, 27, Cin)
    coarse region (``block_gather``), then its 8 parity-class products
    (``kernels/up_conv.py``)."""
    cin = w.shape[1]
    if compute_dtype is not None:
        feats_coarse, w = feats_coarse.to(compute_dtype), w.to(compute_dtype)
    reg = block_gather(feats_coarse.reshape(-1, cin).contiguous(), up_tbl)  # (bf, 27, cin)
    return up_conv(reg, w.contiguous(), dst_cell_mask)


class _BlockConv(nn.Module):
    """A 3^3 conv of the block engine; parameter ``kernel`` (27, Cin, Cout)
    as the gather engine's ``SparseConv``."""

    def __init__(self, in_channels: int, out_channels: int, kind: str, compute_dtype=None):
        super().__init__()
        self.conv = {"same": conv_same, "down": conv_down, "up": conv_up}[kind]
        self.compute_dtype = _dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.zeros(27, in_channels, out_channels))

    def forward(self, feats, tbl, cell_mask):
        return self.conv(feats, tbl, self.kernel, cell_mask, self.compute_dtype)

    def cat_input(self, x, skip):
        """This conv's input ``[x, skip]``: written in bf16 where the conv
        computes in bf16 (its first step is that cast), else f32."""
        if self.compute_dtype == torch.bfloat16:
            return skip_concat(x, skip)
        return torch.cat([x, skip], -1)


class _Conv1Occ(nn.Module):
    """The first conv; parameter ``kernel`` (K^3, 1, Cout) as the gather
    engine's ``OccupancyConv``."""

    def __init__(self, out_channels: int, kernel_size: int, compute_dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.compute_dtype = _dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.zeros(kernel_size**3, 1, out_channels))

    def forward(self, occ, tbl, cell_mask):
        return conv1_occupancy(occ, tbl, self.kernel, cell_mask, self.kernel_size, self.compute_dtype)


class _BlockBasicBlock(nn.Module):
    """Pre-norm residual block, parameter names of ``resunet.BasicBlock``."""

    def __init__(self, channels: int, compute_dtype=None):
        super().__init__()
        self.conv1 = _BlockConv(channels, channels, "same", compute_dtype)
        self.norm1 = MaskedBatchNorm(channels)
        self.conv2 = _BlockConv(channels, channels, "same", compute_dtype)
        self.norm2 = MaskedBatchNorm(channels)

    def forward(self, x, tbl, cell_mask):
        y = torch.relu(self.norm1(self.conv1(x, tbl, cell_mask), cell_mask))
        y = self.norm2(self.conv2(y, tbl, cell_mask), cell_mask)
        return _masked(torch.relu(y + x), cell_mask)


class BlockResUNet(nn.Module):
    """FCGF ResUNet on the block-dense engine (inference). Features flow as
    (B_l, 64, C); the forward returns (B_0 * 64, out_channels) rows, unit
    norm at occupied level-0 cells and zero elsewhere, in the flat cell-row
    order of the host-resolved keypoint rows. 17 halo convs (14 same, 3
    down), 3 up convs and conv1: 4 block gathers; 3 up convs, 2 skip
    concatenations and 2 cell-dense layers."""

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
        self.conv1 = _Conv1Occ(ch[0], conv1_kernel_size, cd)
        self.norm1 = MaskedBatchNorm(ch[0])
        self.block1 = _BlockBasicBlock(ch[0], cd)
        self.conv2 = _BlockConv(ch[0], ch[1], "down", cd)
        self.norm2 = MaskedBatchNorm(ch[1])
        self.block2 = _BlockBasicBlock(ch[1], cd)
        self.conv3 = _BlockConv(ch[1], ch[2], "down", cd)
        self.norm3 = MaskedBatchNorm(ch[2])
        self.block3 = _BlockBasicBlock(ch[2], cd)
        self.conv4 = _BlockConv(ch[2], ch[3], "down", cd)
        self.norm4 = MaskedBatchNorm(ch[3])
        self.block4 = _BlockBasicBlock(ch[3], cd)

        self.conv4_tr = _BlockConv(ch[3], tr[3], "up", cd)
        self.norm4_tr = MaskedBatchNorm(tr[3])
        self.block4_tr = _BlockBasicBlock(tr[3], cd)
        self.conv3_tr = _BlockConv(tr[3] + ch[2], tr[2], "up", cd)
        self.norm3_tr = MaskedBatchNorm(tr[2])
        self.block3_tr = _BlockBasicBlock(tr[2], cd)
        self.conv2_tr = _BlockConv(tr[2] + ch[1], tr[1], "up", cd)
        self.norm2_tr = MaskedBatchNorm(tr[1])
        self.block2_tr = _BlockBasicBlock(tr[1], cd)
        self.conv1_tr = nn.Linear(tr[1] + ch[0], tr[0], bias=False)
        self.final = nn.Linear(tr[0], out_channels, bias=True)

    def forward(self, pyr: BlockPyramidDev) -> torch.Tensor:
        occs = [unpack_cell_occupancy(lvl.occ_words) for lvl in pyr.levels]
        same = [lvl.same_tbl for lvl in pyr.levels]

        x = self.norm1(self.conv1(occs[0], same[0], occs[0]), occs[0])
        out_s1 = self.block1(x, same[0], occs[0])
        x = torch.relu(out_s1)

        x = self.norm2(self.conv2(x, pyr.down_tbl[0], occs[1]), occs[1])
        out_s2 = self.block2(x, same[1], occs[1])
        x = torch.relu(out_s2)

        x = self.norm3(self.conv3(x, pyr.down_tbl[1], occs[2]), occs[2])
        out_s4 = self.block3(x, same[2], occs[2])
        x = torch.relu(out_s4)

        x = self.norm4(self.conv4(x, pyr.down_tbl[2], occs[3]), occs[3])
        out_s8 = self.block4(x, same[3], occs[3])
        x = torch.relu(out_s8)

        x = self.norm4_tr(self.conv4_tr(x, pyr.up_tbl[2], occs[2]), occs[2])
        x = torch.relu(self.block4_tr(x, same[2], occs[2]))

        x = self.conv3_tr.cat_input(x, out_s4)
        x = self.norm3_tr(self.conv3_tr(x, pyr.up_tbl[1], occs[1]), occs[1])
        x = torch.relu(self.block3_tr(x, same[1], occs[1]))

        x = self.conv2_tr.cat_input(x, out_s2)
        x = self.norm2_tr(self.conv2_tr(x, pyr.up_tbl[0], occs[0]), occs[0])
        x = torch.relu(self.block2_tr(x, same[0], occs[0]))

        # the output is masked below, so the dense layers skip unoccupied cells
        x = cell_dense(x, out_s1, self.conv1_tr.weight, relu=True, row_mask=occs[0])
        x = cell_dense(x, None, self.final.weight, self.final.bias, row_mask=occs[0])
        if self.normalize_feature:
            x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        return _masked(x, occs[0]).reshape(-1, x.shape[-1])
