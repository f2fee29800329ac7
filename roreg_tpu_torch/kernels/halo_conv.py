"""Block-dense halo convolution: the Hopper kernel and its plain version.

For each output block of 4x4x4 cells, gather its span^3-cell halo from the
27 neighbour blocks of a (B, 27) block table and convolve it with a 3^3
kernel at stride 1 (span 6: ``conv_same``) or 2 (span 9: ``conv_down``),
masked by the output cells' occupancy (-1 table entries are absent blocks;
an entry >= Nsrc in an occupied block's row is an error: an IndexError in
the plain version, a trap in the kernel, raised as a CUDA error at the next
synchronisation): the function of
``roreg_tpu/sparse/block.py`` ``_halo_dense_conv``, whose contraction the
TPU kernel ``scripts/experiment_pallas_primitives.py`` ``tap_loop``
stands in for.

:func:`halo_conv` runs the plain PyTorch version for tensors on the CPU and
the CUDA kernel of ``csrc/halo_conv.cu`` for tensors on the GPU; on a GPU
it launches the kernel or raises. Operands are bf16 (the kernel's bf16
entry), or f32 (its f32 entry: each f32 feature row is read once and split
into two bf16 terms on chip; the weights come split and packed as
:func:`pack_split_weights` lays them out, ``kernels/split.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from roreg_tpu_torch.build import CudaKernel
from roreg_tpu_torch.kernels.split import split_bf16x2

__all__ = [
    "BLOCK",
    "CELLS",
    "halo_maps",
    "halo_conv",
    "halo_conv_plain",
    "halo_conv_kernel",
    "halo_work",
    "pack_weights",
    "pack_split_weights",
    "F32_K_ORDER",
]

BLOCK = 4  # cells per axis; 64 cells per block
CELLS = BLOCK**3
# (span, stride) of the two convolutions the kernel computes
GEOMETRIES = {(6, 1), (9, 2)}


@lru_cache(maxsize=None)
def halo_maps(ksize: int, scale: int):
    """Static index maps for cell-level halo gathering and im2col (a copy
    of ``roreg_tpu/sparse/block.py`` ``_halo_maps``).

    ksize: conv kernel size per axis (3 for same/down, up to 9 for conv1).
    scale: out-cell stride in halo units (1 same, 2 down). The halo spans
    ``scale*(BLOCK-1) + ksize`` units per axis, within the 27-neighbour
    block table.

    Returns (koff (span^3,), cell (span^3,), q (64*ksize^3,)): halo
    position p reads source cell ``cell[p]`` of neighbour block ``koff[p]``
    (hypercube order); im2col entry (out-cell u, offset o) reads halo
    position ``q[u*ksize^3 + o]``, offsets row-major with dx slowest.
    """
    pad = (ksize - 1) // 2
    span = scale * (BLOCK - 1) + ksize
    a = np.arange(span) - pad  # absolute unit position rel. block start
    d = np.floor_divide(a, BLOCK)  # neighbour block offset per axis (-1/0/1)
    if d.min() < -1 or d.max() > 1:
        raise ValueError("kernel exceeds the 27-neighbour halo")
    c = a - d * BLOCK
    dx, dy, dz = np.meshgrid(d, d, d, indexing="ij")
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    koff = ((dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)).reshape(-1).astype(np.int32)
    cell = (cx * 16 + cy * 4 + cz).reshape(-1).astype(np.int32)

    u = np.arange(BLOCK)
    o = np.arange(ksize)
    ux, ox = np.meshgrid(u, o, indexing="ij")  # (4, ksize)
    h = scale * ux + ox  # halo coordinate per (u, o) per axis
    q = (
        h[:, None, None, :, None, None] * span * span
        + h[None, :, None, None, :, None] * span
        + h[None, None, :, None, None, :]
    )  # (4,4,4, k,k,k)
    maps = (koff, cell, q.reshape(-1).astype(np.int32))
    for m in maps:  # cached and shared by every caller
        m.setflags(write=False)
    return maps


def _check_geometry(span: int, stride: int) -> None:
    if (span, stride) not in GEOMETRIES:
        raise ValueError(f"halo_conv takes span/stride 6/1 or 9/2, got {span}/{stride}")


def halo_gather_plain(feats: torch.Tensor, tbl: torch.Tensor, stride: int) -> torch.Tensor:
    """(Nsrc, 64, C) block features + (B, 27) table -> (B, span^3, C) halo
    cells, zero where the neighbour block is absent."""
    koff, cell, _ = halo_maps(3, stride)
    blk = tbl.long()[:, torch.tensor(koff, dtype=torch.long, device=tbl.device)]  # (B, span^3)
    rows = blk * CELLS + torch.tensor(cell, dtype=torch.long, device=tbl.device)
    g = feats.reshape(-1, feats.shape[-1])[rows.clamp_min(0)]
    return torch.where((blk >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))


def halo_conv_plain(
    feats: torch.Tensor, tbl: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor,
    span: int, stride: int,
) -> torch.Tensor:
    """The plain version: for the output blocks with an occupied cell (the
    others are zero, as in the kernel), halo gather, then the 27 taps as
    slice GEMMs of the im2col rows with f32 accumulation, masked.
    (Nsrc, 64, Cin), (B, 27), (27, Cin, Cout), (B, 64) bool -> (B, 64, Cout)
    float32."""
    _check_geometry(span, stride)
    live = cell_mask.any(dim=1).nonzero().squeeze(1)
    halo = halo_gather_plain(feats, tbl[live], stride)
    q = torch.tensor(halo_maps(3, stride)[2], dtype=torch.long, device=tbl.device).view(CELLS, 27)
    acc = torch.zeros((len(live), CELLS, w.shape[-1]), dtype=torch.float32, device=feats.device)
    for tap in range(27):
        acc += halo[:, q[:, tap]].float() @ w[tap].float()
    out = torch.zeros((tbl.shape[0], CELLS, w.shape[-1]), dtype=torch.float32, device=feats.device)
    out[live] = torch.where(cell_mask[live][..., None], acc, torch.zeros((), device=acc.device))
    return out


def pack_weights(w: torch.Tensor, tap_major: bool = False) -> torch.Tensor:
    """(K, Cin, Cout) -> the kernels' weight stages of 16 input channels,
    each holding ``w[tap, 16c:16c+16, :]`` with element (k, n) at
    [n // 8, k // 8, n % 8, k % 8], wgmma's K-major layout of 8x8 core
    matrices without swizzle (``csrc/hopper.cuh`` ``b_desc``). Chunk-major,
    (Cin/16, K, Cout/8, 2, 8, 8), for ``halo_conv`` and ``up_conv``, which
    run every tap of a chunk before the next; tap-major, (K, Cin/16, Cout/8,
    2, 8, 8), for ``gather_conv``, which runs every chunk of an offset
    before the next."""
    k, cin, cout = w.shape
    order = (0, 1, 4, 2, 5, 3) if tap_major else (1, 0, 4, 2, 5, 3)
    return w.view(k, cin // 16, 2, 8, cout // 8, 8).permute(*order).contiguous()


# the f32 entry's K order: K index k of a 16-channel weight stage holds
# input channel F32_K_ORDER[k] of the chunk, so that the four channels of a
# lane's A fragment (K 2q, 2q + 1, 8 + 2q, 9 + 2q) are the adjacent 4q ..
# 4q + 3 of an f32 halo row, one 16-byte load (csrc/halo_conv.cu)
F32_K_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def pack_split_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) f32 -> the weight slots of the f32 entries of
    ``halo_conv`` and ``up_conv``: the two bf16 terms ``Wh, Wl`` of ``split_bf16x2(w)``, chunk-major as
    :func:`pack_weights` lays them out, (Cin/16, K, 2, Cout/8, 2, 8, 8):
    [Wh ; Wl] of one (chunk, tap) side by side, K index k of a stage
    holding channel ``F32_K_ORDER[k]`` of the chunk, in one copy."""
    k, cin, cout = w.shape
    terms = torch.stack(split_bf16x2(w))  # (2, K, Cin, Cout)
    # channel 16c + 4q + 2a + e at K index 8a + 2q + e (F32_K_ORDER):
    # (term, tap, c, q, a, e, n / 8, n % 8) -> (c, tap, term, n / 8, a, n % 8, q, e)
    slots = terms.view(2, k, cin // 16, 4, 2, 2, cout // 8, 8).permute(2, 1, 0, 6, 4, 7, 3, 5)
    return slots.contiguous().view(cin // 16, k, 2, cout // 8, 2, 8, 8)


class HaloConvKernel(CudaKernel):
    """The CUDA kernel's wrapper: checks its arguments, launches on the
    current stream, counts launches in ``launches``."""

    source = "halo_conv.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for entry in (lib.halo_conv_bf16, lib.halo_conv_f32):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, vp, i64, i64, ci, ci, ci, ci, vp]
        pi = ctypes.POINTER(ci)
        lib.halo_conv_launch_shape.restype = ci
        lib.halo_conv_launch_shape.argtypes = [ci, ci, ci, ci, ci, pi, pi, pi, pi]

    def launch_shape(self, cin: int, cout: int, span: int, stride: int, f32: bool = False) -> dict:
        """The launch shape of the bf16 or the f32 entry for these widths:
        output blocks per thread block, the weight slots of its ring, the
        halo buffers of a block, and the dynamic shared memory bytes."""
        bpc, stages, bufs, smem = (ctypes.c_int() for _ in range(4))
        rc = self._load().halo_conv_launch_shape(span, stride, cin, cout, int(f32), bpc, stages, bufs, smem)
        self.check_rc("halo_conv", rc)
        return {"blocks_per_cta": bpc.value, "stages": stages.value, "halo_buffers": bufs.value,
                "smem_bytes": smem.value}

    @staticmethod
    def operands(feats: torch.Tensor, w: torch.Tensor) -> tuple[str, torch.Tensor]:
        """The C entry for these operand types and its packed weights: bf16
        operands -> ``halo_conv_bf16`` and :func:`pack_weights`; f32 ->
        ``halo_conv_f32`` and :func:`pack_split_weights`'s slots (K rows in
        ``F32_K_ORDER``). The features go to the kernel as they are."""
        if feats.dtype == torch.float32:
            return "halo_conv_f32", pack_split_weights(w)
        return "halo_conv_bf16", pack_weights(w)

    def __call__(
        self, feats: torch.Tensor, tbl: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor,
        span: int, stride: int,
    ) -> torch.Tensor:
        _check_geometry(span, stride)
        dev = feats.device
        if dev.type != "cuda" or any(t.device != dev for t in (tbl, w, cell_mask)):
            raise ValueError("halo_conv kernel: every tensor must be on one CUDA device")
        f32 = feats.dtype == w.dtype == torch.float32
        if not f32 and (feats.dtype != torch.bfloat16 or w.dtype != torch.bfloat16):
            raise TypeError(
                f"halo_conv kernel takes bf16 or f32 feats and weights (one type), got "
                f"{feats.dtype} and {w.dtype}"
            )
        if tbl.dtype != torch.int32:
            raise TypeError(f"halo_conv kernel takes an int32 table, got {tbl.dtype}")
        if cell_mask.dtype != torch.bool:
            raise TypeError(f"halo_conv kernel takes a bool cell mask, got {cell_mask.dtype}")
        if feats.dim() != 3 or feats.shape[1] != CELLS or w.dim() != 3 or w.shape[0] != 27:
            raise ValueError(
                f"halo_conv kernel: feats (Nsrc, 64, Cin), w (27, Cin, Cout); got "
                f"{tuple(feats.shape)} and {tuple(w.shape)}"
            )
        nsrc, _, cin = feats.shape
        cout = w.shape[2]
        b = tbl.shape[0]
        if tuple(tbl.shape) != (b, 27) or tuple(cell_mask.shape) != (b, CELLS) or w.shape[1] != cin:
            raise ValueError(
                f"shape mismatch: feats {tuple(feats.shape)}, tbl {tuple(tbl.shape)}, "
                f"w {tuple(w.shape)}, cell_mask {tuple(cell_mask.shape)}"
            )
        if cin % 16 or cout not in (32, 64, 128, 256):
            raise ValueError(
                f"halo_conv kernel takes Cin in multiples of 16 and Cout of 32, 64, 128 or 256, "
                f"got Cin={cin}, Cout={cout}"
            )
        for name, t in (("feats", feats), ("tbl", tbl), ("w", w), ("cell_mask", cell_mask)):
            if not t.is_contiguous():
                raise ValueError(f"halo_conv kernel: {name} must be contiguous")
        if feats.data_ptr() % 16:
            raise ValueError("halo_conv kernel: feats must be 16-byte aligned")
        lib = self._load()
        out = torch.empty((b, CELLS, cout), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            entry, wp = self.operands(feats, w)
            rc = getattr(lib, entry)(
                feats.data_ptr(), tbl.data_ptr(), wp.data_ptr(),
                cell_mask.data_ptr(), out.data_ptr(), b, nsrc, cin, cout, span, stride, stream,
            )
        self.check_rc("halo_conv", rc)
        self.launches += 1
        return out


halo_conv_kernel = HaloConvKernel()


def halo_conv(
    feats: torch.Tensor, tbl: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor,
    span: int, stride: int,
) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if feats.device.type == "cpu":
        return halo_conv_plain(feats, tbl, w, cell_mask, span, stride)
    return halo_conv_kernel(feats, tbl, w, cell_mask, span, stride)


def halo_work(
    tbl: torch.Tensor, cell_mask: torch.Tensor, cin: int, cout: int, stride: int,
    elem_bytes: int = 2,
) -> tuple[int, int]:
    """(operations, bytes) one call needs with these tables: 2 * Cin * Cout
    for each occupied output cell and each of its 27 taps whose source
    block exists (an absent block contributes nothing); bytes for every
    source cell those taps reach (read once), the whole table and mask, the
    weights once (features and weights at ``elem_bytes`` an element: 2 for
    bf16, 4 for f32 operands), and the whole f32 output."""
    koff, cell, q = (torch.tensor(m, dtype=torch.long, device=tbl.device) for m in halo_maps(3, stride))
    q = q.view(CELLS, 27)
    live = cell_mask.any(dim=1)
    mask = cell_mask[live]
    blk = tbl[live].long()[:, koff]  # (L, span^3) source block per halo cell
    exists = blk >= 0
    ops = 2 * cin * cout * int((exists[:, q] & mask[..., None]).sum())
    # halo cells that an occupied output cell's tap reaches
    reach = torch.zeros((CELLS, koff.numel()), dtype=torch.float32, device=tbl.device)
    reach[torch.arange(CELLS, device=tbl.device)[:, None], q] = 1.0
    used = exists & ((mask.float() @ reach) > 0)
    cells_read = int(torch.unique((blk * CELLS + cell)[used]).numel())
    nbytes = (
        (cells_read * cin + 27 * cin * cout) * elem_bytes
        + tbl.numel() * tbl.element_size()
        + cell_mask.numel()
        + tbl.shape[0] * CELLS * cout * 4
    )
    return ops, nbytes
