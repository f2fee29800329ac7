"""The block decoder's transposed (up) convolution after its region gather:
the Hopper kernel and its plain version.

``out[b, u] = sum over taps d with u + d even of reg[b, R(u, d)] @ w[d]``,
masked by the fine cells' occupancy, for the (B, 27, Cin) coarse region of
each fine block that ``block_gather`` gathers: the rest of
``roreg_tpu/sparse/block.py`` ``conv_up`` (its 8 parity-class im2col GEMMs,
the class-to-cell permutation and the mask), whose per-block row assembly
the TPU kernel ``scripts/experiment_pallas_primitives.py`` ``p4`` computes
as a one-hot GEMM.

:func:`up_conv` runs the plain PyTorch version for tensors on the CPU and
the CUDA kernel of ``csrc/up_conv.cu`` for tensors on the GPU; on a GPU it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from roreg_tpu_torch.build import CudaKernel
from roreg_tpu_torch.kernels.halo_conv import BLOCK, CELLS, pack_weights

__all__ = [
    "UP_CLASSES",
    "UP_CELL_INV",
    "up_parity_classes",
    "up_class_table",
    "up_class_split",
    "up_conv",
    "up_conv_plain",
    "up_conv_kernel",
    "up_work",
]


def up_parity_classes():
    """Per-parity-class static maps for the transposed conv (a copy of the
    JAX package's ``_up_parity_classes``). For a fixed out-cell parity the
    valid kernel offsets are fixed (even axis: d = 0; odd axis: d = +-1).

    Returns 8 tuples (cells (8,), wrows (K_c,), ridx (8, K_c)): x-major
    cell ids of the class, kernel-offset rows of w, coarse region cell per
    (cell, tap).
    """
    classes = []
    for px in range(2):
        for py in range(2):
            for pz in range(2):
                pars = (px, py, pz)
                axis_d = [[0] if p == 0 else [-1, 1] for p in pars]
                axis_u = [[u for u in range(BLOCK) if u % 2 == p] for p in pars]
                cells = [
                    ux * 16 + uy * 4 + uz
                    for ux in axis_u[0] for uy in axis_u[1] for uz in axis_u[2]
                ]
                wrows = [
                    (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
                    for dx in axis_d[0] for dy in axis_d[1] for dz in axis_d[2]
                ]
                ridx = []
                for c in cells:
                    ux, uy, uz = c // 16, (c // 4) % 4, c % 4
                    ridx.append([
                        ((ux + dx) // 2) * 9 + ((uy + dy) // 2) * 3 + (uz + dz) // 2
                        for dx in axis_d[0] for dy in axis_d[1] for dz in axis_d[2]
                    ])
                classes.append((
                    np.asarray(cells, np.int32),
                    np.asarray(wrows, np.int32),
                    np.asarray(ridx, np.int32),
                ))
    return classes


UP_CLASSES = up_parity_classes()
# class-concatenated cell order -> x-major cell order
UP_CELL_INV = np.argsort(np.concatenate([c for c, _, _ in UP_CLASSES])).astype(np.int32)


def up_class_table() -> np.ndarray:
    """The kernel's static maps, one row of 81 int32 per parity class:
    its 8 cells, its tap count K_c, its K_c weight rows (padded to 8 with
    0) and its (8 cells, 8 taps) region rows (taps padded with 0)."""
    table = np.zeros((len(UP_CLASSES), 81), np.int32)
    for i, (cells, wrows, ridx) in enumerate(UP_CLASSES):
        k = len(wrows)
        table[i, :8] = cells
        table[i, 8] = k
        table[i, 9: 9 + k] = wrows
        region = np.zeros((8, 8), np.int32)
        region[:, :k] = ridx
        table[i, 17:] = region.reshape(-1)
    return table


def up_class_split() -> np.ndarray:
    """The kernel's split of the 8 parity classes between its two consumer
    warpgroups: (8,) int32, warpgroup g runs classes ``[4g:4g+4]`` in that
    order. The two halves of 4 classes each are the first (in lexicographic
    order) whose larger tap count is least (13 and 14 of the 27 taps), each
    in order of falling tap count."""
    taps = [len(wrows) for _, wrows, _ in UP_CLASSES]
    ids = range(len(UP_CLASSES))

    def load(group):
        return max(sum(taps[c] for c in group), sum(taps) - sum(taps[c] for c in group))

    first = min(itertools.combinations(ids, len(UP_CLASSES) // 2), key=load)
    second = [c for c in ids if c not in first]
    order = [sorted(g, key=lambda c: (-taps[c], c)) for g in (first, second)]
    return np.asarray(order[0] + order[1], np.int32)


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.long, device=device)


def up_conv_plain(reg: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor) -> torch.Tensor:
    """The plain version: 8 parity-class im2col GEMMs with f32 products and
    sums, the permutation to x-major cells, the mask. (B, 27, Cin),
    (27, Cin, Cout), (B, 64) bool -> (B, 64, Cout) float32."""
    bf, _, cin = reg.shape
    cout = w.shape[2]
    outs = []
    for cells, wrows, ridx in UP_CLASSES:
        k = len(wrows)
        im = reg[:, _index(ridx.reshape(-1), reg.device)].reshape(bf * len(cells), k * cin)
        wc = w[_index(wrows, w.device)].reshape(k * cin, cout)
        outs.append((im.float() @ wc.float()).reshape(bf, len(cells), cout))
    out = torch.cat(outs, 1)[:, _index(UP_CELL_INV, reg.device)]
    return torch.where(cell_mask[..., None], out, torch.zeros((), device=out.device))


# the widths the kernel takes: Cin a multiple of 32 up to 256 (its region
# stays in shared memory), Cout one wgmma tile's width
UP_CIN_MAX = 256
UP_COUTS = (32, 64, 128)


def _check_widths(cin: int, cout: int) -> None:
    if cin % 32 or not 32 <= cin <= UP_CIN_MAX or cout not in UP_COUTS:
        raise ValueError(
            f"up_conv kernel takes Cin in multiples of 32 up to {UP_CIN_MAX} and Cout in "
            f"{UP_COUTS}, got Cin={cin}, Cout={cout}")


class UpConvKernel(CudaKernel):
    """The CUDA kernel's wrapper: checks its arguments, copies the static
    maps to each device once, packs the weights, launches on the current
    stream, counts launches in ``launches``."""

    source = "up_conv.cu"

    def __init__(self) -> None:
        super().__init__()
        self._maps_on: set[int] = set()

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.up_conv_set_maps.restype = ci
        lib.up_conv_set_maps.argtypes = [vp, ci, vp, ci]
        lib.up_conv_bf16.restype = ci
        lib.up_conv_bf16.argtypes = [vp, vp, vp, vp, i64, ci, ci, vp]
        lib.up_conv_launch_shape.restype = ci
        lib.up_conv_launch_shape.argtypes = [ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]

    def launch_shape(self, cin: int, cout: int) -> dict:
        """The kernel's launch shape for these widths: fine blocks per
        thread block and the weight stages of each warpgroup's ring."""
        _check_widths(cin, cout)
        blocks, stages = ctypes.c_int(), ctypes.c_int()
        self.check_rc("up_conv", self._load().up_conv_launch_shape(cin, cout, blocks, stages))
        return {"blocks_per_cta": blocks.value, "stages": stages.value}

    def __call__(self, reg: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor) -> torch.Tensor:
        if reg.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError(f"up_conv kernel takes bf16 regions and weights, got {reg.dtype} and {w.dtype}")
        if cell_mask.dtype != torch.bool:
            raise TypeError(f"up_conv kernel takes a bool cell mask, got {cell_mask.dtype}")
        if reg.dim() != 3 or reg.shape[1] != 27 or w.dim() != 3 or w.shape[0] != 27:
            raise ValueError(
                f"up_conv kernel: reg (B, 27, Cin), w (27, Cin, Cout); got "
                f"{tuple(reg.shape)} and {tuple(w.shape)}")
        b, _, cin = reg.shape
        cout = w.shape[2]
        if w.shape[1] != cin or tuple(cell_mask.shape) != (b, CELLS):
            raise ValueError(
                f"shape mismatch: reg {tuple(reg.shape)}, w {tuple(w.shape)}, "
                f"cell_mask {tuple(cell_mask.shape)}")
        _check_widths(cin, cout)
        dev = reg.device
        if dev.type != "cuda" or w.device != dev or cell_mask.device != dev:
            raise ValueError("up_conv kernel: every tensor must be on one CUDA device")
        for name, t in (("reg", reg), ("w", w), ("cell_mask", cell_mask)):
            if not t.is_contiguous():
                raise ValueError(f"up_conv kernel: {name} must be contiguous")
        if reg.data_ptr() % 16 or cell_mask.data_ptr() % 16:
            raise ValueError("up_conv kernel: reg and cell_mask must be 16-byte aligned")
        lib = self._load()
        out = torch.empty((b, CELLS, cout), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            if dev.index not in self._maps_on:
                table = np.ascontiguousarray(up_class_table())
                split = np.ascontiguousarray(up_class_split())
                self.check_rc("up_conv (maps)", lib.up_conv_set_maps(
                    table.ctypes.data, table.size, split.ctypes.data, split.size))
                self._maps_on.add(dev.index)
            stream = torch.cuda.current_stream(dev).cuda_stream
            wp = pack_weights(w)
            rc = lib.up_conv_bf16(
                reg.data_ptr(), wp.data_ptr(), cell_mask.data_ptr(), out.data_ptr(), b, cin, cout, stream,
            )
        self.check_rc("up_conv", rc)
        self.launches += 1
        return out


up_conv_kernel = UpConvKernel()


def up_conv(reg: torch.Tensor, w: torch.Tensor, cell_mask: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if reg.device.type == "cpu":
        return up_conv_plain(reg, w, cell_mask)
    return up_conv_kernel(reg, w, cell_mask)


def up_work(up_tbl: torch.Tensor, cell_mask: torch.Tensor, cin: int, cout: int) -> tuple[int, int]:
    """(operations, bytes) one bf16 call needs, given the (B, 27) table its
    region was gathered through: 2 * Cin * Cout for each occupied fine cell
    and each of its taps whose coarse cell exists (an absent cell's region
    row is zero); bytes for every region row such a tap reads (once), the
    mask, the weights once, and the whole f32 output."""
    dev = up_tbl.device
    onehot = torch.zeros((CELLS, 27), dtype=torch.float32, device=dev)  # (cell, region row) taps
    for cells, _, ridx in UP_CLASSES:
        for i, c in enumerate(cells):
            onehot[int(c), _index(ridx[i], dev)] = 1.0
    exists = (up_tbl >= 0).float()  # (B, 27)
    taps = cell_mask.float() @ onehot  # (B, 27): occupied cells reading each region row
    ops = 2 * cin * cout * int((taps * exists).sum())
    rows_read = int(((taps > 0) & (up_tbl >= 0)).sum())
    b = up_tbl.shape[0]
    nbytes = rows_read * cin * 2 + cell_mask.numel() + 27 * cin * cout * 2 + b * CELLS * cout * 4
    return ops, nbytes
