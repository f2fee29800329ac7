"""Whole-row block-table gather: the Hopper kernel and its plain version.

``out[b, j] = src[tbl[b, j]]`` for a (B, 27) table, with zero rows where
the entry is -1 (an entry >= Nsrc is an error: an IndexError in the plain
version, a trap in the kernel, raised as a CUDA error at the next
synchronisation): the function of the TPU kernel
``scripts/experiment_pallas_gather.py`` ``gather_p`` (its own oracle is
``jnp.take(feats.reshape(B, W), tbl.reshape(B, 27), axis=0)``), and the
gather inside the block engine's ``conv1_occupancy`` and ``conv_up``
(``roreg_tpu/sparse/block.py``).

:func:`block_gather` runs the plain PyTorch version for tensors on the CPU
and the CUDA kernel of ``csrc/block_gather.cu`` for tensors on the GPU; on
a GPU it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from roreg_tpu_torch.build import CudaKernel

__all__ = ["block_gather", "block_gather_plain", "block_gather_kernel", "gather_work"]


def block_gather_plain(src: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The plain version: (Nsrc, R) rows, (B, K) table with -1 for absent
    -> (B, K, R) in ``src``'s dtype, zero rows where the entry is -1."""
    idx = tbl.long()
    g = src[idx.clamp_min(0)]
    return torch.where((idx >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))


class BlockGatherKernel(CudaKernel):
    """The CUDA kernel's wrapper: checks its arguments, launches on the
    current stream, counts launches in ``launches``."""

    source = "block_gather.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.block_gather.restype = ci
        lib.block_gather.argtypes = [vp, vp, vp, i64, i64, i64, vp]

    def __call__(self, src: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
        dev = src.device
        if dev.type != "cuda" or tbl.device != dev:
            raise ValueError("block_gather kernel: src and tbl must be on one CUDA device")
        if tbl.dtype != torch.int32:
            raise TypeError(f"block_gather kernel takes an int32 table, got {tbl.dtype}")
        if src.dim() != 2 or tbl.dim() != 2:
            raise ValueError(
                f"block_gather kernel: src (Nsrc, R), tbl (B, K); got "
                f"{tuple(src.shape)} and {tuple(tbl.shape)}"
            )
        row_bytes = src.shape[1] * src.element_size()
        if row_bytes % 16:
            raise ValueError(f"block_gather kernel takes rows of a multiple of 16 bytes, got {row_bytes}")
        if not src.is_contiguous() or not tbl.is_contiguous():
            raise ValueError("block_gather kernel: src and tbl must be contiguous")
        if src.data_ptr() % 16:
            raise ValueError("block_gather kernel: src must be 16-byte aligned")
        lib = self._load()
        b, k = tbl.shape
        out = torch.empty((b, k, src.shape[1]), dtype=src.dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.block_gather(
                src.data_ptr(), tbl.data_ptr(), out.data_ptr(),
                b * k, src.shape[0], row_bytes, stream,
            )
        self.check_rc("block_gather", rc)
        self.launches += 1
        return out


block_gather_kernel = BlockGatherKernel()


def block_gather(src: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if src.device.type == "cpu":
        return block_gather_plain(src, tbl)
    return block_gather_kernel(src, tbl)


def gather_work(src: torch.Tensor, tbl: torch.Tensor) -> tuple[int, int]:
    """(operations, bytes) one call needs: no arithmetic; each source row
    the table references read once, the table read once, the whole
    (B, K, R) output written once."""
    row_bytes = src.shape[1] * src.element_size()
    valid = tbl >= 0
    rows_read = int(torch.unique(tbl[valid]).numel())
    return 0, rows_read * row_bytes + tbl.numel() * tbl.element_size() + tbl.numel() * row_bytes
