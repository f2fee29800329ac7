"""The block decoder's skip concatenation: the Hopper kernel and its plain
version.

``out[r] = [a[r], b[r]]`` cast to bf16, for f32 (R, Ca) and (R, Cb) rows:
the function of the TPU kernel ``scripts/experiment_pallas_primitives.py``
``p5`` (a lane concatenation of two halves), and of the concatenations
ahead of ``conv3_tr`` and ``conv2_tr`` in ``roreg_tpu/sparse/block.py``
followed by the bf16 cast with which ``conv_up`` starts.

:func:`skip_concat` runs the plain PyTorch version for tensors on the CPU
and the CUDA kernel of ``csrc/skip_concat.cu`` for tensors on the GPU; on a
GPU it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from roreg_tpu_torch.build import CudaKernel

__all__ = ["skip_concat", "skip_concat_plain", "skip_concat_kernel", "concat_work"]


def skip_concat_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: (..., Ca), (..., Cb) -> (..., Ca + Cb) bf16."""
    return torch.cat([a, b], -1).to(torch.bfloat16)


class SkipConcatKernel(CudaKernel):
    """The CUDA kernel's wrapper: checks its arguments, launches on the
    current stream, counts launches in ``launches``."""

    source = "skip_concat.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.skip_concat_bf16.restype = ci
        lib.skip_concat_bf16.argtypes = [vp, vp, vp, i64, ci, ci, vp]

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dev = a.device
        if dev.type != "cuda" or b.device != dev:
            raise ValueError("skip_concat kernel: a and b must be on one CUDA device")
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"skip_concat kernel takes f32 inputs, got {a.dtype} and {b.dtype}")
        if a.shape[:-1] != b.shape[:-1]:
            raise ValueError(f"skip_concat kernel: row shapes differ, {tuple(a.shape)} and {tuple(b.shape)}")
        ca, cb = a.shape[-1], b.shape[-1]
        if ca % 8 or cb % 8 or not ca or not cb:
            raise ValueError(f"skip_concat kernel takes widths in positive multiples of 8, got {ca} and {cb}")
        if not a.is_contiguous() or not b.is_contiguous():
            raise ValueError("skip_concat kernel: a and b must be contiguous")
        if a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("skip_concat kernel: a and b must be 16-byte aligned")
        lib = self._load()
        out = torch.empty(a.shape[:-1] + (ca + cb,), dtype=torch.bfloat16, device=dev)
        rows = a.numel() // ca
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.skip_concat_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, ca, cb, stream)
        self.check_rc("skip_concat", rc)
        self.launches += 1
        return out


skip_concat_kernel = SkipConcatKernel()


def skip_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if a.device.type == "cpu":
        return skip_concat_plain(a, b)
    return skip_concat_kernel(a, b)


def concat_work(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(operations, bytes) one call needs: no arithmetic; both f32 inputs
    read once, the bf16 output written once."""
    return 0, (a.numel() + b.numel()) * (4 + 2)
