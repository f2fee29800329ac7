"""The block decoder's per-cell dense layer: the Hopper kernel and its plain
version.

``y = act([a, b] @ weight.T + bias)`` over rows, zero where an optional
``row_mask`` is False, with the input given as one or two K-slices ``a``
(R, Ca) and ``b`` (R, Cb) (so no concatenation is made), ``weight``
(N, Ca + Cb) as ``torch.nn.Linear`` holds it, an optional bias and an
optional ReLU; f32 in, f32 products and sums, f32 out: the
function of the TPU kernel ``scripts/experiment_pallas_primitives.py``
``p1`` (a per-cell dense layer with the cells folded into M), and of
``conv1_tr`` and ``final`` in ``roreg_tpu/sparse/block.py`` (f32
``nn.Dense``). The block decoder passes the level-0 cell mask: the JAX
package masks the decoder's output at the end, so rows of unoccupied cells
may be zero from the start, and the kernel reads and multiplies only the
kept rows.

:func:`cell_dense` runs the plain PyTorch version for tensors on the CPU
and the CUDA kernel of ``csrc/cell_dense.cu`` for tensors on the GPU; on a
GPU it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from roreg_tpu_torch.build import CudaKernel

__all__ = ["cell_dense", "cell_dense_plain", "cell_dense_kernel", "dense_work"]


def cell_dense_plain(
    a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
    bias: torch.Tensor | None = None, relu: bool = False, row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version: one f32 ``F.linear`` of the concatenated slices,
    then zeros where ``row_mask`` is False."""
    x = a if b is None else torch.cat([a, b], -1)
    y = F.linear(x, weight, bias)
    y = torch.relu(y) if relu else y
    if row_mask is None:
        return y
    return torch.where(row_mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))


class CellDenseKernel(CudaKernel):
    """The CUDA kernel's wrapper: checks its arguments, launches on the
    current stream, counts launches in ``launches``."""

    source = "cell_dense.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cell_dense_f32.restype = ci
        lib.cell_dense_f32.argtypes = [vp, vp, vp, vp, vp, vp, i64, ci, ci, ci, ci, vp]

    def __call__(
        self, a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
        bias: torch.Tensor | None = None, relu: bool = False, row_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        dev = a.device
        if row_mask is not None:
            if row_mask.dtype != torch.bool:
                raise TypeError(f"cell_dense kernel takes a bool row_mask, got {row_mask.dtype}")
            if row_mask.shape != a.shape[:-1] or not row_mask.is_contiguous():
                raise ValueError(
                    f"cell_dense kernel: row_mask must be contiguous with the rows' shape "
                    f"{tuple(a.shape[:-1])}, got {tuple(row_mask.shape)}")
            if row_mask.device != dev:
                raise ValueError("cell_dense kernel: row_mask must be on the inputs' device")
            if row_mask.data_ptr() % 16:
                raise ValueError("cell_dense kernel: row_mask must be 16-byte aligned")
        parts = {"a": a, "weight": weight}
        if b is not None:
            parts["b"] = b
        if bias is not None:
            parts["bias"] = bias
        for name, t in parts.items():
            if t.device != dev or dev.type != "cuda":
                raise ValueError("cell_dense kernel: every tensor must be on one CUDA device")
            if t.dtype != torch.float32:
                raise TypeError(f"cell_dense kernel takes f32 tensors, got {name} {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"cell_dense kernel: {name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"cell_dense kernel: {name} must be 16-byte aligned")
        ca = a.shape[-1]
        cb = 0 if b is None else b.shape[-1]
        if b is not None and b.shape[:-1] != a.shape[:-1]:
            raise ValueError(f"cell_dense kernel: row shapes differ, {tuple(a.shape)} and {tuple(b.shape)}")
        if weight.dim() != 2 or weight.shape[1] != ca + cb:
            raise ValueError(f"cell_dense kernel: weight must be (N, {ca + cb}), got {tuple(weight.shape)}")
        n = weight.shape[0]
        if bias is not None and tuple(bias.shape) != (n,):
            raise ValueError(f"cell_dense kernel: bias must be ({n},), got {tuple(bias.shape)}")
        if ca % 16 or cb % 16 or not ca or ca + cb > 448 or n not in (32, 64):
            raise ValueError(
                f"cell_dense kernel takes K-slices in multiples of 16 (K <= 448, its weight and "
                f"two row stages fill shared memory) and N of 32 or 64, "
                f"got Ca={ca}, Cb={cb}, N={n}")
        lib = self._load()
        out = torch.empty(a.shape[:-1] + (n,), dtype=torch.float32, device=dev)
        rows = a.numel() // ca
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.cell_dense_f32(
                a.data_ptr(), None if b is None else b.data_ptr(), weight.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if row_mask is None else row_mask.data_ptr(), out.data_ptr(),
                rows, ca, cb, n, int(relu), stream,
            )
        self.check_rc("cell_dense", rc)
        self.launches += 1
        return out


cell_dense_kernel = CellDenseKernel()


def cell_dense(
    a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
    bias: torch.Tensor | None = None, relu: bool = False, row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if a.device.type == "cpu":
        return cell_dense_plain(a, b, weight, bias, relu, row_mask)
    return cell_dense_kernel(a, b, weight, bias, relu, row_mask)


def dense_work(a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
               bias: torch.Tensor | None = None,
               row_mask: torch.Tensor | None = None) -> tuple[int, int]:
    """(operations, bytes) one call needs: 2 * K * N for each kept row (every
    row without a mask); the kept rows' f32 inputs, the weight, the bias and
    the mask read once, the f32 output of every row written once."""
    k = weight.shape[1]
    rows = a.numel() // a.shape[-1]
    kept = rows if row_mask is None else int(row_mask.sum())
    n = weight.shape[0]
    nbytes = 4 * (kept * k + weight.numel() + (0 if bias is None else n) + rows * n)
    if row_mask is not None:
        nbytes += row_mask.numel()
    return 2 * kept * k * n, nbytes
