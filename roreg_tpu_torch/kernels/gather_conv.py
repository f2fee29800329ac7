"""Gather-GEMM sparse convolution: the Hopper kernel and its plain version.

``out[i] = sum_k feats[nbr[i, k]] @ weights[k]``, with -1 entries adding
nothing (an entry >= N is an error: an IndexError in the plain version, a
trap in the kernel, raised as a CUDA error at the next synchronisation):
the function of ``roreg_tpu/sparse/conv.py`` ``gather_conv`` and of
the TPU kernel ``roreg_tpu/sparse/window_conv.py`` ``window_gather_conv``.

:func:`gather_conv` runs the plain PyTorch version for tensors on the CPU
and the CUDA kernel of ``csrc/gather_conv.cu`` for tensors on the GPU; on a
GPU it launches the kernel or raises. The kernel is built with ``nvcc`` into
the port's build directory at first use and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from roreg_tpu_torch.build import CudaKernel
from roreg_tpu_torch.kernels.halo_conv import pack_weights

__all__ = ["gather_conv", "gather_conv_plain", "gather_conv_kernel", "conv_work"]


def gather_conv_plain(
    feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """The plain version: gather, mask, one f32 GEMM. (N, C), (M, K),
    (K, C, Cout) -> (M, Cout) float32, any device and float dtype."""
    m, k = nbr.shape
    if weights.shape[0] != k or weights.shape[1] != feats.shape[1]:
        raise ValueError(
            f"shape mismatch: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
            f"weights {tuple(weights.shape)}"
        )
    idx = nbr.long()
    g = feats.float()[idx.clamp_min(0)]  # (M, K, C)
    g = torch.where((idx >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.reshape(m, -1) @ weights.float().reshape(-1, weights.shape[-1])


# the widths and kernel volumes the kernel takes: Cin in steps of 32
# channels, Cout one wgmma tile's width, K offsets listed in one warp
GATHER_COUTS = (32, 64, 128, 256)
GATHER_MAX_K = 32


def _check_widths(cin: int, cout: int, k: int) -> None:
    if cin <= 0 or cin % 32 or cout not in GATHER_COUTS or not 1 <= k <= GATHER_MAX_K:
        raise ValueError(
            f"gather_conv kernel takes Cin in multiples of 32, Cout in {GATHER_COUTS} and "
            f"1 <= K <= {GATHER_MAX_K}, got Cin={cin}, Cout={cout}, K={k}"
        )


class GatherConvKernel(CudaKernel):
    """The CUDA kernel's wrapper: builds and loads the library, checks its
    arguments, packs the weights, launches on the current stream, and
    counts launches in ``launches`` (one per launch, nowhere else)."""

    source = "gather_conv.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.gather_conv_bf16.restype = ci
        lib.gather_conv_bf16.argtypes = [vp, vp, vp, vp, i64, i64, ci, ci, ci, vp]
        lib.gather_conv_launch_shape.restype = ci
        pi = ctypes.POINTER(ci)
        lib.gather_conv_launch_shape.argtypes = [i64, ci, ci, ci, pi, pi, pi, pi]

    def launch_shape(self, m: int, cin: int, cout: int, k: int) -> dict:
        """The kernel's launch shape for an (m, k) table at these widths:
        output rows per tile, input channels per step, slots of its ring,
        and thread blocks per tile (the cluster split of the tile's
        offsets)."""
        _check_widths(cin, cout, k)
        rows, channels, stages, split = (ctypes.c_int() for _ in range(4))
        rc = self._load().gather_conv_launch_shape(m, cin, cout, k, rows, channels, stages, split)
        self.check_rc("gather_conv", rc)
        return {"rows_per_cta": rows.value, "channels_per_step": channels.value,
                "stages": stages.value, "cluster_split": split.value}

    def __call__(
        self, feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
    ) -> torch.Tensor:
        if feats.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
            raise TypeError(
                f"gather_conv kernel takes bf16 feats and weights, got "
                f"{feats.dtype} and {weights.dtype}"
            )
        if nbr.dtype != torch.int32:
            raise TypeError(f"gather_conv kernel takes an int32 table, got {nbr.dtype}")
        if feats.dim() != 2 or nbr.dim() != 2 or weights.dim() != 3:
            raise ValueError("gather_conv kernel: feats (N, C), nbr (M, K), weights (K, C, Cout)")
        (n, c), (m, k), (kw, cw, cout) = feats.shape, nbr.shape, weights.shape
        if kw != k or cw != c:
            raise ValueError(
                f"shape mismatch: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
                f"weights {tuple(weights.shape)}"
            )
        _check_widths(c, cout, k)
        dev = feats.device
        if dev.type != "cuda" or nbr.device != dev or weights.device != dev:
            raise ValueError("gather_conv kernel: every tensor must be on one CUDA device")
        for name, t in (("feats", feats), ("nbr", nbr), ("weights", weights)):
            if not t.is_contiguous():
                raise ValueError(f"gather_conv kernel: {name} must be contiguous")
        if feats.data_ptr() % 16:
            raise ValueError("gather_conv kernel: feats must be 16-byte aligned")
        lib = self._load()
        out = torch.empty((m, cout), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            wp = pack_weights(weights, tap_major=True)
            rc = lib.gather_conv_bf16(
                feats.data_ptr(), nbr.data_ptr(), wp.data_ptr(), out.data_ptr(),
                m, n, c, cout, k, stream,
            )
        self.check_rc("gather_conv", rc)
        self.launches += 1
        return out


gather_conv_kernel = GatherConvKernel()


def gather_conv(
    feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors."""
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, nbr, weights)
    return gather_conv_kernel(feats, nbr, weights)


def conv_work(nbr: torch.Tensor, cin: int, cout: int) -> tuple[int, int]:
    """(operations, bytes) one call needs with this table: 2*Cin*Cout per
    valid (row, offset) entry; bytes for each source row the table
    references read once (bf16), the whole table and the bf16 weights read
    once, and the whole f32 output written once."""
    m, k = nbr.shape
    valid = nbr >= 0
    ops = 2 * int(valid.sum()) * cin * cout
    rows_read = int(torch.unique(nbr[valid]).numel())
    nbytes = rows_read * cin * 2 + m * k * nbr.element_size() + k * cin * cout * 2 + m * cout * 4
    return ops, nbytes
