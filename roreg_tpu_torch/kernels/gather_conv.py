"""Gather-GEMM sparse convolution: the Hopper kernel and its plain version.

``out[i] = sum_k feats[nbr[i, k]] @ weights[k]``, with -1 entries adding
nothing (an entry >= N is an error: an IndexError in the plain version, a
trap in the kernel, raised as a CUDA error at the next synchronisation):
the function of ``roreg_tpu/sparse/conv.py`` ``gather_conv`` and of
the TPU kernel ``roreg_tpu/sparse/window_conv.py`` ``window_gather_conv``.

:func:`gather_conv` runs the plain PyTorch version for tensors on the CPU
and the CUDA kernel of ``csrc/gather_conv.cu`` for tensors on the GPU; on a
GPU it launches the kernel or raises. Where a gradient is needed it goes
through :class:`GatherConvFn`, whose backward runs the two kernels of
``csrc/gather_conv_bwd.cu`` (dgrad and wgrad) on the GPU and their plain
versions (autograd through :func:`gather_conv_plain`) on the CPU; the
gathered ``(M, K, Cin)`` matrix is never saved. The kernels are built with
``nvcc`` into the port's build directory at first use and bound with
``ctypes``. Operands are bf16 or f32: f32 ones run as two bf16 terms each
(``kernels/split.py``) through each kernel's f32 entry, one launch a call:
the forward and wgrad read each gathered f32 row once and split it on
chip, and the forward's and dgrad's weights come split and packed once
(:func:`pack_split_weights`, :func:`pack_dgrad_split_weights`).
"""

from __future__ import annotations

import ctypes

import torch

from roreg_tpu_torch.build import CudaKernel
from roreg_tpu_torch.kernels.halo_conv import pack_weights
from roreg_tpu_torch.kernels.split import split_bf16x2

__all__ = [
    "gather_conv",
    "gather_conv_plain",
    "gather_conv_kernel",
    "conv_work",
    "GatherConvFn",
    "gather_conv_dgrad",
    "gather_conv_wgrad",
    "gather_conv_dgrad_plain",
    "gather_conv_wgrad_plain",
    "gather_conv_dgrad_kernel",
    "gather_conv_wgrad_kernel",
    "bwd_work",
    "bwd_kernel_widths",
    "pack_dgrad_weights",
    "pack_dgrad_split_weights",
    "pack_split_weights",
    "DGRAD_CINS",
    "DGRAD_CI_TILE",
]


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


def pack_split_weights(weights: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) f32 -> the f32 entry's weight slots: the two bf16
    terms ``Wh, Wl`` of ``split_bf16x2(weights)``, tap-major stages as
    :func:`~roreg_tpu_torch.kernels.halo_conv.pack_weights` lays them out,
    (K, Cin/32, 2, 2, Cout/8, 2, 8, 8): Wh's two 16-channel stages of an
    (offset, 32-channel step), then Wl's, in one copy."""
    k, cin, cout = weights.shape
    terms = torch.stack(split_bf16x2(weights))  # (2, K, Cin, Cout)
    # (term, tap, step, half, k / 8, k % 8, n / 8, n % 8) -> (tap, step, term, half, n / 8, k / 8, n % 8, k % 8)
    return terms.view(2, k, cin // 32, 2, 2, 8, cout // 8, 8).permute(1, 2, 0, 3, 6, 4, 7, 5).contiguous()


class GatherConvKernel(CudaKernel):
    """The CUDA kernel's wrapper: builds and loads the library, checks its
    arguments, packs the weights, launches on the current stream, and
    counts launches in ``launches`` (one per launch, nowhere else)."""

    source = "gather_conv.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for entry in (lib.gather_conv_bf16, lib.gather_conv_f32):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, i64, i64, ci, ci, ci, vp]
        lib.gather_conv_launch_shape.restype = ci
        pi = ctypes.POINTER(ci)
        lib.gather_conv_launch_shape.argtypes = [i64, ci, ci, ci, ci, pi, pi, pi, pi, pi]

    def launch_shape(self, m: int, cin: int, cout: int, k: int, f32: bool = False) -> dict:
        """The launch shape of the bf16 or the f32 entry for an (m, k)
        table at these widths: output rows per tile, input channels per
        step, slots of its ring, thread blocks per tile (the cluster split
        of the tile's offsets), and dynamic shared memory bytes."""
        _check_widths(cin, cout, k)
        rows, channels, stages, split, smem = (ctypes.c_int() for _ in range(5))
        rc = self._load().gather_conv_launch_shape(m, cin, cout, k, int(f32), rows, channels, stages,
                                                   split, smem)
        self.check_rc("gather_conv", rc)
        return {"rows_per_cta": rows.value, "channels_per_step": channels.value,
                "stages": stages.value, "cluster_split": split.value, "smem_bytes": smem.value}

    @staticmethod
    def operands(feats: torch.Tensor, weights: torch.Tensor) -> tuple[str, torch.Tensor]:
        """The C entry for these operand types and its packed weights: bf16
        operands -> ``gather_conv_bf16`` and tap-major :func:`pack_weights`;
        f32 -> ``gather_conv_f32`` and :func:`pack_split_weights`'s slots
        of 32 channels a step. The features go to the kernel as they are."""
        if feats.dtype == torch.float32:
            return "gather_conv_f32", pack_split_weights(weights)
        return "gather_conv_bf16", pack_weights(weights, tap_major=True)

    def __call__(
        self, feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
    ) -> torch.Tensor:
        """feats (N, Cin) and weights (K, Cin, Cout), both bf16 or both f32
        (the f32 entry), nbr (M, K) int32 -> (M, Cout) f32."""
        f32 = feats.dtype == weights.dtype == torch.float32
        if not f32 and (feats.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16):
            raise TypeError(
                f"gather_conv kernel takes bf16 or f32 feats and weights (one type), got "
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
            entry, wp = self.operands(feats, weights)
            rc = getattr(lib, entry)(
                feats.data_ptr(), nbr.data_ptr(), wp.data_ptr(), out.data_ptr(),
                m, n, c, cout, k, stream,
            )
        self.check_rc("gather_conv", rc)
        self.launches += 1
        return out


gather_conv_kernel = GatherConvKernel()


def _padded_forward(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors at any width it can be padded to: Cin is
    zero-padded to a multiple of 32 and Cout to the next width of
    ``GATHER_COUTS`` (the extra columns are cut off the output), and a
    table of more than ``GATHER_MAX_K`` offsets runs as launches of at most
    that many offsets whose outputs are summed (exact up to the order of
    the f32 sums)."""
    k = nbr.shape[1]
    if k > GATHER_MAX_K:
        out = None
        for s in range(0, k, GATHER_MAX_K):
            part = _padded_forward(feats, nbr[:, s:s + GATHER_MAX_K].contiguous(),
                                   weights[s:s + GATHER_MAX_K].contiguous())
            out = part if out is None else out.add_(part)
        return out
    cin, cout = feats.shape[1], weights.shape[2]
    cin_p = -(-cin // 32) * 32
    cout_p = next((c for c in GATHER_COUTS if c >= cout), cout)
    if cin_p != cin:
        feats = torch.nn.functional.pad(feats, (0, cin_p - cin))
        weights = torch.nn.functional.pad(weights, (0, 0, 0, cin_p - cin))
    if cout_p != cout:
        weights = torch.nn.functional.pad(weights, (0, cout_p - cout))
    out = gather_conv_kernel(feats, nbr, weights.contiguous())
    return out if cout_p == cout else out[:, :cout].contiguous()


def _forward(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, nbr, weights)
    return _padded_forward(feats, nbr, weights)


# ---- the gradient ----


def gather_conv_dgrad_plain(
    feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, dy: torch.Tensor
) -> torch.Tensor:
    """The plain version of dgrad, autograd through :func:`gather_conv_plain`:
    ``dX[n] = sum over (m, k) with nbr[m, k] = n of dY[m] @ W_k^T`` as an
    f32 ``(N, Cin)`` tensor, any device and float dtype."""
    f = feats.detach().float().requires_grad_(True)
    with torch.enable_grad():
        y = gather_conv_plain(f, nbr, weights.detach().float())
    (dx,) = torch.autograd.grad(y, f, dy.float())
    return dx


def gather_conv_wgrad_plain(
    feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, dy: torch.Tensor
) -> torch.Tensor:
    """The plain version of wgrad, autograd through :func:`gather_conv_plain`:
    ``dW_k = sum_m X[nbr[m, k]]^T dY[m]`` over valid entries, as an f32
    ``(K, Cin, Cout)`` tensor. ``weights`` gives the shape only."""
    w = weights.detach().float().requires_grad_(True)
    with torch.enable_grad():
        y = gather_conv_plain(feats.detach().float(), nbr, w)
    (dw,) = torch.autograd.grad(y, w, dy.float())
    return dw


# dgrad's dX widths: Cin is zero-padded to the next of these, and a thread
# block computes a tile of at most DGRAD_CI_TILE of them (one wgmma N)
DGRAD_CINS = (32, 64, 128, 256)
DGRAD_CI_TILE = 128


def pack_dgrad_weights(weights: torch.Tensor) -> torch.Tensor:
    """dgrad's B operand: ``weights[k]^T`` zero-padded to (Cout_p, Cin_p),
    Cout_p the next multiple of 32 and Cin_p the next of ``DGRAD_CINS``,
    cut into tiles of T = min(Cin_p, ``DGRAD_CI_TILE``) input channels, in
    stages of 16 output channels as :func:`pack_weights` lays out the
    forward's weights: (K, Cin_p/T, Cout_p/16, T/8, 2, 8, 8), so element
    (co, ci) of offset k sits in stage ``(k * Cin_p/T + ci // T) * Cout_p/16
    + co // 16`` at (ci % T // 8, co % 16 // 8, ci % 8, co % 8)."""
    k, cin, cout = weights.shape
    cin_p, cout_p = next(c for c in DGRAD_CINS if c >= cin), -(-cout // 32) * 32
    if (cin_p, cout_p) != (cin, cout):
        weights = torch.nn.functional.pad(weights, (0, cout_p - cout, 0, cin_p - cin))
    tile = min(cin_p, DGRAD_CI_TILE)
    # one copy: (k, ci, co) -> (k, ci // T, co // 16, ci % T // 8, co % 16 // 8, ci % 8, co % 8)
    return (weights.view(k, cin_p // tile, tile // 8, 8, cout_p // 16, 2, 8)
            .permute(0, 1, 4, 2, 5, 3, 6).contiguous())


def pack_dgrad_split_weights(weights: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) f32 -> dgrad's f32 entry's B operand: the two bf16
    terms ``Wh, Wl`` of ``split_bf16x2(weights)``, each laid out as
    :func:`pack_dgrad_weights` lays out bf16 weights, with each 32-row
    Cout slot of Wl^T right after the same slot of Wh^T: (K, Cin_p/T,
    Cout_p/32, 2, 2, T/8, 2, 8, 8), (offset, channel tile, slot, term,
    16-row stage, ...). Each term is written into place by one strided
    copy: Wh rounded in its copy, Wl from the f32 difference ``w - Wh``
    (exact; the one temporary), three launches in all."""
    k, cin, cout = weights.shape
    cin_p, cout_p = next(c for c in DGRAD_CINS if c >= cin), -(-cout // 32) * 32
    w = weights.float()
    if (cin_p, cout_p) != (cin, cout):
        w = torch.nn.functional.pad(w, (0, cout_p - cout, 0, cin_p - cin))
    tile = min(cin_p, DGRAD_CI_TILE)
    out = torch.empty((k, cin_p // tile, cout_p // 32, 2, 2, tile // 8, 2, 8, 8), dtype=torch.bfloat16,
                      device=w.device)
    # out seen in w's order: (term, k, ci // T, ci % T // 8, ci % 8, co // 32, co % 32 // 16, co % 16 // 8, co % 8)
    terms = out.permute(3, 0, 1, 5, 7, 2, 4, 6, 8)
    src = w.view(k, cin_p // tile, tile // 8, 8, cout_p // 32, 2, 2, 8)
    terms[0].copy_(src)
    terms[1].copy_(src - terms[0])
    return out


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels read their rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd_kernel_widths(which: str, cin: int, cout: int) -> tuple[int, int]:
    """The (Cin, Cout) a dgrad or wgrad launch runs at for these widths:
    dgrad pads Cin to the next of ``DGRAD_CINS`` and Cout to a multiple of
    4 (its dY rows are read 16 bytes at a time); wgrad pads Cin to a
    multiple of 8 (its X rows are gathered 16 bytes at a time)."""
    if which == "dgrad":
        return next(c for c in DGRAD_CINS if c >= cin), -(-cout // 4) * 4
    return -(-cin // 8) * 8, cout


class GatherConvBwdKernel(CudaKernel):
    """Wrapper of one of ``csrc/gather_conv_bwd.cu``'s two kernels
    (``which`` is "dgrad" or "wgrad"): checks its arguments, pads the
    widths the kernel does not take (:func:`bwd_kernel_widths`; the extra
    columns are cut off the output), packs dgrad's weights and allocates
    wgrad's scratch, launches the bf16 or the f32 entry on the current
    stream, and counts launches in ``launches`` (one per call at either
    type, nowhere else; wgrad's call runs a split pass before its
    kernel)."""

    source = "gather_conv_bwd.cu"

    def __init__(self, which: str) -> None:
        super().__init__()
        self.which = which
        self._shapes: dict[tuple[int, int, int, int, bool], dict] = {}

    def _bind(self, lib: ctypes.CDLL) -> None:
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for entry in (lib.gather_conv_dgrad, lib.gather_conv_dgrad_f32):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, i64, i64, ci, ci, ci, vp]
        for entry in (lib.gather_conv_wgrad, lib.gather_conv_wgrad_f32):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, vp, i64, i64, ci, ci, ci, vp]
        lib.gather_conv_bwd_launch_shape.restype = ci
        pi, pi64 = ctypes.POINTER(ci), ctypes.POINTER(i64)
        lib.gather_conv_bwd_launch_shape.argtypes = [ci, i64, ci, ci, ci, ci, pi64, pi, pi, pi64, pi]

    def launch_shape(self, m: int, cin: int, cout: int, k: int, f32: bool = False) -> dict:
        """The launch shape of a call of the bf16 or the f32 entry with an
        (m, k) table at these widths: thread blocks, offsets (dgrad) or rows
        (wgrad) a thread block, slots of its ring, wgrad's scratch bytes
        (the split dY terms), and dynamic shared memory bytes."""
        key = (m, cin, cout, k, f32)
        if key not in self._shapes:
            kin, kout = bwd_kernel_widths(self.which, cin, cout)
            blocks, scratch = ctypes.c_int64(), ctypes.c_int64()
            per, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            rc = self._load().gather_conv_bwd_launch_shape(
                0 if self.which == "dgrad" else 1, m, kin, kout, k, int(f32), blocks, per, stages, scratch,
                smem)
            self.check_rc(f"gather_conv {self.which}", rc)
            self._shapes[key] = {
                "blocks": blocks.value, "offsets_per_block" if self.which == "dgrad" else "rows_per_block":
                per.value, "stages": stages.value, "scratch_bytes": scratch.value, "smem_bytes": smem.value}
        return dict(self._shapes[key])

    def operands(self, feats: torch.Tensor, weights: torch.Tensor,
                 dy: torch.Tensor) -> tuple[str, torch.Tensor, torch.Tensor]:
        """The C entry for these operand types and the two operands it
        reads besides the table, at the launch's widths: dgrad dY and the
        packed weights (:func:`pack_dgrad_weights`, or at f32
        :func:`pack_dgrad_split_weights`), wgrad the features as they are
        (bf16 or f32: no split copy) and dY."""
        f32 = feats.dtype == torch.float32
        entry = f"gather_conv_{self.which}" + ("_f32" if f32 else "")
        kin, kout = bwd_kernel_widths(self.which, feats.shape[1], weights.shape[2])
        if self.which == "dgrad":
            pack = pack_dgrad_split_weights if f32 else pack_dgrad_weights
            return entry, _aligned(_pad_cols(dy, kout)), pack(weights)
        return entry, _aligned(_pad_cols(feats, kin)), dy

    def __call__(
        self, feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, dy: torch.Tensor
    ) -> torch.Tensor:
        """feats (N, Cin) and weights (K, Cin, Cout), both bf16 or both f32
        (dgrad reads only the shape of feats, wgrad only the shape of
        weights), nbr (M, K) int32, dy (M, Cout) f32 -> dX (N, Cin) or dW
        (K, Cin, Cout) f32, in one launch: at f32 the operand the bf16
        entry reads as bf16 (W for dgrad, X for wgrad) goes to the f32
        entry, which splits it into two bf16 terms."""
        f32 = feats.dtype == weights.dtype == torch.float32
        if not f32 and (feats.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16):
            raise TypeError(f"gather_conv {self.which} kernel takes bf16 or f32 feats and weights "
                            f"(one type), got {feats.dtype} and {weights.dtype}")
        if nbr.dtype != torch.int32 or dy.dtype != torch.float32:
            raise TypeError(f"gather_conv {self.which} kernel takes an int32 table and an f32 "
                            f"gradient, got {nbr.dtype} and {dy.dtype}")
        if feats.dim() != 2 or nbr.dim() != 2 or weights.dim() != 3 or dy.dim() != 2:
            raise ValueError(f"gather_conv {self.which} kernel: feats (N, C), nbr (M, K), "
                             "weights (K, C, Cout), dy (M, Cout)")
        (n, c), (m, k), (kw, cw, cout) = feats.shape, nbr.shape, weights.shape
        if kw != k or cw != c or tuple(dy.shape) != (m, cout):
            raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
                             f"weights {tuple(weights.shape)}, dy {tuple(dy.shape)}")
        if not (1 <= c <= 256 and 1 <= cout <= 256 and k >= 1):
            raise ValueError(f"gather_conv {self.which} kernel takes 1 <= Cin, Cout <= 256 and "
                             f"K >= 1, got Cin={c}, Cout={cout}, K={k}")
        dev = feats.device
        if dev.type != "cuda" or any(t.device != dev for t in (nbr, weights, dy)):
            raise ValueError(f"gather_conv {self.which} kernel: every tensor must be on one CUDA device")
        for name, t in (("feats", feats), ("nbr", nbr), ("weights", weights), ("dy", dy)):
            if not t.is_contiguous():
                raise ValueError(f"gather_conv {self.which} kernel: {name} must be contiguous")
        kin, kout = bwd_kernel_widths(self.which, c, cout)
        lib = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            entry, a, b = self.operands(feats, weights, dy)
            if self.which == "dgrad":
                out = torch.empty((n, kin), dtype=torch.float32, device=dev)
                rc = getattr(lib, entry)(a.data_ptr(), nbr.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         m, n, kin, kout, k, stream)
            else:
                scratch = torch.empty(self.launch_shape(m, c, cout, k, f32)["scratch_bytes"],
                                      dtype=torch.uint8, device=dev)
                out = torch.empty((k, kin, cout), dtype=torch.float32, device=dev)
                rc = getattr(lib, entry)(a.data_ptr(), nbr.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         scratch.data_ptr(), m, n, kin, cout, k, stream)
        self.check_rc(f"gather_conv {self.which}", rc)
        self.launches += 1
        if kin != c:
            out = out[..., :c, :] if self.which == "wgrad" else out[:, :c]
            out = out.contiguous()
        return out


gather_conv_dgrad_kernel = GatherConvBwdKernel("dgrad")
gather_conv_wgrad_kernel = GatherConvBwdKernel("wgrad")


def gather_conv_dgrad(feats, nbr, weights, dy) -> torch.Tensor:
    """dX, f32: the plain version for CPU tensors, the kernel for GPU ones."""
    if feats.device.type == "cpu":
        return gather_conv_dgrad_plain(feats, nbr, weights, dy)
    return gather_conv_dgrad_kernel(feats, nbr, weights, dy.float().contiguous())


def gather_conv_wgrad(feats, nbr, weights, dy) -> torch.Tensor:
    """dW, f32: the plain version for CPU tensors, the kernel for GPU ones."""
    if feats.device.type == "cpu":
        return gather_conv_wgrad_plain(feats, nbr, weights, dy)
    return gather_conv_wgrad_kernel(feats, nbr, weights, dy.float().contiguous())


class GatherConvFn(torch.autograd.Function):
    """The gather conv with its gradient: the forward of :func:`gather_conv`;
    saves ``feats``, ``nbr`` and ``weights`` (not the gathered rows); the
    backward runs dgrad and wgrad, each only where its input needs a
    gradient, and returns each in its input's dtype (the one rounding of an
    f32 sum, where the operand is bf16)."""

    @staticmethod
    def forward(ctx, feats, nbr, weights):
        ctx.save_for_backward(feats, nbr, weights)
        return _forward(feats, nbr, weights)

    @staticmethod
    def backward(ctx, dy):
        feats, nbr, weights = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_conv_dgrad(feats, nbr, weights, dy).to(feats.dtype)
        if ctx.needs_input_grad[2]:
            dw = gather_conv_wgrad(feats, nbr, weights, dy).to(weights.dtype)
        return dx, None, dw


def gather_conv(
    feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for GPU tensors;
    through :class:`GatherConvFn` where a gradient is needed."""
    if torch.is_grad_enabled() and (feats.requires_grad or weights.requires_grad):
        return GatherConvFn.apply(feats, nbr, weights)
    return _forward(feats, nbr, weights)


def conv_work(nbr: torch.Tensor, cin: int, cout: int, elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) one call needs with this table: 2*Cin*Cout per
    valid (row, offset) entry; bytes for each source row the table
    references read once, the whole table and the weights read once (at
    ``elem_bytes`` an element: 2 for bf16, 4 for f32 operands), and the
    whole f32 output written once."""
    m, k = nbr.shape
    valid = nbr >= 0
    ops = 2 * int(valid.sum()) * cin * cout
    rows_read = int(torch.unique(nbr[valid]).numel())
    nbytes = (rows_read * cin + k * cin * cout) * elem_bytes + m * k * nbr.element_size() + m * cout * 4
    return ops, nbytes


def bwd_work(which: str, nbr: torch.Tensor, n: int, cin: int, cout: int,
             elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) one dgrad or wgrad call needs with this table:
    2*Cin*Cout per valid entry (f32 dY with bf16 W or X, TF32 on the
    tensor cores); bytes for the f32 dY rows that have
    a valid entry, the whole table, and for dgrad the bf16 weights read
    once and the whole f32 (N, Cin) dX written once, for wgrad each
    referenced bf16 source row read once and the f32 (K, Cin, Cout) dW
    written once (W or X at ``elem_bytes`` an element: 4 for f32
    operands)."""
    m, k = nbr.shape
    valid = nbr >= 0
    ops = 2 * int(valid.sum()) * cin * cout
    nbytes = int(valid.any(1).sum()) * cout * 4 + m * k * nbr.element_size()
    if which == "dgrad":
        nbytes += k * cin * cout * elem_bytes + n * cin * 4
    else:
        nbytes += int(torch.unique(nbr[valid]).numel()) * cin * elem_bytes + k * cin * cout * 4
    return ops, nbytes
