"""f32 operands on the bf16 tensor cores: the two-term split.

The forward conv kernels multiply bf16 operands into f32 accumulators. An
f32 operand ``t`` is carried as two bf16 terms, ``hi = bf16(t)`` and ``lo =
bf16(t - hi)`` (the difference is exact in f32), which leave about 2^-18
of ``t``. A product ``X @ W`` of two split operands is computed as the
three products ``Xh @ Wh + Xh @ Wl + Xl @ Wh``; the dropped ``Xl @ Wl`` is
as small as what the split leaves, so each product is off by about 3 *
2^-18 (1e-5) of its magnitude, where one bf16 rounding of each operand is
off by about 2^-8 and TF32 by about 2^-10.

``gather_conv`` and ``halo_conv`` contract the stacked operands
``[Xh | Xh | Xl]`` (channels) and ``[Wh ; Wl ; Wh]`` (input rows of each
offset) at three times Cin in one launch (:func:`stack_terms`); ``up_conv``
runs the three products as a loop over the terms inside its kernel; dgrad
and wgrad launch once per term of the operand they read as bf16 (W for
dgrad, X for wgrad) and sum.
"""

from __future__ import annotations

import torch

__all__ = ["split_bf16x2", "stack_terms"]


def split_bf16x2(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as two bf16 terms: ``hi = bf16(t)``, ``lo = bf16(t - hi)``;
    ``hi + lo`` is within about ``2**-17 * |t|`` of ``t``."""
    t = t.float()
    hi = t.bfloat16()
    return hi, (t - hi.float()).bfloat16()


def stack_terms(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked operands of an f32 contraction over the last axis of
    ``x`` (..., Cin) and the middle axis of ``w`` (K, Cin, Cout):
    ``[Xh | Xh | Xl]`` (..., 3 Cin) and ``[Wh ; Wl ; Wh]`` (K, 3 Cin, Cout),
    bf16 and contiguous, whose bf16 contraction with f32 sums is the
    three-product sum of the module docstring."""
    xh, xl = split_bf16x2(x)
    wh, wl = split_bf16x2(w)
    return torch.cat([xh, xh, xl], -1), torch.cat([wh, wl, wh], 1)
