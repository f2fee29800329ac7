"""f32 operands on the bf16 tensor cores: the two-term split.

The forward conv kernels multiply bf16 operands into f32 accumulators. An
f32 operand ``t`` is carried as two bf16 terms, ``hi = bf16(t)`` and ``lo =
bf16(t - hi)`` (the difference is exact in f32), which leave about 2^-18
of ``t``. A product ``X @ W`` of two split operands is computed as the
three products ``Xh @ Wh + Xh @ Wl + Xl @ Wh``; the dropped ``Xl @ Wl`` is
as small as what the split leaves, so each product is off by about 3 *
2^-18 (1e-5) of its magnitude, where one bf16 rounding of each operand is
off by about 2^-8 and TF32 by about 2^-10.

``gather_conv`` and ``halo_conv`` have f32 entries that read each f32
feature row once and split it on chip, with the weights' terms packed as
``[Wh ; Wl]`` slots (each module's ``pack_split_weights``);
``up_conv`` runs the three products as a loop over the terms inside its
kernel; dgrad and wgrad launch once per term of the operand they read as
bf16 (W for dgrad, X for wgrad) and sum.
"""

from __future__ import annotations

import torch

__all__ = ["split_bf16x2"]


def split_bf16x2(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as two bf16 terms: ``hi = bf16(t)``, ``lo = bf16(t - hi)``;
    ``hi + lo`` is within about ``2**-17 * |t|`` of ``t``."""
    t = t.float()
    hi = t.bfloat16()
    return hi, (t - hi.float()).bfloat16()
