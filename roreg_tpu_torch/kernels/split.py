"""f32 operands on the bf16 tensor cores: the two-term split.

The conv kernels multiply bf16 operands into f32 accumulators. An f32
operand ``t`` is carried as two bf16 terms, ``hi = bf16(t)`` and ``lo =
bf16(t - hi)`` (the difference is exact in f32), which leave about 2^-18
of ``t``. A product ``X @ W`` of two split operands is computed as the
three products ``Xh @ Wh + Xh @ Wl + Xl @ Wh``; the dropped ``Xl @ Wl`` is
as small as what the split leaves, so each product is off by about 3 *
2^-18 (1e-5) of its magnitude, where one bf16 rounding of each operand is
off by about 2^-8 and TF32 by about 2^-10. The gradients follow the same
rule with dY as the other operand: dgrad runs ``dYh Wh + dYh Wl + dYm Wh``
and wgrad ``dYh Xh + dYh Xl + dYm Xh``, ``dYh, dYm`` being dY's two terms
(the first two of the three that their bf16 entries carry); the dropped
products are each under 2^-17 of a product.

One design carries the rule, for all five f32 entries (``gather_conv``,
``halo_conv``, ``up_conv``, and the gradient's dgrad and wgrad): on chip,
one launch a call. The kernel reads each f32 row it gathers or stages
(features, region rows, dY) once and splits it there; the weights' terms
come split and packed once as ``[Wh ; Wl]`` slots (each module's
``pack_split_weights``, ``up_conv`` taking ``halo_conv``'s, and
``pack_dgrad_split_weights`` for dgrad). So :func:`split_bf16x2` serves
only that weight packing (and the tests' models of the products).
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
