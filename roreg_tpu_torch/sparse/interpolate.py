"""Trilinear field interpolation over a sparse voxel level.

Counterpart of ``roreg_tpu/sparse/interpolate.py`` ``interpolate``
(MinkowskiEngine's interpolation op): sample the sparse feature field at
continuous points. Each query blends its 8 surrounding voxels with
trilinear weights in ME's lattice convention (voxel coordinate c sits at
lattice position c, weights from ``p / vs - floor(p / vs)``); absent
corners add zero, with no renormalisation. Plain PyTorch, differentiable
in ``feats``; RoReg's pipeline does not use it.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.sparse.kernel_map import lookup, pack_keys
from roreg_tpu_torch.sparse.voxelize import AXIS_BITS, SENTINEL, exact_divisor

__all__ = ["interpolate"]

_CORNERS = [(i >> 2 & 1, i >> 1 & 1, i & 1) for i in range(8)]


def interpolate(keys: torch.Tensor, feats: torch.Tensor, origin: torch.Tensor,
                queries: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """keys (M,) sorted packed voxel keys (SENTINEL pads); feats (M, C);
    origin (3,) int32, the shift applied at voxelisation (stored coords =
    floor(p / vs) - origin); queries (Q, 3) world points -> (Q, C), zero
    where every corner is absent."""
    g = queries / exact_divisor(voxel_size, queries.device, queries.dtype) - origin.to(queries.dtype)
    base = torch.floor(g)
    frac = g - base
    base = base.to(torch.int32)
    out = torch.zeros((queries.shape[0], feats.shape[-1]), dtype=feats.dtype, device=feats.device)
    keys = keys.to(torch.int32).contiguous()
    for dx, dy, dz in _CORNERS:
        corner = base + torch.tensor([dx, dy, dz], dtype=torch.int32, device=base.device)
        ok = ((corner >= 0) & (corner < (1 << AXIS_BITS))).all(-1)
        qk = torch.where(ok, pack_keys(corner), torch.full((), SENTINEL, dtype=torch.int32, device=base.device))
        row = lookup(keys, qk).long()
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
        wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
        w = torch.where(row >= 0, wx * wy * wz, torch.zeros((), dtype=frac.dtype, device=frac.device))
        out = out + w[:, None] * feats[row.clamp_min(0)]
    return out
