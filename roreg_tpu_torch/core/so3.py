"""SO(3) math: quaternions, nearest group element, residual quaternion.

Counterpart of ``roreg_tpu/core/so3.py`` on torch tensors.
Quaternion convention: (w, x, y, z), w >= 0.
"""

from __future__ import annotations

import torch

__all__ = [
    "matrix_from_quaternion",
    "quaternion_from_matrix",
    "nearest_group_index",
    "residual_quaternion",
]


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz -> (…, 3, 3). Normalizes the input quaternion."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], -2)


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) -> (…, 4) wxyz with w >= 0 (branchless Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], -1)

    case = torch.stack([tw, tx, ty, tz], -1).argmax(-1)
    cands = torch.stack([qw, qx, qy, qz], -2)  # (..., 4 cases, 4)
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def nearest_group_index(R: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """argmin_g angle(R, R_g): max trace(R_g^T R), for (…, 3, 3) vs (G, 3, 3)."""
    tr = torch.einsum("gij,...ij->...g", rotations.to(R.dtype), R)
    return tr.argmax(-1)


def residual_quaternion(
    R: torch.Tensor, idx: torch.Tensor, rotations: torch.Tensor
) -> torch.Tensor:
    """deltaR = R @ R_anchor^T as a quaternion."""
    anchor = rotations.to(R.dtype)[idx]
    return quaternion_from_matrix(torch.einsum("...ij,...kj->...ik", R, anchor))
