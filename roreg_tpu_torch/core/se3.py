"""SE(3) helpers: rigid transforms, the weighted Kabsch fit and 3-point
hypotheses.

Counterpart of ``roreg_tpu/core/se3.py``. Transforms are (…, 4, 4) with
``points0 ≈ R @ points1 + t`` for ground-truth pairs.
"""

from __future__ import annotations

import torch

__all__ = [
    "transform_points",
    "make_transform",
    "kabsch_weighted",
    "three_points_to_transform",
    "refine_transform",
]


def transform_points(pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(…, N, 3), (…, 4, 4) -> (…, N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3), (…, 3) -> homogeneous (…, 4, 4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def kabsch_weighted(
    src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Weighted rigid fit ``dst ≈ R @ src + t`` with the proper-rotation
    guard (sign of det). (…, N, 3) inputs, weights (…, N)."""
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-12)
    c_src = torch.einsum("...n,...ni->...i", w, src)
    c_dst = torch.einsum("...n,...ni->...i", w, dst)
    src_c = src - c_src[..., None, :]
    dst_c = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", dst_c, w, src_c)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return make_transform(R, t)


def three_points_to_transform(kps0: torch.Tensor, kps1: torch.Tensor) -> torch.Tensor:
    """Rigid transform of (…, 3, 3) point triples: ``kps0 ≈ R kps1 + t``."""
    return kabsch_weighted(kps1, kps0, torch.ones(kps1.shape[:-1], dtype=kps1.dtype, device=kps1.device))


def refine_transform(
    keys0: torch.Tensor,
    keys1: torch.Tensor,
    T: torch.Tensor,
    scores: torch.Tensor,
    inlier_dist: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """One weighted-inlier refit: inliers of T weigh their matcher score,
    outliers 0. With no inlier left, T is kept."""
    d2 = ((keys0 - transform_points(keys1, T)) ** 2).sum(-1)
    w = torch.where(d2 < inlier_dist * inlier_dist, scores, torch.zeros_like(scores))
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
    no_inl = w.sum(-1, keepdim=True) < 1e-12
    w = torch.where(no_inl, torch.full_like(w, 1e-6), w)
    T_new = kabsch_weighted(keys1, keys0, w)
    return torch.where(no_inl[..., None], T, T_new)
