"""Vectorised yohoo RANSAC on the compute device.

Counterparts of ``dr_index``, ``local_transforms``, ``score_hypotheses``
and ``yohoo_ransac`` in ``roreg_tpu/pipeline/estimator.py``. The random
permutation of hypotheses is an input: the reference draws it from a JAX
key, which torch cannot reproduce.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.core import se3
from roreg_tpu_torch.core.so3 import matrix_from_quaternion
from roreg_tpu_torch.models.ops import group_correlation

__all__ = ["dr_index", "local_transforms", "score_hypotheses", "yohoo_ransac"]


def dr_index(eqv0: torch.Tensor, eqv1: torch.Tensor, cayley: torch.Tensor) -> torch.Tensor:
    """Coarse group index per match; the permuted operand is the cloud-1
    feature, so index a satisfies cloud0 ~ R_a · cloud1."""
    return group_correlation(eqv1, eqv0, cayley).argmax(-1)


def local_transforms(quaternions, idx, keys0, keys1, rotations) -> torch.Tensor:
    """Per-correspondence hypothesis: R = R_residual @ R_anchor, t = k0 - R k1."""
    R = matrix_from_quaternion(quaternions) @ rotations.to(quaternions.dtype)[idx]
    t = keys0 - torch.einsum("mij,mj->mi", R, keys1)
    return se3.make_transform(R, t)


def score_hypotheses(T, keys0, keys1, scores, valid, inlier_dist) -> torch.Tensor:
    """Weighted-inlier overlap of each hypothesis: (H, 4, 4) -> (H,)."""
    moved = torch.einsum("hij,mj->hmi", T[:, :3, :3], keys1) + T[:, None, :3, 3]
    d2 = ((keys0[None] - moved) ** 2).sum(-1)
    inl = (d2 < inlier_dist * inlier_dist) & valid[None]
    denom = valid.sum().clamp_min(1)
    return torch.where(inl, scores[None], torch.zeros((), device=T.device)).sum(-1) / denom


def yohoo_ransac(
    perm: torch.Tensor,
    T_hyp: torch.Tensor,
    hyp_valid: torch.Tensor,
    keys0: torch.Tensor,
    keys1: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    inlier_dist: float,
    max_iter: int = 1000,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the first ``max_iter`` hypotheses of ``perm`` (a permutation of
    the H correspondences), keep the best, refine twice.

    Returns (T_best (4, 4), best_overlap (), winner ()), where ``winner``
    is the index of the correspondence whose hypothesis won.
    """
    take = perm[: min(max_iter, T_hyp.shape[0])]
    Ts = T_hyp[take]
    ov = score_hypotheses(Ts, keys0, keys1, scores, valid, inlier_dist)
    ov = torch.where(hyp_valid[take], ov, torch.full_like(ov, -1.0))
    best = ov.argmax()
    T_best = se3.refine_transform(keys0, keys1, Ts[best], scores, inlier_dist * 2.0, valid)
    T_best = se3.refine_transform(keys0, keys1, T_best, scores, inlier_dist, valid)
    return T_best, ov[best], take[best]
