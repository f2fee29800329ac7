"""Vectorised RANSAC on the compute device: yohoo (one-shot) and yohoc
(group-index voting).

Counterparts of ``dr_index``, ``local_transforms``, ``score_hypotheses``,
``yohoo_ransac``, ``_vote_probability`` and ``yohoc_ransac`` in
``roreg_tpu/pipeline/estimator.py``. The random draws are inputs (yohoo's
permutation of hypotheses, yohoc's buckets and Gumbel noise): the
reference draws them from a JAX key, which torch cannot reproduce.
:func:`yohoc_draws` draws yohoc's from a ``torch.Generator`` with the
reference's distributions.

Every function takes any leading (pair) axes and works on the last ones: a
batch of pairs is one call, each pair's draws are rows of the draw inputs,
and ties break as in the one-pair case, row by row.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.core import se3
from roreg_tpu_torch.core.so3 import matrix_from_quaternion
from roreg_tpu_torch.models.gf import des_to_dr_index

__all__ = [
    "dr_index",
    "local_transforms",
    "score_hypotheses",
    "yohoo_ransac",
    "yohoc_draws",
    "yohoc_ransac",
]

_NEG = -1e9  # f32 mask of non-members in the Gumbel top-3


def _rows(x: torch.Tensor, idx: torch.Tensor, feat_dims: int = 1) -> torch.Tensor:
    """x (..., M, *F), ``feat_dims`` = len(F), at rows idx (..., *S) with
    the same leading axes -> (..., *S, *F)."""
    lead = x.shape[: x.dim() - 1 - feat_dims]
    feat = x.shape[x.dim() - feat_dims:]
    flat = idx.reshape(*lead, -1)
    out = torch.take_along_dim(x.reshape(*lead, x.shape[len(lead)], -1), flat[..., None], dim=-2)
    return out.reshape(*idx.shape, *feat)


def dr_index(eqv0: torch.Tensor, eqv1: torch.Tensor, cayley: torch.Tensor) -> torch.Tensor:
    """Coarse group index per match; the permuted operand is the cloud-1
    feature, so index a satisfies cloud0 ~ R_a · cloud1."""
    return des_to_dr_index(eqv1, eqv0, cayley)


def local_transforms(quaternions, idx, keys0, keys1, rotations) -> torch.Tensor:
    """Per-correspondence hypothesis: R = R_residual @ R_anchor, t = k0 - R k1."""
    R = matrix_from_quaternion(quaternions) @ rotations.to(quaternions.dtype)[idx]
    t = keys0 - torch.einsum("...ij,...j->...i", R, keys1)
    return se3.make_transform(R, t)


def score_hypotheses(T, keys0, keys1, scores, valid, inlier_dist) -> torch.Tensor:
    """Weighted-inlier overlap of each hypothesis: (..., H, 4, 4) -> (..., H)."""
    moved = torch.einsum("...hij,...mj->...hmi", T[..., :3, :3], keys1) + T[..., :, None, :3, 3]
    d2 = ((keys0[..., None, :, :] - moved) ** 2).sum(-1)
    inl = (d2 < inlier_dist * inlier_dist) & valid[..., None, :]
    denom = valid.sum(-1, keepdim=True).clamp_min(1)
    return torch.where(inl, scores[..., None, :], torch.zeros((), device=T.device)).sum(-1) / denom


def _refine_best(keys0, keys1, T_best, scores, valid, inlier_dist):
    """The two weighted refits of a winning hypothesis."""
    T_best = se3.refine_transform(keys0, keys1, T_best, scores, inlier_dist * 2.0, valid)
    return se3.refine_transform(keys0, keys1, T_best, scores, inlier_dist, valid)


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
    """Score the first ``max_iter`` hypotheses of ``perm`` (..., H) (a
    permutation of the H correspondences per pair), keep the best, refine
    twice.

    Returns (T_best (..., 4, 4), best_overlap (...), winner (...)), where
    ``winner`` is the index of the correspondence whose hypothesis won.
    """
    take = perm[..., : min(max_iter, T_hyp.shape[-3])].long()
    Ts = _rows(T_hyp, take, 2)
    ov = score_hypotheses(Ts, keys0, keys1, scores, valid, inlier_dist)
    ov = torch.where(hyp_valid.gather(-1, take), ov, torch.full_like(ov, -1.0))
    best = ov.argmax(-1, keepdim=True)  # the first maximum, as jnp.argmax
    T_best = _refine_best(keys0, keys1, _rows(Ts, best, 2)[..., 0, :, :], scores, valid, inlier_dist)
    return T_best, ov.gather(-1, best)[..., 0], take.gather(-1, best)[..., 0]


def _vote_probability(votes: torch.Tensor) -> torch.Tensor:
    """Cubic vote weighting over the last axis: buckets with < 2 votes get
    0, else p ~ n/100 (n/100 - 0.01)(n/100 - 0.02), normalised; all 0 when
    no bucket has weight."""
    n = votes.to(torch.float32) / 100.0
    p = torch.where(votes >= 2, n * (n - 0.01) * (n - 0.02), torch.zeros_like(n))
    total = p.sum(-1, keepdim=True)
    return torch.where(total > 0, p / total.clamp_min(1e-12), torch.zeros_like(p))


def _bucket_probability(indices, valid, group_size):
    """(vote probability (..., G), degenerate (...)) of the valid matches'
    group indices."""
    slot = torch.where(valid, indices, torch.full_like(indices, group_size))  # invalid -> dropped
    votes = torch.zeros(indices.shape[:-1] + (group_size + 1,), dtype=torch.int32, device=indices.device)
    votes.scatter_add_(-1, slot, torch.ones_like(slot, dtype=torch.int32))
    prob = _vote_probability(votes[..., :group_size])
    return prob, prob.sum(-1) < 1e-12


def yohoc_draws(
    indices: torch.Tensor,
    valid: torch.Tensor,
    max_iter: int,
    group_size: int,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """yohoc's draws from ``generator`` (on its device; the CPU's default
    generator when none is given) for matches (..., M): ``buckets``
    (..., max_iter), each drawn from its pair's vote probability (uniform
    when it is degenerate), and standard Gumbel noise ``gumbel``
    (..., max_iter, M). Returned on ``indices``'s device."""
    dev = generator.device if generator is not None else torch.device("cpu")
    lead = indices.shape[:-1]
    prob, degenerate = _bucket_probability(indices, valid, group_size)
    safe = torch.where(degenerate[..., None], torch.full_like(prob, 1.0 / group_size), prob)
    buckets = torch.multinomial(safe.to(dev).reshape(-1, group_size), max_iter, replacement=True,
                                generator=generator).reshape(*lead, max_iter)
    u = torch.rand(*lead, max_iter, indices.shape[-1], generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return buckets.to(indices.device), gumbel.to(indices.device)


def yohoc_ransac(
    buckets: torch.Tensor,
    gumbel: torch.Tensor,
    indices: torch.Tensor,
    keys0: torch.Tensor,
    keys1: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    inlier_dist: float,
    group_size: int = 60,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-index-voting RANSAC: iteration i takes the 3 valid matches of
    group index ``buckets[..., i]`` with the largest ``gumbel[..., i, :]``
    (a uniform triple of the bucket), fits Kabsch and scores the
    weighted-inlier overlap; the best hypothesis is refined twice.
    Iterations whose bucket has < 2 members score -1, and all do when no
    bucket has 2 votes.

    indices (..., M): each match's coarse group index. Returns (T_best
    (..., 4, 4), best_overlap (...), winner (...)), ``winner`` the winning
    iteration.
    """
    _, degenerate = _bucket_probability(indices, valid, group_size)
    member_ok = (indices[..., None, :] == buckets[..., :, None]) & valid[..., None, :]
    glogits = torch.where(member_ok, gumbel, torch.full_like(gumbel, _NEG))
    # the top 3, ties (the _NEG non-members of a bucket with < 3 members) to
    # the lower index, as jax.lax.top_k orders them
    triples = torch.sort(glogits, dim=-1, descending=True, stable=True).indices[..., :3]
    Ts = se3.three_points_to_transform(_rows(keys0, triples), _rows(keys1, triples))
    ov = score_hypotheses(Ts, keys0, keys1, scores, valid, inlier_dist)
    enough = (member_ok.sum(-1) >= 2) & ~degenerate[..., None]
    ov = torch.where(enough, ov, torch.full_like(ov, -1.0))
    best = ov.argmax(-1, keepdim=True)
    T_best = _refine_best(keys0, keys1, _rows(Ts, best, 2)[..., 0, :, :], scores, valid, inlier_dist)
    return T_best, ov.gather(-1, best)[..., 0], best[..., 0]
