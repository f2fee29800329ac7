"""Keypoint sampling (rank normalisation + spatial NMS), mutual matching
and the RM chain's top-match selection.

Counterparts of ``rank_normalize``, ``nms_sample``, ``mutual_match`` and
``top_match_subset`` in ``roreg_tpu/pipeline/matcher.py``.
``top_k_indices``, ``mutual_match`` and ``top_match_subset`` take any
leading (pair) axes and work on the last ones; ties keep the lower index
in every row.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.core.knn import knn, mutual_nn

__all__ = ["rank_normalize", "top_k_indices", "nms_sample", "mutual_match", "top_match_subset"]

_BIG = 1e9


def rank_normalize(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """scores -> ranks/n in [0, 1); pad rows get -1. Ranks are distinct,
    so NMS comparisons have no ties."""
    n = scores.shape[0]
    s = torch.where(mask, scores, torch.full_like(scores, -_BIG))
    order = torch.argsort(s, stable=True)
    ranks = torch.empty(n, dtype=torch.float32, device=s.device)
    ranks[order] = torch.arange(n, dtype=torch.float32, device=s.device)
    nvalid = mask.sum()
    r = ranks - (n - nvalid)
    return torch.where(mask, r / nvalid.clamp_min(1), torch.full_like(r, -1.0))


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, ties to the
    lower index (the order ``jax.lax.top_k`` gives; ``torch.topk`` leaves
    tie order open)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def nms_sample(
    keys: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor, num: int, k: int = 5
) -> torch.Tensor:
    """Spatial NMS + top-up to exactly ``num`` indices: points that are the
    max of their k-NN neighbourhood first (by score), then the rest. The
    survivors' priorities tie in f32 (score + 1e9), so their order is the
    index order, as in the reference."""
    s = torch.where(mask, scores, torch.full_like(scores, -_BIG))
    _, nbr = knn(keys, keys, k, ref_mask=mask)
    keep = (s >= s[nbr].amax(-1)) & mask
    prio = torch.where(keep, s + _BIG, s)
    return top_k_indices(prio, num)


def mutual_match(feats0, feats1, mask0, mask1):
    """Group-mean invariant features (..., M, G, C), (..., N, G, C) ->
    mutual NN: (nn01 (..., M), is_mutual (..., M))."""
    inv0 = feats0.mean(-2)
    inv1 = feats1.mean(-2)
    inv0 = inv0 / (torch.linalg.norm(inv0, dim=-1, keepdim=True) + 1e-5)
    inv1 = inv1 / (torch.linalg.norm(inv1, dim=-1, keepdim=True) + 1e-5)
    return mutual_nn(inv0, inv1, mask0=mask0, mask1=mask1)


def top_match_subset(scores: torch.Tensor, valid: torch.Tensor, match_n: float) -> torch.Tensor:
    """RM top-match selection mask over the last axis: keep the best
    ``match_n`` fraction (at least 10) of the valid matches by score.
    ``match_n`` in [0.999, 1) keeps them all (the reference's "use all"
    setting); ``match_n`` >= 1 is a count. Equal scores keep the lower
    index first (a stable sort, as ``jnp.argsort``)."""
    nvalid = valid.sum(-1, keepdim=True)
    if match_n >= 1.0:
        num = nvalid.clamp_max(int(match_n))
    elif match_n >= 0.999:
        num = nvalid
    else:
        num = torch.minimum((nvalid * match_n).to(torch.int32).clamp_min(10), nvalid)
    s = torch.where(valid, scores, torch.full_like(scores, -_BIG))
    order = torch.argsort(-s, dim=-1, stable=True)
    ids = torch.arange(s.shape[-1], device=s.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ids)
    return valid & (rank < num)
