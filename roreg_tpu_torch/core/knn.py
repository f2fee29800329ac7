"""Brute-force kNN: tiled distance matmuls + top-k / argmin.

Counterpart of ``roreg_tpu/core/knn.py``. Distances are
``|q|^2 + |r|^2 - 2 q·r`` in float32, as in the reference, so that the two
packages rank neighbours from the same arithmetic. Queries run in row tiles
to bound the (tile, N) score block. Masked reference rows never win.
"""

from __future__ import annotations

import torch

__all__ = ["knn", "nn", "mutual_nn"]

_BIG = 1e12


def _pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    qq = (q * q).sum(-1, keepdim=True)
    rr = (r * r).sum(-1, keepdim=True).T
    return qq + rr - 2.0 * (q @ r.T)


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    k: int,
    ref_mask: torch.Tensor | None = None,
    tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs of each query: (dists (m, k), idx (m, k) int64)."""
    dists, idxs = [], []
    for q0 in range(0, query.shape[0], tile):
        d2 = _pairwise_sqdist(query[q0 : q0 + tile], ref)
        if ref_mask is not None:
            d2 = torch.where(ref_mask[None, :], d2, torch.full_like(d2, _BIG))
        if k == 1:
            d, i = d2.min(dim=1, keepdim=True)
        else:
            neg, i = torch.topk(-d2, k, dim=1)
            d = -neg
        dists.append(d)
        idxs.append(i)
    if not dists:
        empty = torch.empty((0, k), device=query.device)
        return empty, empty.long()
    return torch.cat(dists), torch.cat(idxs)


def nn(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor | None = None,
    tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour: (m,) dists and (m,) indices."""
    d, i = knn(query, ref, 1, ref_mask=ref_mask, tile=tile)
    return d[:, 0], i[:, 0]


def mutual_nn(
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    mask0: torch.Tensor | None = None,
    mask1: torch.Tensor | None = None,
    tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mutual nearest neighbours in feature space: ``nn01`` (m,) and
    ``is_mutual`` (m,) bool."""
    m, n = feats0.shape[0], feats1.shape[0]
    dev = feats0.device
    if mask0 is None:
        mask0 = torch.ones(m, dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones(n, dtype=torch.bool, device=dev)
    _, nn01 = nn(feats0, feats1, ref_mask=mask1, tile=tile)
    _, nn10 = nn(feats1, feats0, ref_mask=mask0, tile=tile)
    back = nn10[nn01]
    is_mutual = (back == torch.arange(m, device=dev)) & mask0 & mask1[nn01]
    return nn01, is_mutual
