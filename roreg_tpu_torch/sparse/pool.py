"""Sparse pooling, broadcast and pruning over masked static-shape rows.

Counterparts of ``local_pool``, ``global_pool``, ``global_broadcast`` and
``prune`` in ``roreg_tpu/sparse/pool.py`` (MinkowskiEngine's pooling,
broadcast and pruning ops over precomputed maps). FCGF itself uses none
of them; they let backbones beyond FCGF be written. Plain PyTorch: the
JAX package computes them with XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.sparse.kernel_map import SparseLevel

__all__ = ["local_pool", "global_pool", "global_broadcast", "prune"]

_NEG = -1e30


def _zero_pad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def local_pool(feats: torch.Tensor, nbr: torch.Tensor, out_mask: torch.Tensor, mode: str = "max") -> torch.Tensor:
    """Pooling over a gather table: feats (N, C), nbr (M, K) with -1 for
    absent, mode ``max`` or ``avg`` -> (M, C); a row with no neighbour and
    a pad row (``out_mask`` False) come out zero."""
    idx = nbr.long()
    g = feats[idx.clamp_min(0)]  # (M, K, C)
    ok = (idx >= 0)[..., None]
    if mode == "max":
        out = torch.where(ok, g, torch.full((), _NEG, dtype=g.dtype, device=g.device)).amax(1)
        out = torch.where(out <= _NEG / 2, torch.zeros((), dtype=g.dtype, device=g.device), out)
    elif mode == "avg":
        g = torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))
        out = g.sum(1) / ok.sum(1).clamp_min(1)
    else:
        raise ValueError(mode)
    return _zero_pad(out, out_mask)


def global_pool(feats: torch.Tensor, mask: torch.Tensor, mode: str = "avg") -> torch.Tensor:
    """Pool the valid rows to one vector: ``avg``, ``max`` (zero when no row
    is valid) or ``sum``."""
    m = mask[:, None]
    if mode == "avg":
        w = m.to(feats.dtype)
        return (feats * w).sum(0) / w.sum().clamp_min(1.0)
    if mode == "max":
        out = torch.where(m, feats, torch.full((), _NEG, dtype=feats.dtype, device=feats.device)).amax(0)
        return torch.where(out <= _NEG / 2, torch.zeros((), dtype=feats.dtype, device=feats.device), out)
    if mode == "sum":
        return torch.where(m, feats, torch.zeros((), dtype=feats.dtype, device=feats.device)).sum(0)
    raise ValueError(mode)


def global_broadcast(feats: torch.Tensor, global_vec: torch.Tensor, mask: torch.Tensor,
                     op: str = "add") -> torch.Tensor:
    """Add (``add``) or multiply (``mul``) a global vector onto every valid
    row; pad rows come out zero."""
    if op == "add":
        out = feats + global_vec[None, :]
    elif op == "mul":
        out = feats * global_vec[None, :]
    else:
        raise ValueError(op)
    return _zero_pad(out, mask)


def prune(level: SparseLevel, keep) -> SparseLevel:
    """Drop coordinates by mask: rows stay in place (keys stay sorted), the
    validity mask shrinks to ``mask & keep`` and ``num`` counts it. Tables
    built against a pruned level must filter hits through its mask."""
    new_mask = level.mask & keep
    return SparseLevel(keys=level.keys, coords=level.coords, mask=new_mask, num=new_mask.sum())
