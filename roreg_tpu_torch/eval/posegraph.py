"""Scene-level pose-graph synchronization over pairwise transforms.

Counterpart of ``roreg_tpu/eval/posegraph.py`` on torch tensors, on the
caller's device, in float32 as there. Given a scene's pairwise transforms
{T_ij} and their confidence weights (RANSAC overlap scores), recover
cycle-consistent absolute poses {P_i} and replace each pairwise estimate
with ``P_i^{-1} P_j``, so that a single bad pair is overruled by the
consistent majority.

1. Rotation averaging by spectral relaxation: the top-3 eigenspace of the
   (3N, 3N) block matrix ``M[i, j] = w_ij R_ij`` (plus the degrees on the
   diagonal), found by 24 QR subspace iterations from the identity, gives
   the absolute rotations up to a global gauge; a reflection gauge is
   turned into a rotation, and each block is projected onto SO(3) by SVD.
2. Translation sync: ``c_j - c_i ~= Q_i t_ij`` as a weighted graph
   Laplacian solve with the gauge ``c_0 = 0``.
3. :func:`synchronize_robust` repeats 1-2 three times with Cauchy weights
   on each edge's residual (IRLS), so that a grossly inconsistent edge is
   voted down.

These are small dense solves (N <= ~60 fragments a scene) with no kernel
of their own: ``torch.linalg`` serves. QR and SVD may pick other signs on
the card than on the CPU; the absolute poses then differ by a gauge, and
the refined pairwise transforms do not.

Convention as the reference's gt: T_ij satisfies ``pts_i = R_ij pts_j +
t_ij``; poses satisfy ``x_world = P_i x_i``, so ``T_ij ~= P_i^{-1} P_j``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from roreg_tpu_torch.device import resolve_device

__all__ = ["synchronize", "synchronize_robust", "refined_pairwise", "sync_scene"]


def _project_so3(M: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> nearest rotation (proper, det +1) via SVD."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (U * D[..., None, :]) @ Vt


def _blocks(M: torch.Tensor) -> torch.Tensor:
    """(N, N, 3, 3) blocks -> the (3N, 3N) matrix."""
    n = M.shape[0]
    return M.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def synchronize(
    edges: torch.Tensor,
    Ts: torch.Tensor,
    weights: torch.Tensor,
    n_nodes: int,
    iters: int = 24,
) -> torch.Tensor:
    """edges (E, 2) node pairs (i, j), Ts (E, 4, 4) pairwise transforms
    (pts_i = T_ij pts_j), weights (E,) non-negative confidences -> (n_nodes,
    4, 4) absolute poses P with T_ij ~= P_i^{-1} P_j."""
    dev, f32 = Ts.device, torch.float32
    R = Ts[:, :3, :3]
    t = Ts[:, :3, 3]
    i, j = edges[:, 0].long(), edges[:, 1].long()
    w = weights.clamp_min(1e-6)
    I3 = torch.eye(3, dtype=f32, device=dev)

    # block matrix M: M[i, j] += w R_ij, M[j, i] += w R_ij^T, degrees on the diagonal
    M = torch.zeros(n_nodes, n_nodes, 3, 3, dtype=f32, device=dev)
    M.index_put_((i, j), w[:, None, None] * R, accumulate=True)
    M.index_put_((j, i), w[:, None, None] * R.transpose(-1, -2), accumulate=True)
    deg = torch.zeros(n_nodes, dtype=f32, device=dev).index_add_(0, i, w).index_add_(0, j, w)
    M = M + torch.eye(n_nodes, dtype=f32, device=dev)[..., None, None] * (deg[:, None, None, None] * I3)
    M2 = _blocks(M)

    # subspace iteration for the top-3 eigenspace, from the identity gauge
    X = I3.repeat(n_nodes, 1)
    for _ in range(iters):
        X, _ = torch.linalg.qr(M2 @ X)
    # block i of X ~= Q_i^T O for an orthogonal gauge O, which cancels in
    # every pairwise product; a reflection gauge (det O = -1) would not
    # survive the per-block SO(3) projection, so flip the last column then
    s = torch.sign(torch.linalg.det(X.reshape(n_nodes, 3, 3)).sum())
    X = X * torch.stack([s.new_ones(()), s.new_ones(()), torch.where(s == 0, s.new_ones(()), s)])
    Q = _project_so3(X.reshape(n_nodes, 3, 3).transpose(-1, -2))

    # translations: poses [Q_i, c_i] give t_ij = Q_i^T (c_j - c_i), i.e.
    # c_j - c_i ~= Q_i t_ij, a weighted Laplacian system with c_0 = 0
    w2 = w * w
    L = torch.zeros(n_nodes, n_nodes, 3, 3, dtype=f32, device=dev)
    W = w2[:, None, None] * I3
    L.index_put_((i, i), W, accumulate=True)
    L.index_put_((j, j), W, accumulate=True)
    L.index_put_((i, j), -W, accumulate=True)
    L.index_put_((j, i), -W, accumulate=True)
    rhs = w2[:, None] * torch.einsum("eab,eb->ea", Q[i], t)
    b = torch.zeros(n_nodes, 3, dtype=f32, device=dev).index_add_(0, j, rhs).index_add_(0, i, -rhs)
    L[0, 0] += I3 * (1.0 + w2.sum())
    c = torch.linalg.solve(_blocks(L), b.reshape(-1)).reshape(n_nodes, 3)

    P = torch.eye(4, dtype=f32, device=dev).repeat(n_nodes, 1, 1)
    P[:, :3, :3] = Q
    P[:, :3, 3] = c
    return P


def synchronize_robust(
    edges: torch.Tensor,
    Ts: torch.Tensor,
    weights: torch.Tensor,
    n_nodes: int,
    iters: int = 24,
    irls_iters: int = 3,
    sigma_rot_deg: float = 10.0,
    sigma_trans: float = 0.15,
) -> torch.Tensor:
    """IRLS around :func:`synchronize`: ``irls_iters`` rounds re-weight
    each edge by ``w0 / (1 + (theta / sigma_r)^2 + (|dt| / sigma_t)^2)``
    from its residual against the synchronized poses, then a last solve.
    ``sigma_trans`` is in scene units."""
    R = Ts[:, :3, :3]
    t = Ts[:, :3, 3]
    w0 = weights.clamp_min(1e-6)
    sig_r = math.radians(sigma_rot_deg)
    w = w0
    for _ in range(irls_iters):
        T_pred = refined_pairwise(synchronize(edges, Ts, w, n_nodes, iters), edges)
        dR = T_pred[:, :3, :3].transpose(-1, -2) @ R
        cos = ((dR[:, 0, 0] + dR[:, 1, 1] + dR[:, 2, 2] - 1.0) * 0.5).clamp(-1.0, 1.0)
        theta = torch.arccos(cos)
        dt = torch.linalg.norm(T_pred[:, :3, 3] - t, dim=-1)
        w = (w0 / (1.0 + (theta / sig_r) ** 2 + (dt / sigma_trans) ** 2)).clamp_min(1e-6)
    return synchronize(edges, Ts, w, n_nodes, iters)


def refined_pairwise(P: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) absolute poses + (E, 2) edges -> (E, 4, 4) cycle-consistent
    pairwise transforms T_ij = P_i^{-1} P_j."""
    Pi = P[edges[:, 0].long()]
    Pj = P[edges[:, 1].long()]
    Ri = Pi[:, :3, :3].transpose(-1, -2)
    T = torch.eye(4, dtype=P.dtype, device=P.device).repeat(edges.shape[0], 1, 1)
    T[:, :3, :3] = Ri @ Pj[:, :3, :3]
    T[:, :3, 3] = torch.einsum("eab,eb->ea", Ri, Pj[:, :3, 3] - Pi[:, :3, 3])
    return T


def sync_scene(
    pairs: list[tuple[int, int]],
    transforms: list[np.ndarray],
    overlaps: list[float] | np.ndarray,
    sigma_rot_deg: float = 10.0,
    sigma_trans: float | None = None,
    device=None,
) -> list[np.ndarray]:
    """A scene's pair list -> refined float32 (4, 4) transforms, computed on
    ``device`` (CUDA unless ``"cpu"`` is given).

    Node ids are remapped densely. ``sigma_trans`` (the IRLS translation
    residual scale, in scene units) defaults to 15 % of the median edge
    translation, floored at 0.15 m."""
    dev = resolve_device(device)
    ids = sorted({i for p in pairs for i in p})
    remap = {v: k for k, v in enumerate(ids)}
    edges = np.asarray([[remap[a], remap[b]] for a, b in pairs], np.int64)
    Ts = np.stack(transforms).astype(np.float32)
    w = np.asarray(overlaps, np.float32)
    if sigma_trans is None:
        tnorm = np.linalg.norm(Ts[:, :3, 3], axis=-1)
        sigma_trans = float(max(0.15, 0.15 * np.median(tnorm)))
    e = torch.from_numpy(edges).to(dev)
    P = synchronize_robust(
        e, torch.from_numpy(Ts).to(dev), torch.from_numpy(w).to(dev), len(ids),
        sigma_rot_deg=sigma_rot_deg, sigma_trans=sigma_trans,
    )
    T2 = refined_pairwise(P, e).cpu().numpy()
    return [T2[k] for k in range(len(pairs))]
