"""RM: the rotation-coherence matcher, graph attention + Sinkhorn OT.

Counterpart of ``roreg_tpu/models/rm.py``: two enhancement layers
(feature-space k = 16, then 8), each a cross-attention with a G-d
rotation-coherence indicator from the equivariant features and a
self-attention mixing position encoding, local features and a
rotation-consistency confidence; then a shared MLP, a score matrix, a
masked log-space Sinkhorn with a learned dustbin, and mutual-max match
extraction. Channels last; every stage masked, so variable point counts
ride a static capacity. Submodules carry the flax names, so
``weights.load_variables`` maps the JAX variables by path.

The training-only auxiliary score maps (``scores_other``, the per-layer
softmax products that ``train.losses.rm_loss`` reads) are computed only
with ``aux_scores=True``, as the reference's training does; the
registration pipeline builds RM without them. Every stage is
differentiable (the kNN indices come from stable sorts, the gathered rows
carry the gradient), so the training step back-propagates through all 100
Sinkhorn iterations.
"""

from __future__ import annotations

import torch
from torch import nn

from roreg_tpu_torch.core.group import IcosahedralGroup
from roreg_tpu_torch.models.ops import group_correlation

__all__ = ["RotationCoherenceMatcher", "sinkhorn_log", "extract_matches"]

_NEG = -1e9  # masking sentinel; every tensor it enters is f32


def _masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the point (and neighbour) axes, no affine
    parameters, biased variance. x (B, N[, K], C), mask (B, N). As in the
    reference, the statistics divide by the number of valid points, also
    where a neighbour axis is summed over."""
    axes = tuple(range(1, x.dim() - 1))
    m = mask
    while m.dim() < x.dim() - 1:
        m = m[..., None]
    w = m.to(x.dtype)[..., None]
    denom = w.sum(dim=axes, keepdim=True).clamp_min(1.0)
    mean = (x * w).sum(dim=axes, keepdim=True) / denom
    var = (((x - mean) ** 2) * w).sum(dim=axes, keepdim=True) / denom
    return (x - mean) * torch.rsqrt(var + eps)


class PointMLP(nn.Module):
    """dense -> instance norm -> ReLU -> dense, plus a dense residual
    projection where the widths differ."""

    def __init__(self, in_dim: int, mid_dim: int, out_dim: int):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, mid_dim)
        self.fc1 = nn.Linear(mid_dim, out_dim)
        self.res = nn.Linear(in_dim, out_dim) if in_dim != out_dim else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.fc1(torch.relu(_masked_instance_norm(self.fc0(x), mask)))
        return h if self.res is None else h + self.res(x)


class NeighborAttention(nn.Module):
    """Multi-head attention of each point over its k feature-space
    neighbours. query (B, M, C), key and value (B, M, K, C)."""

    def __init__(self, num_heads: int = 4, d_model: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.merge = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        q, k, v = self.proj_q(query), self.proj_k(key), self.proj_v(value)
        b, m, c = q.shape
        nk, h = k.shape[2], self.num_heads
        dh = c // h
        q = q.reshape(b, m, h, dh)
        k = k.reshape(b, m, nk, h, dh)
        v = v.reshape(b, m, nk, h, dh)
        prob = torch.softmax(torch.einsum("bmhd,bmkhd->bmhk", q, k) / dh**0.5, dim=-1)
        return self.merge(torch.einsum("bmhk,bmkhd->bmhd", prob, v).reshape(b, m, c))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, ...) -> (B, ..., ...)."""
    b = torch.arange(x.shape[0], device=x.device).view((-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def _topk_gather(query, target, feats, k, ref_mask, row_block=None):
    """Feature-space kNN: the top-k target columns of query @ target.T per
    query row (masked columns excluded), and the feats rows they pick.
    query (B, M, C), target (B, N, C), feats (B, N, C') -> idx (B, M, k),
    gathered (B, M, k, C'). Ties go to the lower index, as ``lax.top_k``
    orders them. ``row_block``: score the query rows in blocks of this many,
    so the (M, N) matrix is never held whole; the result is the same."""
    k = min(k, target.shape[1])
    neg = torch.where(ref_mask[:, None, :], 0.0, _NEG).to(torch.float32)  # (B, 1, N)

    def top(q):
        s = torch.einsum("bmf,bnf->bmn", q, target) + neg
        return torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]

    m = query.shape[1]
    if row_block is None or m <= row_block:
        idx = top(query)
    else:
        idx = torch.cat([top(query[:, i: i + row_block]) for i in range(0, m, row_block)], 1)
    return idx, _gather_rows(feats, idx)


class CrossAttentionBlock(nn.Module):
    def __init__(self, group: IcosahedralGroup, k: int, s2t: bool, row_block: int | None = None):
        super().__init__()
        self.k, self.s2t, self.row_block = k, s2t, row_block
        # the indicator contracts with the transposed Cayley table
        self.register_buffer(
            "cayley_t", torch.as_tensor(group.cayley.T.copy(), dtype=torch.long), persistent=False
        )
        self.cross_attn = NeighborAttention()
        self.merge = PointMLP(96, 64, 32)

    def forward(self, source, target, source_eqv, target_eqv, featinv, mask_s, mask_t):
        """source (B, M, C), target (B, N, C), *_eqv (B, ., G, C), featinv
        (B, M, C) -> (features (B, M, 32), rotation indicator (B, M, G))."""
        knn_idx, knn_fea = _topk_gather(source, target, target, self.k, mask_t, self.row_block)
        feat_out = self.cross_attn(source, knn_fea, knn_fea)
        feat_out = self.merge(torch.cat([featinv, source, feat_out], -1), mask_s)
        te_nn = _gather_rows(target_eqv, knn_idx[..., 0])  # nearest neighbour's (B, M, G, C)
        if self.s2t:
            r_ind = group_correlation(source_eqv, te_nn, self.cayley_t)
        else:
            r_ind = group_correlation(te_nn, source_eqv, self.cayley_t)
        return feat_out, r_ind


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class SelfAttentionBlock(nn.Module):
    def __init__(self, group: IcosahedralGroup, k: int, row_block: int | None = None):
        super().__init__()
        self.k, self.row_block = k, row_block
        self.pos_en = PointMLP(3, 64, 32)
        self.ambiguity = PointMLP(2 * group.size, 128, 32)
        self.val_en = PointMLP(96, 64, 32)
        self.self_attn = NeighborAttention()
        self.merge = PointMLP(96, 64, 32)

    def forward(self, feat, coor, r_ind, featinv, mask):
        knn_idx, knn_fea = _topk_gather(feat, feat, feat, self.k, mask, self.row_block)
        knn_coor = _gather_rows(coor, knn_idx) - coor[:, :, None, :]
        pos = self.pos_en(knn_coor, mask)
        # rotation-consistency confidence: the indicator and its masked max
        r_max = torch.where(mask[..., None], r_ind, _NEG).amax(1, keepdim=True)
        conf = self.ambiguity(torch.cat([r_ind, r_max.expand_as(r_ind)], -1), mask)
        pos, knn_n, conf = _unit(pos), _unit(knn_fea), _unit(conf)
        value = self.val_en(
            torch.cat([pos, knn_n, conf[:, :, None, :].expand_as(knn_n)], -1), mask
        )
        out = self.self_attn(feat, knn_n, value)
        return self.merge(torch.cat([featinv, feat, out], -1), mask)


class MergeInfoBlock(nn.Module):
    def __init__(self, group: IcosahedralGroup, k: int, row_block: int | None = None):
        super().__init__()
        self.cross_s2t = CrossAttentionBlock(group, k, True, row_block)
        self.self_s = SelfAttentionBlock(group, k, row_block)
        self.cross_t2s = CrossAttentionBlock(group, k, False, row_block)
        self.self_t = SelfAttentionBlock(group, k, row_block)

    def forward(self, s, t, s_eqv, t_eqv, s_coor, t_coor, s_inv, t_inv, mask_s, mask_t):
        s2t, r_s = self.cross_s2t(s, t, s_eqv, t_eqv, s_inv, mask_s, mask_t)
        es = self.self_s(s2t, s_coor, r_s, s_inv, mask_s)
        t2s, r_t = self.cross_t2s(t, s, t_eqv, s_eqv, t_inv, mask_t, mask_s)
        et = self.self_t(t2s, t_coor, r_t, t_inv, mask_t)
        return es, et


def sinkhorn_log(
    scores: torch.Tensor, bin_score: torch.Tensor, iters: int,
    mask_m: torch.Tensor, mask_n: torch.Tensor,
) -> torch.Tensor:
    """Masked log-space Sinkhorn OT with a learned dustbin. Valid rows and
    columns get mass 1/(ms+ns); each dustbin absorbs the other side's mass.
    scores (B, M, N) f32 -> (B, M+1, N+1) log-coupling * (ms+ns)."""
    b, m, n = scores.shape
    dev, dt = scores.device, scores.dtype
    ms = mask_m.sum(-1).to(dt)
    ns = mask_n.sum(-1).to(dt)
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    ok = torch.cat([mask_m, ones], 1)[:, :, None] & torch.cat([mask_n, ones], 1)[:, None, :]
    z = bin_score.to(dt).expand(b, m + 1, n + 1).clone()
    z[:, :m, :n] = scores
    z = torch.where(ok, z, _NEG)

    norm = -torch.log(ms + ns)  # (B,)
    log_mu = torch.cat([torch.where(mask_m, norm[:, None], _NEG), (torch.log(ns) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(mask_n, norm[:, None], _NEG), (torch.log(ms) + norm)[:, None]], 1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    out = z + u[:, :, None] + v[:, None, :] - norm[:, None, None]
    return torch.where(ok, out, _NEG)


def extract_matches(scores_bin: torch.Tensor, mask_m: torch.Tensor, mask_n: torch.Tensor):
    """Mutual-max correspondences: matches0 (B, M) with -1 where invalid,
    and matching scores (B, M). Ties go to the first maximum, as
    ``jnp.argmax`` takes it."""
    core = scores_bin[:, :-1, :-1]
    core = torch.where(mask_m[:, :, None] & mask_n[:, None, :], core, _NEG)
    max0 = core.amax(2)
    idx0 = core.argmax(2)
    idx1 = core.argmax(1)
    mutual0 = idx1.gather(1, idx0) == torch.arange(core.shape[1], device=core.device)[None]
    valid0 = mutual0 & mask_m & mask_n.gather(1, idx0)
    mscores = torch.where(valid0, torch.exp(max0), 0.0)
    matches0 = torch.where(valid0, idx0, -1)
    return matches0, mscores


class RotationCoherenceMatcher(nn.Module):
    """The full RM network. ``row_block``: blocked kNN rows (None scores
    the whole (M, N) matrix at once). ``aux_scores``: also return the
    training loss's per-layer score maps ``scores_other``."""

    def __init__(
        self, group: IcosahedralGroup, ks: tuple[int, ...] = (16, 8), coor_norm_step: float = 0.025,
        sinkhorn_iters: int = 100, init_bin_score: float = 0.2, row_block: int | None = None,
        aux_scores: bool = False,
    ):
        super().__init__()
        self.aux_scores = aux_scores
        self.coor_norm_step = coor_norm_step
        self.sinkhorn_iters = sinkhorn_iters
        self.num_layers = len(ks)
        for i, k in enumerate(ks):
            self.add_module(f"layer{i}", MergeInfoBlock(group, k, row_block))
        self.final_mlp = PointMLP(64, 64, 32)
        self.bin_score = nn.Parameter(torch.tensor(init_bin_score, dtype=torch.float32))

    def forward(self, feats0, feats1, keys0, keys1, mask0, mask1) -> dict[str, torch.Tensor]:
        """feats* (B, N, G, 32) descriptor group features, keys* (B, N, 3),
        mask* (B, N) bool -> scores (B, M+1, N+1) log-OT, matches0/1,
        matching_scores0/1, the final embeddings, and with ``aux_scores``
        scores_other (B, M, N, layers)."""
        s_eqv, t_eqv = feats0, feats1
        s_coor, t_coor = keys0 / self.coor_norm_step, keys1 / self.coor_norm_step
        s_inv, t_inv = s_eqv.mean(2), t_eqv.mean(2)
        s, t = s_inv, t_inv
        layers = []
        for i in range(self.num_layers):
            s, t = self._modules[f"layer{i}"](
                s, t, s_eqv, t_eqv, s_coor, t_coor, s_inv, t_inv, mask0, mask1
            )
            layers.append((s, t))
        pair_ok = mask0[:, :, None] & mask1[:, None, :]
        scores_other = None
        if self.aux_scores:  # each layer's softmax-product score map
            so = torch.stack([torch.einsum("bmf,bnf->bmn", a, b) for a, b in layers], -1)
            so = torch.where(pair_ok[..., None], so, _NEG)
            scores_other = torch.softmax(so, 1) * torch.softmax(so, 2)
        s_final = self.final_mlp(torch.cat([s_inv, s], -1), mask0)
        t_final = self.final_mlp(torch.cat([t_inv, t], -1), mask1)
        score = torch.where(pair_ok, torch.einsum("bmf,bnf->bmn", s_final, t_final), _NEG)
        scores_bin = sinkhorn_log(score, self.bin_score, self.sinkhorn_iters, mask0, mask1)
        matches0, mscores0 = extract_matches(scores_bin, mask0, mask1)
        matches1, mscores1 = extract_matches(scores_bin.transpose(1, 2), mask1, mask0)
        out = {
            "scores": scores_bin,
            "matches0": matches0,
            "matches1": matches1,
            "matching_scores0": mscores0,
            "matching_scores1": mscores1,
            "source_final": s_final,
            "target_final": t_final,
        }
        if scores_other is not None:
            out["scores_other"] = scores_other
        return out
