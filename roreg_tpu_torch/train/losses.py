"""Training losses for the four learned heads.

Counterparts of ``roreg_tpu/train/losses.py`` (the reference's
``train/loss.py``):

* ``gf_loss``: batch-hard margin contrastive loss on the invariant
  descriptors (log-softmax distances, margin 0.3, weight 5) plus the
  cross-entropy of the G-way rotation-index correlation;
* ``rd_loss``: mean-normalised scores weighting the SE(3) error labels;
* ``rm_loss``: the OT negative log-likelihood at gt pairs and at the
  dustbins, plus each layer's softmax-product auxiliary loss;
* ``et_loss``: the sum-reduction squared error of the residual quaternion.
"""

from __future__ import annotations

import torch

from roreg_tpu_torch.models.ops import group_correlation

__all__ = ["gf_loss", "rd_loss", "rm_loss", "et_loss", "name2loss"]


def gf_loss(
    inv0: torch.Tensor,
    inv1: torch.Tensor,
    eqv0: torch.Tensor,
    eqv1: torch.Tensor,
    true_idx: torch.Tensor,
    cayley: torch.Tensor,
    margin: float = 0.3,
    metric_weight: float = 5.0,
) -> tuple[torch.Tensor, dict]:
    """inv* (B, 32) invariant descriptors of matched pairs, eqv* (B, G, 32)
    equivariant descriptors, true_idx (B,) the gt group index; ``cayley``
    (G, G) long on the features' device."""
    b = inv0.shape[0]
    dist = ((inv0[:, None, :] - inv1[None, :, :]) ** 2).sum(-1)  # (B, B)
    logp = torch.log_softmax(dist, dim=1)
    loss_true = torch.diagonal(logp)
    loss_false = (logp + torch.eye(b, device=logp.device)).amin(1)
    metric = (loss_true - loss_false + margin).clamp_min(0.0).mean()
    score = group_correlation(eqv0, eqv1, cayley)  # (B, G)
    ce = -torch.log_softmax(score, dim=-1).gather(1, true_idx[:, None].long()).mean()
    acc = (score.argmax(-1) == true_idx).float().mean()
    return metric_weight * metric + ce, {"metric_loss": metric, "ce_loss": ce, "dr_acc": acc}


def rd_loss(scores: torch.Tensor, rdiffs: torch.Tensor) -> torch.Tensor:
    """scores (2B,) for the two sides of each match, rdiffs (B,) SE(3)
    error labels (quaternion distance + tdiff / 3)."""
    b = rdiffs.shape[0]
    s = scores[:b] + scores[b:]
    s = s / s.mean().clamp_min(1e-12)
    return (s * rdiffs).mean()


def rm_loss(
    scores_bin: torch.Tensor,
    scores_other: torch.Tensor,
    pairs: torch.Tensor,
    pair_mask: torch.Tensor,
    unpair0_mask: torch.Tensor,
    unpair1_mask: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """The OT loss summed over the batch (B = 1 in practice, as in the
    reference). scores_bin (B, M+1, N+1) log-OT output, scores_other
    (B, M, N, L) the layers' softmax products, pairs (B, P, 2) gt
    correspondences with pair_mask (B, P), unpair*_mask (B, M) / (B, N)
    the gt-unmatched points."""
    eps = 1e-5
    n_layers = scores_other.shape[-1]
    bidx = torch.arange(scores_bin.shape[0], device=scores_bin.device)[:, None]
    p0, p1 = pairs[..., 0].long(), pairs[..., 1].long()
    denom_p = pair_mask.sum(-1).clamp_min(1).to(scores_bin.dtype)
    zero = torch.zeros((), device=scores_bin.device)
    ploss = torch.where(pair_mask, -scores_bin[bidx, p0, p1], zero).sum(-1) / denom_p
    u0loss = (torch.where(unpair0_mask, -scores_bin[:, :-1, -1], zero).sum(-1)
              / unpair0_mask.sum(-1).clamp_min(1).to(scores_bin.dtype))
    u1loss = (torch.where(unpair1_mask, -scores_bin[:, -1, :-1], zero).sum(-1)
              / unpair1_mask.sum(-1).clamp_min(1).to(scores_bin.dtype))
    ot = (ploss + u0loss + u1loss).sum()
    at = scores_other[bidx, p0, p1]  # (B, P, L)
    aux = (torch.where(pair_mask[..., None], -torch.log(at + eps), zero).sum(1) / denom_p[:, None]).sum()
    return aux + n_layers * ot, {"ot_loss": ot, "aux_loss": aux}


def et_loss(q_pred: torch.Tensor, q_gt: torch.Tensor) -> torch.Tensor:
    """Sum-reduction squared error of quaternions."""
    return ((q_pred - q_gt) ** 2).sum()


name2loss = {"gf": gf_loss, "rd": rd_loss, "rm": rm_loss, "et": et_loss}
