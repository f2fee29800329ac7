"""The self-run pipeline that labels RD's training matches.

Counterpart of ``roreg_tpu/train/selfrun.py`` (the reference's
``train/trainset/RD.py``): the inference pipeline runs over the training
pairs, and each match's predicted transform, compared with the gt, becomes
the detector's label. Each cloud is described by the port's describe
(``RegistrationPipeline.describe``: the block engine's kernels under the
default config); a pair is matched by mutual NN over the group-mean
descriptors of all keypoints (the reference's ``matmul`` matcher at RD's
trainset defaults), or, with ``cfg.use_rm`` and RM weights, by RM on a
random ``keynum`` subset of each cloud; then the pair stage's group index
(``dr_index``), ET and the per-match transforms
(``estimator.local_transforms``).
"""

from __future__ import annotations

import numpy as np
import torch

from roreg_tpu_torch.pipeline import estimator as est
from roreg_tpu_torch.pipeline.matcher import mutual_match
from roreg_tpu_torch.pipeline.registration import et_apply, rm_apply

__all__ = ["build_rd_match_bank"]


def _match_mutual(gf0, gf1):
    """Mutual NN over the whole clouds' invariant descriptors -> match rows."""
    ones0 = torch.ones(gf0.shape[0], dtype=torch.bool, device=gf0.device)
    ones1 = torch.ones(gf1.shape[0], dtype=torch.bool, device=gf1.device)
    nn01, mut = mutual_match(gf0, gf1, ones0, ones1)
    m0 = torch.nonzero(mut)[:, 0]
    return m0, nn01[m0]


def _match_rm(pipe, rng_np, gf0, gf1, kp0, kp1):
    """RM on a random ``keynum`` subset of each cloud (no RD scores exist
    while RD's training set is made) -> match rows of the whole clouds."""
    keynum = pipe.cfg.keynum
    s0 = torch.as_tensor(rng_np.permutation(kp0.shape[0])[: min(keynum, kp0.shape[0])], device=kp0.device)
    s1 = torch.as_tensor(rng_np.permutation(kp1.shape[0])[: min(keynum, kp1.shape[0])], device=kp1.device)
    pair, valid, _ = rm_apply(pipe.nets["rm"], gf0[s0][None], gf1[s1][None], kp0[s0][None], kp1[s1][None])
    keep = torch.nonzero(valid[0])[:, 0]
    return s0[pair[0, keep, 0]], s1[keep]


@torch.inference_mode()
def build_rd_match_bank(pipe, scenes, seed: int = 0) -> list[dict]:
    """A list of {feats0, feats1 (M, G, 32) descriptor features of the
    matched keypoints, T_pre (M, 4, 4) each match's transform, T_gt (4, 4)},
    one entry per training pair with at least 8 matches (numpy arrays)."""
    cfg = pipe.cfg
    use_rm = bool(cfg.use_rm) and "rm" in pipe.nets
    rng_np = np.random.default_rng(seed)
    bank = []
    for ds in scenes:
        desc = {}
        for pc_id in ds.pc_ids:
            kp = pipe._tensor(ds.get_kps(pc_id).astype(np.float32))
            bb, gf = pipe.describe(ds.get_pc(pc_id).astype(np.float32), None, kp)
            desc[pc_id] = (bb, gf, kp)
        for id0, id1 in ds.pair_ids:
            (bb0, gf0, kp0), (bb1, gf1, kp1) = desc[id0], desc[id1]
            m0, m1 = _match_rm(pipe, rng_np, gf0, gf1, kp0, kp1) if use_rm else _match_mutual(gf0, gf1)
            if m0.shape[0] < 8:
                continue
            dr = est.dr_index(gf0[m0], gf1[m1], pipe.cayley)
            quats = et_apply(pipe.nets["et"], bb0[m0], bb1[m1], gf0[m0], gf1[m1], dr, cfg)
            T_pre = est.local_transforms(quats, dr, kp0[m0], kp1[m1], pipe.rotations)
            bank.append({
                "feats0": gf0[m0].cpu().numpy(),
                "feats1": gf1[m1].cpu().numpy(),
                "T_pre": T_pre.cpu().numpy(),
                "T_gt": ds.get_transform(id0, id1),
            })
    if not bank:
        raise RuntimeError("self-run produced no match banks (too few matches)")
    return bank
