"""Per-component validation metrics for the trainer's best-checkpoint gate.

Counterpart of ``roreg_tpu/train/validators.py`` (the reference's
``train/val.py``): GF's batch and whole-set nearest-neighbour recall of the
invariant descriptors and its rotation-index accuracy, ET's quaternion
angular error, RD's score separation, RM's pair_ok_rate. Each returns a
dict holding the trainer's gate metric (``trainer.name2metric``). The
networks run in eval mode (running statistics), without gradients.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from roreg_tpu_torch.core.group import get_group
from roreg_tpu_torch.core.so3 import quaternion_angle_deg
from roreg_tpu_torch.models.ops import group_correlation

__all__ = ["validate_gf", "validate_et", "validate_rd", "validate_rm", "make_val_fn"]


def _nn_recall(feats0: np.ndarray, feats1: np.ndarray) -> float:
    d = ((feats0[:, None] - feats1[None]) ** 2).sum(-1)
    return float((d.argmin(1) == np.arange(len(feats0))).mean())


@contextmanager
def _evaluating(net: torch.nn.Module):
    """``net`` in eval mode without gradients, its mode restored after."""
    was = net.training
    net.eval()
    try:
        with torch.no_grad():
            yield net
    finally:
        net.train(was)


def _dev(state) -> torch.device:
    return next(state.net.parameters()).device


def _t(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(dev)


def validate_gf(state, eval_fwd, batches) -> dict:
    dev = _dev(state)
    cay = torch.as_tensor(get_group(state.group_size).cayley, dtype=torch.long, device=dev)
    inv0, inv1, dr_ok = [], [], []
    with _evaluating(state.net) as net:
        for b in batches:
            o0, o1 = net(_t(b["feats0"], dev)), net(_t(b["feats1"], dev))
            inv0.append(o0["inv"].cpu().numpy())
            inv1.append(o1["inv"].cpu().numpy())
            pred = group_correlation(o0["eqv"], o1["eqv"], cay).argmax(-1).cpu().numpy()
            dr_ok.append(pred == np.asarray(b["true_idx"]))
    inv0, inv1 = np.concatenate(inv0), np.concatenate(inv1)
    n = len(batches)
    batch_recall = float(np.mean([_nn_recall(a, c) for a, c in zip(np.split(inv0, n), np.split(inv1, n))]))
    return {"whole_recall": _nn_recall(inv0, inv1), "batch_recall": batch_recall,
            "dr_accuracy": float(np.concatenate(dr_ok).mean())}


def validate_et(state, eval_fwd, batches) -> dict:
    dev = _dev(state)
    gf = state.frozen["gf"]
    errs = []
    with _evaluating(state.net) as net:
        for b in batches:
            f0, f1 = _t(b["feats0"], dev), _t(b["feats1"], dev)
            q = net(f0, f1, gf(f0)["eqv"], gf(f1)["eqv"], _t(b["true_idx"], dev).long())
            errs.append(quaternion_angle_deg(q, _t(b["delta_r"], dev)).cpu().numpy())
    errs = np.concatenate(errs)
    hist = np.array([np.mean((errs >= i) & (errs < i + 1)) for i in range(6)])
    return {"R_error": float(errs.mean()), "R_error_statics": hist}


def validate_rd(state, eval_fwd, batches) -> dict:
    """The score separation of low-error (< 15/60 in label units) and
    high-error matches, and the score-weighted mean label."""
    dev = _dev(state)
    ok_rates, avg_rdiffs = [], []
    with _evaluating(state.net) as net:
        for b in batches:
            scores = net(torch.cat([_t(b["feats0"], dev), _t(b["feats1"], dev)])).cpu().numpy()
            rdiffs = np.asarray(b["rdiffs"])
            bs = rdiffs.shape[0]
            s = scores[:bs] + scores[bs:]
            lo = rdiffs < 15 / 60
            hi = ~lo
            okscore = s[lo].mean() if lo.any() else 0.0
            falsescore = s[hi].mean() if hi.any() else (2.0 if lo.all() else 1.0)
            ok_rates.append((okscore - falsescore) / max(falsescore, 1e-12))
            sn = s / max(s.sum(), 1e-12)
            avg_rdiffs.append(float((sn * rdiffs).sum() * 60))
    return {"val_recall": float(np.mean(ok_rates)), "val_avgRdiffs": float(np.mean(avg_rdiffs))}


def validate_rm(state, eval_fwd, batches) -> dict:
    """pair_ok_rate: the gt-matched points whose predicted match is right."""
    dev = _dev(state)
    ok, base = 0, 0
    with _evaluating(state.net) as net:
        for b in batches:
            out = net(*(_t(b[k], dev) for k in ("feats0", "feats1", "keys0", "keys1", "mask0", "mask1")))
            matches0 = out["matches0"][0].cpu().numpy()
            gt, mask = np.asarray(b["matches0"])[0], np.asarray(b["mask0"])[0]
            has_gt = (gt != -1) & mask
            base += int(has_gt.sum())
            ok += int((matches0[has_gt] == gt[has_gt]).sum())
    return {"pair_ok_rate": ok / max(base, 1)}


_VALIDATORS = {"gf": validate_gf, "rd": validate_rd, "rm": validate_rm, "et": validate_et}


def make_val_fn(component: str, group_size: int, val_batches: list[dict], frozen: dict | None = None):
    """The ``val_fn(state, eval_fwd) -> metrics`` that the trainer's gate
    reads, over a held-out list of batches in the component's training
    format. ET's validation reads the frozen GF of the train state (pass
    ``frozen`` to the trainer); ``group_size`` and ``frozen`` are accepted
    for the JAX package's signature."""
    if component not in _VALIDATORS:
        raise ValueError(component)
    if component == "et" and (frozen is None or "gf" not in frozen):
        raise ValueError("ET validation needs the frozen GF variables")
    fn = _VALIDATORS[component]
    return lambda state, eval_fwd: fn(state, eval_fwd, val_batches)
