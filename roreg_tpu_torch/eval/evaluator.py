"""Scene evaluator: describe each cloud once, register every pair of a
scene from the stored descriptors, and average FMR / IR / RR / RRE / RTE.

Counterpart of ``Evaluator`` in ``roreg_tpu/eval/evaluator.py``
(``describe_cloud`` with its descriptor store, ``process_scene``, ``run``)
for in-memory scenes (:class:`roreg_tpu_torch.data.synthetic.SyntheticScene`).
Pairs run one at a time through
``RegistrationPipeline.register_pair_from_descriptors``. The averages are
the reference's: FMR, IR and RR are means of per-scene means; RRE and RTE
are per-scene means over the registered pairs (180 and 1.0 for a scene
with none), averaged over scenes. Pose sync, ``pre.log`` and the Predator
RR are not ported (``rr_predator`` is None).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from roreg_tpu_torch.data.synthetic import SyntheticScene
from roreg_tpu_torch.eval.metrics import fmr_ir, registration_errors
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline, gf_apply

__all__ = ["Evaluator"]


@dataclass
class Evaluator:
    """``desc_store``: an optional dict ``{(scene name, cloud id): (bb, gf,
    det)}`` of device tensors, shared between evaluators whose pipelines
    share the backbone, GF and RD weights (chain variants, keynums), so
    that each cloud is described once. ``dropped_blocks`` holds the block
    engine's dropped block count of each cloud this evaluator described."""

    pipeline: RegistrationPipeline
    desc_store: dict | None = None
    dropped_blocks: dict = field(default_factory=dict)

    @torch.inference_mode()
    def describe_cloud(self, scene: SyntheticScene, pc_id: int):
        """-> (bb (K, G, 32), gf (K, G, 32), det (K,)) of one cloud."""
        key = (scene.name, str(pc_id))
        if self.desc_store is not None and key in self.desc_store:
            return self.desc_store[key]
        pipe = self.pipeline
        dropped: list[int] = []
        bb = pipe.extract(scene.clouds[pc_id], None, scene.keypoints[pc_id], dropped=dropped)
        gf = gf_apply(pipe.nets["gf"], bb, pipe.cfg)
        det = pipe.detect(gf, torch.ones(gf.shape[0], dtype=torch.bool, device=pipe.device))
        if dropped:
            self.dropped_blocks[key] = dropped[0]
        if self.desc_store is not None:
            self.desc_store[key] = (bb, gf, det)
        return bb, gf, det

    @torch.inference_mode()
    def process_scene(self, scene: SyntheticScene, seed: int = 0) -> dict:
        """Register every pair of ``scene`` (pairs (i, j), i < j, in order),
        each from the stored descriptors of its two clouds, with draws from a
        generator on the pipeline's device seeded with ``seed``. Returns
        per-pair lists: ``pairs``, ``transforms``, ``overlaps``, ``fmr``,
        ``ir``, ``rr``, and ``rre``/``rte`` of the registered pairs."""
        pipe = self.pipeline
        cfg = pipe.cfg
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        desc = [self.describe_cloud(scene, k) for k in range(len(scene.clouds))]
        kps = [pipe._tensor(kp) for kp in scene.keypoints]
        results = {k: [] for k in ("pairs", "transforms", "overlaps", "fmr", "ir", "rr", "rre", "rte")}
        for (i, j), T_gt in scene.gt.items():
            (bb0, gf0, det0), (bb1, gf1, det1) = desc[i], desc[j]
            out = pipe.register_pair_from_descriptors(
                bb0, gf0, det0, kps[i], bb1, gf1, det1, kps[j], generator=gen
            )
            km0 = kps[i][out["sample0"][out["m0"]]].cpu().numpy()
            km1 = kps[j][out["sample1"][out["m1"]]].cpu().numpy()
            T = out["transform"].double().cpu().numpy()
            fmr, ir = fmr_ir(km0, km1, out["est_valid"].cpu().numpy(), T_gt, cfg.tau_1, cfg.tau_2)
            rre, rte = registration_errors(T, T_gt)
            ok = float(rre < cfg.rr_rot_deg and rte < cfg.rr_trans)
            results["pairs"].append((i, j))
            results["transforms"].append(T)
            results["overlaps"].append(float(out["overlap"]))
            results["fmr"].append(fmr)
            results["ir"].append(ir)
            results["rr"].append(ok)
            if ok:
                results["rre"].append(rre)
                results["rte"].append(rte)
        return results

    def run(self, datasets: dict, seed: int = 0) -> dict:
        """Evaluate a group of scenes (``{name: SyntheticScene}``; other
        entries, such as ``wholesetname``, are skipped) and return the
        summary. ``pairs_per_sec`` counts the whole run, describes of
        clouds not yet in the store included."""
        fmrs, irs, rrs, rres, rtes = [], [], [], [], []
        t0 = time.perf_counter()
        n_pairs = 0
        for scene in datasets.values():
            if not isinstance(scene, SyntheticScene):
                continue
            res = self.process_scene(scene, seed)
            n_pairs += len(res["pairs"])
            fmrs.append(np.mean(res["fmr"]))
            irs.append(np.mean(res["ir"]))
            rrs.append(np.mean(res["rr"]))
            rres.append(np.mean(res["rre"]) if res["rre"] else 180.0)
            rtes.append(np.mean(res["rte"]) if res["rte"] else 1.0)
        elapsed = time.perf_counter() - t0
        return {
            "fmr": float(np.mean(fmrs)),
            "ir": float(np.mean(irs)),
            "rr_pointdsc": float(np.mean(rrs)),
            "rre": float(np.mean(rres)),
            "rte": float(np.mean(rtes)),
            "rr_predator": None,
            "pairs": n_pairs,
            "pairs_per_sec": n_pairs / max(elapsed, 1e-9),
        }
