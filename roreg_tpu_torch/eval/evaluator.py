"""Scene evaluator: describe each cloud once, register every pair of a
scene from the stored descriptors, average FMR / IR / RR / RRE / RTE, and
score the Predator protocol's RR.

Counterpart of ``Evaluator`` in ``roreg_tpu/eval/evaluator.py``. A scene is
a ``data.dataset.ThreeDMatchDataset`` (files in the 3DMatch layout) or a
``data.synthetic.SyntheticScene`` (in memory); both are read through one
interface. Descriptors can be kept in a shared store of device tensors
(``desc_store``) and in an npz cache on disk (``cache_dir``), in the JAX
package's layout, so that either package reads the other's files. Pairs
run ``cfg.eval_pair_batch`` at a time through
``dist.eval.pair_batch_from_stacks``, as the JAX package's evaluator runs
them. The averages are
the reference's: FMR, IR and RR are means of per-scene means; RRE and RTE
are per-scene means over the registered pairs (180 and 1.0 for a scene
with none), averaged over scenes. With ``cfg.pose_sync`` a scene of 3 pairs
or more has its transforms refined by ``eval.posegraph.sync_scene``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from roreg_tpu_torch.data.dataset import ThreeDMatchDataset
from roreg_tpu_torch.data.synthetic import SyntheticScene
from roreg_tpu_torch.eval.benchmark import benchmark_arrays, write_trajectory
from roreg_tpu_torch.eval.metrics import fmr_ir, registration_errors
from roreg_tpu_torch.eval.posegraph import sync_scene
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline, gf_apply
from roreg_tpu_torch.utils.profiling import StageTimer

__all__ = ["Evaluator", "cache_path"]

SCENE_TYPES = (ThreeDMatchDataset, SyntheticScene)


def cache_path(cache_dir: str, scene_name: str, pc_id) -> str:
    """The npz descriptor cache file of one cloud:
    ``<cache_dir>/<scene name with / as _>/<id>.npz`` (keys ``bb``, ``gf``,
    ``det``)."""
    return os.path.join(cache_dir, scene_name.replace("/", "_"), f"{pc_id}.npz")


@dataclass
class Evaluator:
    """``cache_dir``: an optional npz descriptor cache, read before a cloud
    is described and written after. ``results_log``: a file that
    :meth:`run` appends its summary block to. ``desc_store``: an optional
    dict ``{(scene name, cloud id): (bb, gf, det)}`` of device tensors,
    shared between evaluators whose pipelines share the backbone, GF and
    RD weights (chain variants, keynums), so that each cloud is described
    once. ``dropped_blocks`` holds the block engine's dropped block count of
    each cloud this evaluator described."""

    pipeline: RegistrationPipeline
    cache_dir: str | None = None
    results_log: str | None = None
    desc_store: dict | None = None
    dropped_blocks: dict = field(default_factory=dict)

    def __post_init__(self):
        self.timer = StageTimer()

    @torch.inference_mode()
    def describe_cloud(self, ds, pc_id):
        """-> (bb (K, G, 32), gf (K, G, 32), det (K,)) of one cloud."""
        if self.desc_store is not None:
            key = (ds.name, str(pc_id))
            if key not in self.desc_store:
                self.desc_store[key] = self._describe_uncached(ds, pc_id)
            return self.desc_store[key]
        return self._describe_uncached(ds, pc_id)

    def _describe_uncached(self, ds, pc_id):
        pipe = self.pipeline
        cache_fn = cache_path(self.cache_dir, ds.name, pc_id) if self.cache_dir else None
        if cache_fn and os.path.exists(cache_fn):
            with np.load(cache_fn) as z:
                return tuple(pipe._tensor(z[k]) for k in ("bb", "gf", "det"))
        kp = ds.get_kps(pc_id).astype(np.float32)
        dropped: list[int] = []
        with self.timer.stage("describe"):
            bb = pipe.extract(ds.get_pc(pc_id).astype(np.float32), None, kp, dropped=dropped)
            gf = gf_apply(pipe.nets["gf"], bb, pipe.cfg)
        with self.timer.stage("detect"):
            det = pipe.detect(gf, torch.ones(gf.shape[0], dtype=torch.bool, device=pipe.device))
        self.timer.block("describe_wait", (bb, gf, det))
        if dropped:
            self.dropped_blocks[(ds.name, str(pc_id))] = dropped[0]
        if cache_fn:
            os.makedirs(os.path.dirname(cache_fn), exist_ok=True)
            np.savez(cache_fn, **{k: v.float().cpu().numpy() for k, v in (("bb", bb), ("gf", gf), ("det", det))})
        return bb, gf, det

    @torch.inference_mode()
    def process_scene(self, ds, seed: int = 0) -> dict:
        """Register every pair of ``ds`` in the order of its gt,
        ``cfg.eval_pair_batch`` pairs a call of
        ``dist.eval.pair_batch_from_stacks``, with draws from a generator on
        the pipeline's device seeded with ``seed``. The scene's clouds are
        stacked on the device once: with RD each cloud's keypoints are
        sampled once (NMS is deterministic, so every pair would sample the
        same set); without RD the stacks hold the full descriptors and each
        (pair, side) draws its own ``keynum`` subset from noise of shape
        (B, 2, K), drawn batch by batch, so pairs that share a cloud sample
        independently. The last batch is padded with duplicates of its last
        pair, whose rows are dropped before any metric. Every batch is
        launched before any is read back. Returns per-pair lists: ``pairs``
        (int ids), ``transforms`` (float32), ``overlaps``, ``fmr``, ``ir``,
        ``rr``, and ``rre``/``rte`` of the registered pairs; with pose sync
        also ``transforms_raw``."""
        from roreg_tpu_torch.dist.eval import pair_batch_from_stacks

        pipe = self.pipeline
        cfg = pipe.cfg
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        per_pair = not cfg.use_rd
        rows, id2row = [], {}
        for pc_id in ds.pc_ids:
            bb, gf, det = self.describe_cloud(ds, pc_id)
            kp = pipe._tensor(ds.get_kps(pc_id).astype(np.float32))
            if not per_pair:
                s = pipe.sample_keypoints(kp, det, torch.ones(kp.shape[0], dtype=torch.bool, device=pipe.device))
                bb, gf, kp = bb[s], gf[s], kp[s]
            id2row[pc_id] = len(rows)
            rows.append((bb, gf, kp))
        stacks = [torch.stack([r[i] for r in rows]) for i in range(3)]
        del rows

        pair_ids = list(ds.pair_ids)
        nb = max(1, cfg.eval_pair_batch)
        launched = []
        for b0 in range(0, len(pair_ids), nb):
            batch = pair_ids[b0:b0 + nb]
            padded = batch + [batch[-1]] * (nb - len(batch))
            i0 = torch.tensor([id2row[p[0]] for p in padded], device=pipe.device)
            i1 = torch.tensor([id2row[p[1]] for p in padded], device=pipe.device)
            noise = None
            if per_pair:
                noise = torch.rand((nb, 2, stacks[2].shape[1]), generator=gen, device=pipe.device)
            out = pair_batch_from_stacks(pipe, i0, i1, *stacks, noise=noise, per_pair_sample=per_pair,
                                         generator=gen)
            launched.append((batch, out))

        results = {k: [] for k in ("pairs", "transforms", "overlaps", "fmr", "ir", "rr", "rre", "rte")}
        for batch, out in launched:
            self.timer.block("match_estimate", out["transform"])
            host = {k: v[: len(batch)].cpu().numpy() for k, v in out.items()}  # the padded rows go
            for k, (id0, id1) in enumerate(batch):
                T, T_gt = host["transform"][k], ds.get_transform(id0, id1)
                fmr, ir = fmr_ir(host["keys_m0"][k], host["keys_m1"][k], host["est_valid"][k], T_gt,
                                 cfg.tau_1, cfg.tau_2)
                rre, rte = registration_errors(T, T_gt)
                ok = float(rre < cfg.rr_rot_deg and rte < cfg.rr_trans)
                results["pairs"].append((int(id0), int(id1)))
                results["transforms"].append(T)
                results["overlaps"].append(float(host["overlap"][k]))
                results["fmr"].append(fmr)
                results["ir"].append(ir)
                results["rr"].append(ok)
                if ok:
                    results["rre"].append(rre)
                    results["rte"].append(rte)
        if cfg.pose_sync and len(results["pairs"]) >= 3:
            self._apply_pose_sync(ds, results)
        return results

    def _apply_pose_sync(self, ds, results) -> None:
        """Replace the pairwise transforms with the cycle-consistent
        refinement (``eval/posegraph.py``) and recompute RR/RRE/RTE on the
        refined set."""
        cfg = self.pipeline.cfg
        refined = sync_scene(results["pairs"], results["transforms"], results["overlaps"],
                             device=self.pipeline.device)
        results["transforms_raw"] = results["transforms"]
        results["transforms"] = refined
        results["rr"], results["rre"], results["rte"] = [], [], []
        for (id0, id1), T in zip(results["pairs"], refined):
            rre, rte = registration_errors(T, ds.get_transform(id0, id1))
            ok = float(rre < cfg.rr_rot_deg and rte < cfg.rr_trans)
            results["rr"].append(ok)
            if ok:
                results["rre"].append(rre)
                results["rte"].append(rte)

    def run(self, datasets: dict, out_dir: str | None = None, seed: int = 0) -> dict:
        """Evaluate a named group of scenes (``{name: scene}``; other
        entries, such as ``wholesetname``, are skipped) and return the
        summary. With ``out_dir``, each scene's transforms go to
        ``<out_dir>/<scene name with / as _>/pre.log``. ``rr_predator`` is
        the Predator protocol's RR over the scenes that have gt.info
        matrices (non-consecutive pairs only, except for WHU-TLS; RMSE
        threshold ``tau_3``), None where no scene counts. With
        ``results_log`` the summary is appended there as a block.
        ``pairs_per_sec`` counts the whole run, describes of clouds not yet
        in the store or the cache included."""
        cfg = self.pipeline.cfg
        fmrs, irs, rrs, rres, rtes = [], [], [], [], []
        scene_results = {}
        t0 = time.perf_counter()
        n_pairs = 0
        for name, ds in datasets.items():
            if not isinstance(ds, SCENE_TYPES):
                continue
            res = self.process_scene(ds, seed)
            n_pairs += len(res["pairs"])
            fmrs.append(np.mean(res["fmr"]))
            irs.append(np.mean(res["ir"]))
            rrs.append(np.mean(res["rr"]))
            rres.append(np.mean(res["rre"]) if res["rre"] else 180.0)
            rtes.append(np.mean(res["rte"]) if res["rte"] else 1.0)
            if out_dir is not None:
                pre_dir = os.path.join(out_dir, ds.name.replace("/", "_"))
                os.makedirs(pre_dir, exist_ok=True)
                write_trajectory(res["pairs"], res["transforms"], os.path.join(pre_dir, "pre.log"),
                                 len(ds.pc_ids))
            gt = ds.predator_gt()
            if gt is not None:
                scene_results[name] = {**gt, "est_pairs": np.asarray(res["pairs"]),
                                       "est_traj": np.stack(res["transforms"])}
        elapsed = time.perf_counter() - t0
        rr_predator, _ = benchmark_arrays(
            scene_results, err2=cfg.tau_3, nonconsecutive=datasets.get("wholesetname") != "WHU-TLS")
        summary = {
            "fmr": float(np.mean(fmrs)),
            "ir": float(np.mean(irs)),
            "rr_pointdsc": float(np.mean(rrs)),
            "rre": float(np.mean(rres)),
            "rte": float(np.mean(rtes)),
            "rr_predator": rr_predator,
            "pairs": n_pairs,
            "pairs_per_sec": n_pairs / max(elapsed, 1e-9),
            "stage_times": self.timer.summary(),
        }
        if self.results_log:
            name = datasets.get("wholesetname", "?")
            msg = (
                f"{name}-RD:{cfg.use_rd}-RM:{cfg.use_rm}-{cfg.estimator}-"
                f"{cfg.keynum}keys-{cfg.max_iter}iters\n"
                + "\n".join(f"{k}: {v}" for k, v in summary.items())
            )
            with open(self.results_log, "a") as f:
                f.write(msg + "\n")
        return summary
