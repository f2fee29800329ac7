"""3DMatch / Redwood registration-recall benchmark protocol.

A copy of ``roreg_tpu/eval/benchmark.py`` (the Predator protocol of the
reference's ``utils/RR_cal.py``: gt.log / gt.info trajectories, the
covariance-weighted RMSE of the correspondence error, non-consecutive-pair
masking, per-scene precision / recall and RRE / RTE), numpy + scipy only.
:func:`benchmark_scenes` reads each scene's files and hands the arrays to
:func:`benchmark_arrays`, which the evaluator also calls for scenes held in
memory.

One behaviour differs from the reference: a scene with no pair to count
(no non-consecutive pair, as in a scene of two clouds) has no recall.
:func:`evaluate_registration` gives None for it where the reference divides
by zero, the scene is left out of the mean, and the registration recall is
None when no scene counts.

File formats: http://redwood-data.org/indoor/fileformat.html
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
from scipy.spatial.transform import Rotation as _R

__all__ = [
    "read_trajectory",
    "read_trajectory_info",
    "write_trajectory",
    "compute_transformation_error",
    "evaluate_registration",
    "read_scene_gt",
    "benchmark_arrays",
    "benchmark_scenes",
]


def _mat2quat_wxyz(R: np.ndarray) -> np.ndarray:
    q = _R.from_matrix(R).as_quat()  # xyzw
    q = np.concatenate([[q[3]], q[:3]])
    if q[0] < 0:
        q = -q
    return q


def read_trajectory(filename: str, dim: int = 4):
    """gt.log -> (pairs (n,3) str array, trajectories (n,4,4)).
    Equivalent of RR_cal.read_trajectory:67."""
    with open(filename) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    keys = lines[0 :: dim + 1]
    pairs = np.asarray(
        [[p.strip() for p in k.split("\t")[0:3]] for k in keys]
    )
    traj = []
    for i, ln in enumerate(lines):
        if i % (dim + 1) != 0:
            traj.append([float(v) for v in ln.split()[0:dim]])
    traj = np.asarray(traj, dtype=np.float64).reshape(-1, dim, dim)
    return pairs, traj


def read_trajectory_info(filename: str, dim: int = 6):
    """gt.info -> (num fragments, covariance matrices (n,6,6)).
    Equivalent of RR_cal.read_trajectory_info:144."""
    with open(filename) as f:
        contents = f.readlines()
    n_pairs = len(contents) // 7
    info_list = []
    n_frame = 0
    for i in range(n_pairs):
        head = contents[i * 7].strip().split()
        n_frame = int(head[2])
        mat = np.concatenate(
            [
                np.fromstring(item, sep="\t").reshape(1, -1)
                for item in contents[i * 7 + 1 : i * 7 + 7]
            ],
            axis=0,
        )
        info_list.append(mat)
    cov = np.asarray(info_list, dtype=np.float64).reshape(-1, dim, dim)
    return n_frame, cov


def write_trajectory(pairs, trajs, filename: str, num_fragments: int):
    """Write a pre.log in the reference's format (estimator.R_pre_log:14-26)."""
    with open(filename, "w") as f:
        for (i, j), T in zip(pairs, trajs):
            f.write(f"{int(i)}\t{int(j)}\t{num_fragments}\n")
            for r in range(3):
                f.write("\t".join(str(T[r, c]) for c in range(4)) + "\n")
            f.write("0.0\t0.0\t0.0\t1.0\n")


def compute_transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted RMSE approximation
    (RR_cal.computeTransformationErr:47-65)."""
    t = trans[:3, 3]
    q = _mat2quat_wxyz(trans[:3, :3])
    er = np.concatenate([t, q[1:]], axis=0)
    p = er.reshape(1, 6) @ info @ er.reshape(6, 1) / info[0, 0]
    return float(p.item())


def evaluate_registration(
    num_fragment: int,
    result: np.ndarray,
    result_pairs: np.ndarray,
    gt_pairs: np.ndarray,
    gt: np.ndarray,
    gt_info: np.ndarray,
    err2: float = 0.2,
    nonconsecutive: bool = True,
):
    """Scene-level precision/recall under the Redwood protocol
    (RR_cal.evaluate_registration:236-320). err2 is the RMSE threshold
    (tau_3); only non-consecutive pairs count (except WHU-TLS). The recall
    is None when no pair counts."""
    err2 = err2**2
    gt_mask = np.zeros((num_fragment, num_fragment), dtype=int)
    flags, errors = [], []

    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if not nonconsecutive or abs(j - i) > 1:
            gt_mask[i, j] = idx
    n_gt = int(np.sum(gt_mask > 0)) + (0 if nonconsecutive else 1)

    good, n_res = 0, 0
    start = 0
    if not nonconsecutive:
        # pair index 0 lives at gt_mask == 0; handle it explicitly
        start = 1
        n_res += 1
        p = compute_transformation_error(
            np.linalg.inv(gt[0]) @ result[0], gt_info[0]
        )
        errors.append(np.sqrt(p))
        if p <= err2:
            good += 1
            flags.append(0)
        else:
            flags.append(1)

    for idx in range(start, result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        if gt_mask[i, j] > 0:
            n_res += 1
            gt_idx = gt_mask[i, j]
            p = compute_transformation_error(
                np.linalg.inv(gt[gt_idx]) @ result[idx], gt_info[gt_idx]
            )
            errors.append(np.sqrt(p))
            if p <= err2:
                good += 1
                flags.append(0)
            else:
                flags.append(1)
        else:
            flags.append(2)

    if n_res == 0:
        n_res = int(1e6)
    return good / n_res, (good / n_gt if n_gt else None), flags, errors


def read_scene_gt(gt_log: str, gt_info: str) -> dict:
    """A scene's gt.log and gt.info -> ``{"gt_pairs" (n, 3), "gt_traj"
    (n, 4, 4), "n_fragments", "gt_cov" (n, 6, 6)}``."""
    gt_pairs, gt_traj = read_trajectory(gt_log)
    n_fragments, gt_cov = read_trajectory_info(gt_info)
    return {"gt_pairs": gt_pairs, "gt_traj": gt_traj, "n_fragments": n_fragments, "gt_cov": gt_cov}


def benchmark_arrays(
    scene_results: dict,
    err2: float = 0.2,
    nonconsecutive: bool = True,
    out_file: str | None = None,
):
    """Aggregate Predator-style RR over scenes given as arrays.

    scene_results: {scene_name: dict(gt_pairs=(n, >=2), gt_traj=(n, 4, 4),
    n_fragments=int, gt_cov=(n, 6, 6), est_pairs=(m, 2), est_traj=(m, 4, 4))}.
    Returns (registration recall, per-scene dict); a scene with no pair to
    count is left out of both, and the recall is None when no scene counts.
    (RR_cal.benchmark:321-397)
    """
    precision, recall = [], []
    re_med, te_med = [], []
    per_scene = {}
    for scene, res in scene_results.items():
        gt_pairs, gt_traj = res["gt_pairs"], np.asarray(res["gt_traj"])
        n_fragments, gt_cov = res["n_fragments"], np.asarray(res["gt_cov"])
        est_pairs = np.asarray(res["est_pairs"])
        est_traj = np.asarray(res["est_traj"])
        n_valid = sum(
            1
            for ele in gt_pairs
            if (not nonconsecutive) or abs(int(ele[0]) - int(ele[1])) > 1
        )
        prec, rec, flags, errors = evaluate_registration(
            n_fragments, est_traj, est_pairs, gt_pairs, gt_traj, gt_cov,
            err2=err2, nonconsecutive=nonconsecutive,
        )
        if rec is None:
            continue
        # RRE/RTE on successful, gt-covered pairs
        flags_arr = np.asarray(flags)
        res_re, res_te = [], []
        gi = {(int(p[0]), int(p[1])): k for k, p in enumerate(gt_pairs)}
        for idx in range(est_pairs.shape[0]):
            if idx < len(flags_arr) and flags_arr[idx] == 0:
                key = (int(est_pairs[idx, 0]), int(est_pairs[idx, 1]))
                if key in gi:
                    Tg = gt_traj[gi[key]]
                    Te = est_traj[idx]
                    tr = np.trace(Te[:3, :3].T @ Tg[:3, :3])
                    res_re.append(
                        np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
                    )
                    res_te.append(np.linalg.norm(Te[:3, 3] - Tg[:3, 3]))
        re = np.asarray(res_re) if res_re else np.ones(max(n_valid, 1)) * 180
        te = np.asarray(res_te) if res_te else np.ones(max(n_valid, 1))
        precision.append(prec)
        recall.append(rec)
        re_med.append(float(np.median(re)))
        te_med.append(float(np.median(te)))
        per_scene[scene] = {
            "precision": prec, "recall": rec,
            "rre_median": re_med[-1], "rte_median": te_med[-1],
            "n_valid": n_valid,
        }
    rr = float(np.mean(recall)) if recall else None
    if out_file:
        with open(out_file, "w") as f:
            f.write("Scene\t prec.\t rec.\t re\t te\t samples\n")
            for scene, d in per_scene.items():
                f.write(
                    f"{scene}\t {d['precision']:.3f}\t {d['recall']:.3f}\t "
                    f"{d['rre_median']:.3f}\t {d['rte_median']:.3f}\t "
                    f"{d['n_valid']:3d}\n"
                )
            f.write(f"Registration Recall: {rr}\n" if rr is None else f"Registration Recall: {rr:.3f}\n")
    return rr, per_scene


def benchmark_scenes(
    scene_results: dict,
    err2: float = 0.2,
    nonconsecutive: bool = True,
    out_file: str | None = None,
):
    """Aggregate Predator-style RR over scenes.

    scene_results: {scene_name: dict(gt_log=..., gt_info=..., est_pairs=(m,2),
    est_traj=(m,4,4))} where gt_log/gt_info are file paths.
    Returns (registration_recall, per-scene dict), as
    :func:`benchmark_arrays`. (RR_cal.benchmark:321-397)
    """
    arrays = {
        scene: {**read_scene_gt(res["gt_log"], res["gt_info"]),
                "est_pairs": res["est_pairs"], "est_traj": res["est_traj"]}
        for scene, res in scene_results.items()
    }
    return benchmark_arrays(arrays, err2, nonconsecutive, out_file)
