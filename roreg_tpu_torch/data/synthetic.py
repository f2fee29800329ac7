"""Synthetic scenes and scan pairs made from a seed (numpy).

Copies of ``_bumpy``, ``synthetic_surface``, ``_random_rotation`` and
``make_synthetic_scene`` from ``roreg_tpu/data/synthetic.py``, plus
:func:`synthetic_pair`, which crops two overlapping fragments of one
surface and moves them into their own frames without writing files, and
:func:`synthetic_scene`, which returns in memory what
``make_synthetic_scene``'s files hold. Both scene functions make the same
draws in the same order (``_scene_draws``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from roreg_tpu_torch.data.dataset import ThreeDMatchDataset
from roreg_tpu_torch.data.ply import write_ply

__all__ = ["synthetic_surface", "synthetic_pair", "SyntheticScene", "synthetic_scene", "make_synthetic_scene"]


def _bumpy(rng: np.random.Generator, uv: np.ndarray, extent: float,
           n_bumps: int = 24, amp: float = 0.12) -> np.ndarray:
    """Random Gaussian-bump height field."""
    centers = rng.uniform(0, extent, size=(n_bumps, 2))
    amps = rng.normal(size=n_bumps) * amp
    sigmas = rng.uniform(0.1, 0.4, size=n_bumps)
    d2 = ((uv[:, None, :] - centers[None]) ** 2).sum(-1)
    return (amps[None] * np.exp(-d2 / (2 * sigmas[None] ** 2))).sum(-1)


def synthetic_surface(rng: np.random.Generator, n: int = 20000,
                      extent: float = 3.0) -> np.ndarray:
    """A room-like surface cloud: bumpy floor + bumpy walls + boxes + an
    ellipsoid."""
    pts = []
    n_each = n // 6
    f = rng.uniform(0, extent, size=(n_each, 2))
    pts.append(np.stack([f[:, 0], f[:, 1], _bumpy(rng, f, extent)], -1))
    w = rng.uniform(0, extent, size=(n_each, 2))
    pts.append(np.stack([w[:, 0], _bumpy(rng, w, extent), w[:, 1] * 0.8], -1))
    w2 = rng.uniform(0, extent, size=(n_each, 2))
    pts.append(np.stack([_bumpy(rng, w2, extent), w2[:, 0], w2[:, 1] * 0.8], -1))
    for _ in range(2):
        c = rng.uniform(0.5, extent - 0.5, size=(3,))
        c[2] = 0.3
        s = rng.uniform(0.2, 0.6, size=(3,))
        face = rng.integers(0, 3, size=n_each)
        u = rng.uniform(-0.5, 0.5, size=(n_each, 3))
        u[np.arange(n_each), face] = np.sign(u[np.arange(n_each), face]) * 0.5
        pts.append(c + u * s)
    c = rng.uniform(0.5, extent - 0.5, size=(3,))
    c[2] = 0.4
    radii = rng.uniform(0.15, 0.45, size=3)
    dirs = rng.normal(size=(n_each, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts.append(c + dirs * radii)
    pts = np.concatenate(pts, 0)
    pts += rng.normal(size=pts.shape) * 0.003  # sensor noise
    return pts[rng.permutation(len(pts))[:n]]


def _random_rotation(rng: np.random.Generator, max_angle_deg: float = 180.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.radians(rng.uniform(0, max_angle_deg))
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def synthetic_pair(
    seed: int,
    points_per_cloud: int = 20000,
    num_keypoints: int = 5000,
    overlap: float = 0.7,
    max_angle_deg: float = 50.0,
    surface_extent: float = 2.0,
) -> dict[str, np.ndarray]:
    """Two overlapping fragments of one synthetic surface, each in its own
    frame. Returns float32 ``points0``, ``points1`` (N, 3), ``keys0``,
    ``keys1`` (num_keypoints, 3) drawn from the points, and float64
    ``T_gt`` (4, 4) with ``points0 = R @ points1 + t``."""
    rng = np.random.default_rng(seed)
    base = synthetic_surface(
        rng, int(points_per_cloud / overlap * 1.5), extent=surface_extent
    )
    extent = base[:, 0].max() - base[:, 0].min()
    frames, clouds, keys = [], [], []
    for k in range(2):
        lo = k * (1 - overlap) * extent * 0.5
        sel = base[(base[:, 0] >= lo) & (base[:, 0] <= lo + extent * overlap)]
        sel = sel[rng.permutation(len(sel))[:points_per_cloud]]
        T = np.eye(4)
        T[:3, :3] = _random_rotation(rng, max_angle_deg)
        T[:3, 3] = rng.uniform(-1, 1, size=3)
        cloud = sel @ T[:3, :3].T + T[:3, 3]
        frames.append(T)
        clouds.append(cloud.astype(np.float32))
        keys.append(clouds[-1][rng.permutation(len(cloud))[:num_keypoints]])
    return {
        "points0": clouds[0],
        "points1": clouds[1],
        "keys0": keys[0],
        "keys1": keys[1],
        "T_gt": frames[0] @ np.linalg.inv(frames[1]),
    }


def _scene_draws(
    rng: np.random.Generator,
    num_clouds: int,
    points_per_cloud: int,
    num_keypoints: int,
    overlap: float,
    max_angle_deg: float,
    surface_extent: float,
):
    """The draws of one scene: one base surface, and for each fragment an
    overlapping crop moved into its own frame by a random rigid transform,
    then its keypoint ids. Returns (float64 clouds, frames T_k: base ->
    cloud k, keypoint ids)."""
    base = synthetic_surface(
        rng, int(points_per_cloud / overlap * 1.5), extent=surface_extent
    )
    extent = base[:, 0].max() - base[:, 0].min()
    clouds, frames, kp_ids = [], [], []
    for k in range(num_clouds):
        lo = k * (1 - overlap) * extent / max(num_clouds - 1, 1) * 0.5
        sel = base[(base[:, 0] >= lo) & (base[:, 0] <= lo + extent * overlap)]
        sel = sel[rng.permutation(len(sel))[:points_per_cloud]]
        R = _random_rotation(rng, max_angle_deg)
        t = rng.uniform(-1, 1, size=3)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        clouds.append(sel @ R.T + t)
        frames.append(T)
        kp_ids.append(rng.permutation(len(clouds[-1]))[:num_keypoints])
    return clouds, frames, kp_ids


def _pair_transforms(frames: list[np.ndarray]) -> dict[tuple[int, int], np.ndarray]:
    """gt of every pair (i, j), i < j, in gt.log's order: pts_i = T_ij pts_j."""
    n = len(frames)
    return {(i, j): frames[i] @ np.linalg.inv(frames[j]) for i in range(n) for j in range(i + 1, n)}


@dataclass
class SyntheticScene:
    """A scene of overlapping fragments held in memory: float32 ``clouds``
    (N, 3) and ``keypoints`` (K, 3) per fragment, the ground truth of every
    pair (i, j), i < j, in ``gt`` as float64 (4, 4) with ``clouds[i] = T @
    clouds[j]``, and each pair's (6, 6) gt.info matrix in ``info``. It is
    read through the interface of ``data.dataset.ThreeDMatchDataset``."""

    name: str
    clouds: list[np.ndarray]
    keypoints: list[np.ndarray]
    gt: dict[tuple[int, int], np.ndarray]
    info: dict[tuple[int, int], np.ndarray]

    @property
    def pc_ids(self) -> list[str]:
        return [str(k) for k in range(len(self.clouds))]

    @property
    def pair_ids(self) -> list[tuple[str, str]]:
        return [(str(i), str(j)) for i, j in self.gt]

    def get_pc(self, pc_id) -> np.ndarray:
        return self.clouds[int(pc_id)]

    def get_kps(self, pc_id) -> np.ndarray:
        return self.keypoints[int(pc_id)]

    def get_transform(self, id0, id1) -> np.ndarray:
        return self.gt[(int(id0), int(id1))]

    def predator_gt(self) -> dict:
        """The Predator protocol's gt arrays, as ``eval.benchmark.read_scene_gt``
        gives them from a scene's gt.log and gt.info."""
        n = len(self.clouds)
        return {
            "gt_pairs": np.asarray([(i, j, n) for i, j in self.gt]),
            "gt_traj": np.stack(list(self.gt.values())),
            "n_fragments": n,
            "gt_cov": np.stack([self.info[p] for p in self.gt]),
        }


def synthetic_scene(
    rng: np.random.Generator,
    num_clouds: int = 3,
    points_per_cloud: int = 20000,
    num_keypoints: int = 512,
    overlap: float = 0.7,
    max_angle_deg: float = 50.0,
    surface_extent: float = 3.0,
    name: str = "",
) -> SyntheticScene:
    """:func:`make_synthetic_scene`'s scene made in memory: the same draws
    from ``rng`` in the same order (so the stream is left where that
    function leaves it), clouds cast to float32 as its PLY files store them,
    keypoints read from the float32 clouds at its keypoint ids, gt in the
    order of its gt.log and its gt.info matrices (``eye(6) *
    points_per_cloud``)."""
    clouds, frames, kp_ids = _scene_draws(
        rng, num_clouds, points_per_cloud, num_keypoints, overlap, max_angle_deg, surface_extent)
    clouds = [c.astype(np.float32) for c in clouds]
    gt = _pair_transforms(frames)
    info = {p: np.eye(6) * points_per_cloud for p in gt}
    return SyntheticScene(name, clouds, [c[i] for c, i in zip(clouds, kp_ids)], gt, info)


def make_synthetic_scene(
    root: str,
    rng: np.random.Generator,
    num_clouds: int = 3,
    points_per_cloud: int = 20000,
    num_keypoints: int = 512,
    overlap: float = 0.7,
    max_angle_deg: float = 50.0,
    surface_extent: float = 3.0,
) -> ThreeDMatchDataset:
    """Write a scene in the 3DMatch layout under ``root``: PLY clouds,
    keypoint id files, gt.log (9 decimals) and gt.info (``eye(6) *
    points_per_cloud``) for every pair (i, j), i < j, with the gt
    convention pts_i = T @ pts_j. Byte for byte the files of the JAX
    package's ``make_synthetic_scene`` from the same ``rng``."""
    os.makedirs(f"{root}/PointCloud", exist_ok=True)
    os.makedirs(f"{root}/Keypoints", exist_ok=True)
    clouds, frames, kp_ids = _scene_draws(
        rng, num_clouds, points_per_cloud, num_keypoints, overlap, max_angle_deg, surface_extent)
    for k, (cloud, kp) in enumerate(zip(clouds, kp_ids)):
        write_ply(f"{root}/PointCloud/cloud_bin_{k}.ply", cloud)
        np.savetxt(f"{root}/Keypoints/cloud_bin_{k}Keypoints.txt", kp)
    info = np.eye(6) * points_per_cloud
    with open(f"{root}/PointCloud/gt.log", "w") as flog, open(f"{root}/PointCloud/gt.info", "w") as finfo:
        for (i, j), T_ij in _pair_transforms(frames).items():
            flog.write(f"{i}\t{j}\t{num_clouds}\n")
            for r in range(4):
                flog.write("\t".join(f"{T_ij[r, c]:.9f}" for c in range(4)) + "\n")
            finfo.write(f"{i}\t{j}\t{num_clouds}\n")
            for r in range(6):
                finfo.write("\t".join(f"{info[r, c]:.6f}" for c in range(6)) + "\n")
    ds = ThreeDMatchDataset(root, num_clouds, num_keypoints=num_keypoints)
    ds.name = f"synthetic/{os.path.basename(root)}"
    return ds
