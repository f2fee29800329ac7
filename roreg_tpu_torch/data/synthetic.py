"""Synthetic scan pairs made in memory from a seed (numpy).

Copies of ``_bumpy``, ``synthetic_surface`` and ``_random_rotation`` from
``roreg_tpu/data/synthetic.py``, plus :func:`synthetic_pair`, which crops
two overlapping fragments of one surface and moves them into their own
frames, as ``make_synthetic_scene`` does, without writing files, and
:func:`synthetic_scene`, which makes exactly ``make_synthetic_scene``'s
draws and returns in memory what its files hold.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["synthetic_surface", "synthetic_pair", "SyntheticScene", "synthetic_scene"]


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


@dataclass
class SyntheticScene:
    """A scene of overlapping fragments: float32 ``clouds`` (N, 3) and
    ``keypoints`` (K, 3) per fragment, and the ground truth of every pair
    (i, j), i < j, in ``gt`` as float64 (4, 4) with ``clouds[i] = T @
    clouds[j]``."""

    name: str
    clouds: list[np.ndarray]
    keypoints: list[np.ndarray]
    gt: dict[tuple[int, int], np.ndarray]


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
    """``make_synthetic_scene``'s scene made in memory: the same draws from
    ``rng`` in the same order (so the stream is left where that function
    leaves it), clouds cast to float32 as its PLY files store them,
    keypoints read from the float32 clouds at its keypoint ids, and gt in
    the order of its gt.log."""
    base = synthetic_surface(
        rng, int(points_per_cloud / overlap * 1.5), extent=surface_extent
    )
    extent = base[:, 0].max() - base[:, 0].min()
    frames, clouds, keypoints = [], [], []
    for k in range(num_clouds):
        lo = k * (1 - overlap) * extent / max(num_clouds - 1, 1) * 0.5
        sel = base[(base[:, 0] >= lo) & (base[:, 0] <= lo + extent * overlap)]
        sel = sel[rng.permutation(len(sel))[:points_per_cloud]]
        R = _random_rotation(rng, max_angle_deg)
        t = rng.uniform(-1, 1, size=3)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        cloud = (sel @ R.T + t).astype(np.float32)
        frames.append(T)
        clouds.append(cloud)
        keypoints.append(cloud[rng.permutation(len(cloud))[:num_keypoints]])
    gt = {
        (i, j): frames[i] @ np.linalg.inv(frames[j])
        for i in range(num_clouds)
        for j in range(i + 1, num_clouds)
    }
    return SyntheticScene(name, clouds, keypoints, gt)
