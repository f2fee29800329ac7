"""Training batches for GF, ET, RM and RD, made on the fly.

Counterpart of ``roreg_tpu/train/data.py``. The reference writes hundreds
of GB of caches (rotated FCGF features, pickled batch files); here each
cloud's rotated backbone group features are computed once by the port's
describe on the compute device (the block engine's kernels under the
default ``PipelineConfig``) and kept in host RAM, and batches are drawn
with numpy. The numpy draws are the JAX package's, in the same order, so
that the same ``default_rng`` seed and the same features give the same
batches. Batches are dicts of numpy arrays; the trainer moves them to its
device. Label conventions as the reference's:

* GF / ET: feats0 = cloud 0 under a random R_i, feats1 = cloud 1 under a
  random R_j; R = R_j gtR^T R_i^T, ``true_idx`` the nearest group element,
  ``delta_r`` the quaternion of R R_a^T;
* RM: sampled keypoint sets, gt mutual-NN pairs (< ``pps_thre``), a group
  rotation of side 1 (keys rotated, the feature group axis permuted by its
  Cayley row), random translations;
* RD: per-match SE(3) error labels from the self-run pipeline's per-match
  transforms (quaternion distance + tdiff / 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from roreg_tpu_torch.core.group import get_group

__all__ = ["RotatedFeatureCache", "pca_planarity", "gf_et_batches", "rm_batches", "rd_batches"]


def _np_quat_from_matrix(R):
    from scipy.spatial.transform import Rotation as _R

    q = _R.from_matrix(R).as_quat()
    q = np.concatenate([[q[3]], q[:3]])
    return -q if q[0] < 0 else q


def _random_rotation_np(rng):
    from scipy.spatial.transform import Rotation as _R

    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return _R.from_quat(np.concatenate([q[1:], [q[0]]])).as_matrix()


@dataclass
class RotatedFeatureCache:
    """Per-cloud backbone group features under ``rnum`` random rotations,
    described by ``pipeline.extract`` (a ``RegistrationPipeline``) and held
    on the host as numpy arrays (no autograd graph reaches training)."""

    pipeline: object
    rnum: int = 2
    _cache: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def cfg(self):
        return self.pipeline.cfg

    def get(self, ds, pc_id, rng) -> tuple[np.ndarray, np.ndarray]:
        """-> (Rs (rnum, 3, 3), feats (rnum, K, G, 32))."""
        key = f"{ds.name}/{pc_id}"
        if key not in self._cache:
            pc = ds.get_pc(pc_id).astype(np.float32)
            kps = ds.get_kps(pc_id).astype(np.float32)
            Rs, feats = [], []
            for _ in range(self.rnum):
                R = _random_rotation_np(rng).astype(np.float32)
                f = self.pipeline.extract(pc @ R.T, None, kps @ R.T)
                Rs.append(R)
                feats.append(f.float().cpu().numpy())
            self._cache[key] = (np.stack(Rs), np.stack(feats))
        return self._cache[key]


def pca_planarity(pc: np.ndarray, keys: np.ndarray, radius: float = 0.3) -> np.ndarray:
    """Per-keypoint surface variation: the smallest PCA eigenvalue of the
    radius neighbourhood over the eigenvalue sum. Near-planar keypoints
    (score about 0) are rotationally ambiguous; the reference drops those
    at or below ``pca_thre`` from GF/ET supervision. Keypoints with fewer
    than 8 neighbours score 0."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pc)
    out = np.zeros(len(keys), np.float32)
    for i, idx in enumerate(tree.query_ball_point(keys, r=radius)):
        if len(idx) < 8:
            continue
        nb = pc[idx]
        nb = nb - nb.mean(0)
        ev = np.linalg.eigvalsh(nb.T @ nb / len(nb))  # ascending
        s = ev.sum()
        if s > 0:
            out[i] = ev[0] / s
    return out


def gf_et_batches(
    cache,
    scenes: list,
    batch_size: int,
    rng: np.random.Generator,
    pair_dist: float = 0.02,
    pca_thre: float | None = 0.03,
    pca_radius: float = 0.3,
):
    """Infinite iterator of GF/ET batches {feats0, feats1 (B, G, 32),
    true_idx (B,), delta_r (B, 4)}. ``pca_thre`` (the reference's 0.03)
    drops near-planar keypoints before pairing; None keeps all."""
    rots = get_group(cache.cfg.group_size).rotations
    kp_ok: dict[str, np.ndarray] = {}

    def ok_mask(ds, pc_id):
        key = f"{ds.name}/{pc_id}"
        if key not in kp_ok:
            if pca_thre is None:
                kp_ok[key] = np.ones(len(ds.get_kps(pc_id)), bool)
            else:
                pcas = pca_planarity(ds.get_pc(pc_id).astype(np.float32),
                                     ds.get_kps(pc_id).astype(np.float32), pca_radius)
                kp_ok[key] = pcas > pca_thre
        return kp_ok[key]

    # gt keypoint pairs per scene pair, among the admitted keypoints
    pair_bank = []
    for ds in scenes:
        for id0, id1 in ds.pair_ids:
            T = ds.get_transform(id0, id1)
            k0, k1 = ds.get_kps(id0), ds.get_kps(id1)
            ok0, ok1 = ok_mask(ds, id0), ok_mask(ds, id1)
            k1t = k1 @ T[:3, :3].T + T[:3, 3]
            d = np.sqrt(((k0[:, None] - k1t[None]) ** 2).sum(-1))
            i0 = d.argmin(1)
            keep = (d.min(1) < pair_dist) & ok0 & ok1[i0]
            pairs = np.stack([np.arange(len(k0)), i0], -1)[keep]
            if len(pairs) >= 10:
                pair_bank.append((ds, id0, id1, pairs))
    if not pair_bank:
        raise RuntimeError("no scene pair has >= 10 gt keypoint pairs")

    while True:
        ds, id0, id1, pairs = pair_bank[rng.integers(len(pair_bank))]
        gtR = ds.get_transform(id0, id1)[:3, :3]
        Rs0, F0 = cache.get(ds, id0, rng)
        Rs1, F1 = cache.get(ds, id1, rng)
        sel = pairs[rng.integers(len(pairs), size=batch_size)]
        ri = rng.integers(cache.rnum, size=batch_size)
        rj = rng.integers(cache.rnum, size=batch_size)
        R = np.einsum("bij,jk,blk->bil", Rs1[rj], gtR.T, Rs0[ri])  # Rj gtR^T Ri^T
        true_idx = np.einsum("gij,bij->bg", rots, R).argmax(-1)
        delta = np.einsum("bij,bkj->bik", R, rots[true_idx])
        yield {
            "feats0": F0[ri, sel[:, 0]],
            "feats1": F1[rj, sel[:, 1]],
            "true_idx": true_idx,
            "delta_r": np.stack([_np_quat_from_matrix(m) for m in delta]).astype(np.float32),
        }


def _pairmatch(keys0, keys1, R, t, thre):
    """gt mutual-NN pairing of keys0 (moved by R, t) and keys1: pairs
    (P, 2), unpaired masks of both sides, and each keys0 row's partner
    (-1 where none)."""
    k0t = keys0 @ R.T + t
    d = np.sqrt(((k0t[:, None] - keys1[None]) ** 2).sum(-1))
    a01 = d.argmin(1)
    a10 = d.argmin(0)
    ii = np.arange(len(keys0))
    ok = (a10[a01] == ii) & (d[ii, a01] < thre)
    pairs = np.stack([ii[ok], a01[ok]], -1)
    m0 = -np.ones(len(keys0), np.int64)
    m0[ii[ok]] = a01[ok]
    m1_matched = np.zeros(len(keys1), bool)
    m1_matched[a01[ok]] = True
    return pairs, m0 == -1, ~m1_matched, m0


def rm_batches(
    gf_feats: dict,
    scenes: list,
    rng: np.random.Generator,
    min_ps: int = 256,
    max_ps: int = 1538,
    pps_thre: float = 0.2,
    capacity: int | None = None,
    group_size: int = 60,
    max_pairs: int = 1024,
):
    """Infinite iterator of RM batches (B = 1, padded to ``capacity``
    rows). ``gf_feats[(scene name, pc_id)]`` holds the descriptor eqv
    features (K, G, 32) of each cloud's keypoints. feats0/keys0 are the
    matcher's source side."""
    group = get_group(group_size)
    cap = capacity or max_ps
    pair_list = [(ds, p) for ds in scenes for p in ds.pair_ids]

    def pad_to(x, n, fill=0.0):
        return np.concatenate([x, np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)], 0)

    while True:
        ds, (id0, id1) = pair_list[rng.integers(len(pair_list))]
        T = ds.get_transform(id0, id1)
        # keys1 = R keys0 + t, from pts0 = gtR pts1 + gt_t
        Rg = T[:3, :3].T
        tg = -T[:3, :3].T @ T[:3, 3]
        k0, k1 = ds.get_kps(id0), ds.get_kps(id1)
        f0, f1 = gf_feats[(ds.name, id0)], gf_feats[(ds.name, id1)]
        n0 = int(rng.integers(min_ps, min(max_ps, len(k0)) + 1))
        n1 = int(rng.integers(min_ps, min(max_ps, len(k1)) + 1))
        s0 = rng.permutation(len(k0))[:n0]
        s1 = rng.permutation(len(k1))[:n1]
        keys0, feats0 = k0[s0], f0[s0]
        keys1, feats1 = k1[s1], f1[s1]
        pairs, unpair0, unpair1, m0 = _pairmatch(keys0, keys1, Rg, tg, pps_thre)
        # group-rotation augmentation of side 1: rotate keys, permute features
        aid = int(rng.integers(group_size))
        keys1 = keys1 @ group.rotations[aid].T
        feats1 = feats1[:, group.cayley[aid], :]
        keys0 = keys0 + (rng.random((1, 3)) - 0.5)
        keys1 = keys1 + (rng.random((1, 3)) - 0.5)
        npairs = min(len(pairs), max_pairs)
        if npairs == 0:
            continue
        yield {
            "feats0": pad_to(feats0.astype(np.float32), cap)[None],
            "feats1": pad_to(feats1.astype(np.float32), cap)[None],
            "keys0": pad_to(keys0.astype(np.float32), cap)[None],
            "keys1": pad_to(keys1.astype(np.float32), cap)[None],
            "mask0": (np.arange(cap) < n0)[None],
            "mask1": (np.arange(cap) < n1)[None],
            "pairs": pad_to(pairs[:npairs].astype(np.int32), max_pairs)[None],
            "pair_mask": (np.arange(max_pairs) < npairs)[None],
            "unpair0": pad_to(unpair0, cap, False)[None],
            "unpair1": pad_to(unpair1, cap, False)[None],
            "matches0": pad_to(m0, cap, -1)[None],
        }


def rd_batches(match_bank: list[dict], batch_size: int, rng: np.random.Generator):
    """Infinite iterator of RD batches {feats0, feats1 (B, G, 32), rdiffs
    (B,)} from a bank of self-run results: each entry holds feats0, feats1
    (M, G, 32) descriptor features of matched pairs, T_pre (M, 4, 4) the
    per-match transforms and T_gt (4, 4)."""
    banks = []
    for entry in match_bank:
        gt_q = _np_quat_from_matrix(entry["T_gt"][:3, :3])
        qs = np.stack([_np_quat_from_matrix(t[:3, :3]) for t in entry["T_pre"]])
        # each quaternion takes the sign of the gt's before the distance
        sgn = np.where((qs * gt_q).sum(-1, keepdims=True) < 0, -1.0, 1.0)
        rdiff = np.sqrt(((qs * sgn - gt_q) ** 2).sum(-1))
        tdiff = ((entry["T_pre"][:, :3, 3] - entry["T_gt"][:3, 3]) ** 2).sum(-1)
        banks.append((entry["feats0"], entry["feats1"], rdiff + tdiff / 3.0))

    while True:
        f0, f1, labels = banks[rng.integers(len(banks))]
        sel = rng.integers(len(labels), size=batch_size)
        yield {
            "feats0": f0[sel].astype(np.float32),
            "feats1": f1[sel].astype(np.float32),
            "rdiffs": labels[sel].astype(np.float32),
        }
