"""Icosahedral rotation-group algebra, generated from first principles.

A numpy copy of ``roreg_tpu/core/group.py`` (the port imports nothing of
the JAX package); the tables must stay equal to the reference's.

The reference ships three opaque numpy tables
(``utils/group_related/{Rotation,60_60,Nei_Index_in_SO3_ordered_13}.npy``,
loaded e.g. at reference ``network/group_feat.py:12-14``). We generate all of
them in-repo from the group axioms instead of shipping blobs:

* ``rotations``  (G,3,3)  — the 60 rotation matrices of the icosahedral group I,
  closed under multiplication, identity at index 0, canonically ordered.
* ``cayley``     (G,G)    — composition table with the reference's convention
  ``cayley[i, j] = index(R[j] @ R[i])`` (verified against the shipped table's
  convention; see tests/test_group.py).
* ``nei13``      (G,13)   — the SO(3)-conv "kernel": for each g, g itself plus
  the twelve elements at 72° geodesic distance, ordered group-consistently:
  ``nei13[g, k] = index(R[n0[k]] @ R[g]) = cayley[g, n0[k]]`` so that the
  neighborhood map commutes with the right-translation feature permutation —
  this is exactly what makes the (1,13) group conv equivariant.

Smaller groups (octahedral 24, tetrahedral 12) are supported for the
reference's appendix ablations (RoReg_Appendix Table 1).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = ["IcosahedralGroup", "get_group"]

_PHI = (1.0 + np.sqrt(5.0)) / 2.0


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


def _closure(generators: list[np.ndarray], order: int) -> np.ndarray:
    """BFS closure of a set of rotation generators; returns (order, 3, 3)."""
    elems = [np.eye(3)]

    def _find(M):
        for i, E in enumerate(elems):
            if np.abs(E - M).max() < 1e-9:
                return i
        return -1

    frontier = [np.eye(3)]
    while frontier:
        nxt = []
        for A in frontier:
            for G in generators:
                M = G @ A
                if _find(M) < 0:
                    elems.append(M)
                    nxt.append(M)
        frontier = nxt
        if len(elems) > order:
            raise RuntimeError(f"closure exceeded expected order {order}")
    if len(elems) != order:
        raise RuntimeError(f"closure produced {len(elems)} != {order} elements")
    return np.stack(elems)


def _rotation_angle_deg(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R, axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _rotation_axis(R: np.ndarray) -> np.ndarray:
    """Rotation axis with a deterministic sign convention (first nonzero > 0)."""
    w = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], dtype=np.float64
    )
    n = np.linalg.norm(w)
    if n < 1e-9:  # 180 degree rotation: axis from R + I columns
        M = R + np.eye(3)
        col = M[:, np.argmax(np.linalg.norm(M, axis=0))]
        w, n = col, np.linalg.norm(col)
        if n < 1e-9:
            return np.zeros(3)
    w = w / n
    for v in w:
        if abs(v) > 1e-8:
            if v < 0:
                w = -w
            break
    return w


def _canonical_order(rots: np.ndarray) -> np.ndarray:
    """Sort: identity first, then by (angle, axis z,y,x) — deterministic."""
    keys = []
    for R in rots:
        ang = float(np.round(_rotation_angle_deg(R), 6))
        ax = np.round(_rotation_axis(R), 9)
        keys.append((ang, float(ax[2]), float(ax[1]), float(ax[0])))
    order = sorted(range(len(rots)), key=lambda i: keys[i])
    return rots[order]


def _build_cayley(rots: np.ndarray) -> np.ndarray:
    """cayley[i, j] = index(R[j] @ R[i]) — the reference's 60_60 convention."""
    G = rots.shape[0]
    # products[i, j] = R[j] @ R[i]
    prod = np.einsum("jab,ibc->ijac", rots, rots)  # (i, j, 3, 3)
    # nearest element by Frobenius distance, vectorized
    d = ((prod[:, :, None] - rots[None, None]) ** 2).sum(axis=(-2, -1))  # (i,j,G)
    table = d.argmin(axis=-1)
    if d.min(axis=-1).max() > 1e-9:
        raise RuntimeError("group not closed under composition")
    return table.astype(np.int32)


@dataclass(frozen=True)
class IcosahedralGroup:
    """Immutable bundle of group tables. ``size`` in {12, 24, 60}."""

    rotations: np.ndarray  # (G, 3, 3) float64
    cayley: np.ndarray  # (G, G) int32, cayley[i,j] = idx(R[j] @ R[i])
    nei13: np.ndarray  # (G, K) int32, K = 1 + #(min-angle shell)
    inverse: np.ndarray  # (G,) int32, idx(R[g].T)
    size: int

    @property
    def kernel_size(self) -> int:
        return self.nei13.shape[1]

    def index_of(self, R: np.ndarray) -> int:
        """Nearest group element index to an arbitrary rotation (geodesic)."""
        tr = np.einsum("gij,ij->g", self.rotations, R)
        return int(np.argmax(tr))  # max trace(R_g^T R) == min angle

    def nearest_index(self, R: np.ndarray) -> np.ndarray:
        """Vectorized nearest group index for a batch of rotations (..., 3, 3)."""
        tr = np.einsum("gij,...ij->...g", self.rotations, R)
        return np.argmax(tr, axis=-1)


def _build_group(size: int) -> IcosahedralGroup:
    if size == 60:
        # Vertex-up icosahedron (matches the reference's orientation: one
        # 5-fold axis along +z, upper-ring vertices at polar atan(2) and
        # azimuth 36 + 72k degrees). Generators: two adjacent 5-fold rotations.
        g5a = _axis_angle_matrix([0.0, 0.0, 1.0], 2 * np.pi / 5)
        ct, st = 1.0 / np.sqrt(5.0), 2.0 / np.sqrt(5.0)  # polar atan(2)
        az = np.pi / 5.0  # 36 degrees
        a2 = [np.cos(az) * st, np.sin(az) * st, ct]
        g5b = _axis_angle_matrix(a2, 2 * np.pi / 5)
        rots = _closure([g5a, g5b], 60)
        shell_angle = 72.0
    elif size == 24:
        g4 = _axis_angle_matrix([0, 0, 1], np.pi / 2)
        g3 = _axis_angle_matrix([1, 1, 1], 2 * np.pi / 3)
        rots = _closure([g4, g3], 24)
        shell_angle = 90.0
    elif size == 12:
        g3 = _axis_angle_matrix([1, 1, 1], 2 * np.pi / 3)
        g2 = _axis_angle_matrix([0, 0, 1], np.pi)
        rots = _closure([g3, g2], 12)
        shell_angle = 120.0
    else:
        raise ValueError(f"unsupported group size {size}")

    rots = _canonical_order(rots)
    assert np.abs(rots[0] - np.eye(3)).max() < 1e-9
    cayley = _build_cayley(rots)

    angles = _rotation_angle_deg(rots)
    shell = np.where(np.abs(angles - shell_angle) < 1e-6)[0]
    n0 = np.concatenate([[0], shell]).astype(np.int32)
    # nei13[g, k] = idx(R[n0[k]] @ R[g]) = cayley[g, n0[k]]
    nei = cayley[:, n0].astype(np.int32)

    # inverse[g]: idx of R[g].T
    inv = np.array([int(np.argmax(np.einsum("gij,ij->g", rots, rots[g].T)))
                    for g in range(size)], dtype=np.int32)

    return IcosahedralGroup(
        rotations=rots, cayley=cayley, nei13=nei, inverse=inv, size=size
    )


@functools.lru_cache(maxsize=4)
def get_group(size: int = 60) -> IcosahedralGroup:
    """Cached group construction (icosahedral=60, octahedral=24, tetra=12)."""
    return _build_group(size)
