"""Voxel-grid record of the host pyramid (numpy).

Counterpart of ``VoxelGrid`` in ``roreg_tpu/sparse/voxelize.py``; the port
builds grids on the host only (``native/pyramid.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["VoxelGrid", "SENTINEL", "AXIS_BITS"]

AXIS_BITS = 10  # 1024 voxels per axis
SENTINEL = 2**31 - 1  # sorts after every valid key


class VoxelGrid(NamedTuple):
    """Compacted voxel set with static capacity rows (see the reference).

    keys (C,) int32 sorted packed keys, SENTINEL on pad rows; coords (C, 3);
    mask (C,) bool; num_voxels (); to_voxel (N,) voxel row of each point;
    rep_point (C, 3) f32 representative point; origin (3,) coordinate
    shift; num_dropped () points outside the grid extent.
    """

    keys: np.ndarray
    coords: np.ndarray
    mask: np.ndarray
    num_voxels: np.ndarray
    to_voxel: np.ndarray
    rep_point: np.ndarray
    origin: np.ndarray
    num_dropped: np.ndarray
