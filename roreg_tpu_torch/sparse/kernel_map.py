"""Kernel-map records and offset tables of the sparse UNet (numpy).

Counterparts of ``SparseLevel``, ``SparsePyramid``, ``hypercube_offsets``
and ``occupancy_words`` in ``roreg_tpu/sparse/kernel_map.py``. The port
builds every map on the host (``native/pyramid.py``); level semantics are
the reference's: level ``l`` holds coords that are multiples of ``2**l``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from roreg_tpu_torch.sparse.voxelize import VoxelGrid

__all__ = ["hypercube_offsets", "occupancy_words", "SparseLevel", "SparsePyramid"]


def occupancy_words(kernel_volume: int) -> int:
    """Number of uint32 words holding a packed K-bit occupancy row."""
    return (kernel_volume + 31) // 32


def hypercube_offsets(kernel_size: int) -> np.ndarray:
    """kernel_size**3 offsets, row-major (dx slowest), centred for odd sizes."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.int32)


class SparseLevel(NamedTuple):
    keys: np.ndarray  # (C_l,) sorted packed coords
    coords: np.ndarray  # (C_l, 3)
    mask: np.ndarray  # (C_l,)
    num: np.ndarray  # ()


class SparsePyramid(NamedTuple):
    """Per-cloud coordinate pyramid + every kernel map the UNet needs.

    levels: SparseLevel per level, finest first. conv1_occ: (C_0,
    ceil(K1/32)) packed uint32 occupancy of the first conv. same: per level
    (C_l, 27) same-level map. down: l -> l+1, (C_{l+1}, 27) rows of level l.
    up: l+1 -> l, (C_l, 27) rows of level l+1. grid: level-0 VoxelGrid.
    """

    levels: tuple
    conv1_occ: np.ndarray
    same: tuple
    down: tuple
    up: tuple
    grid: VoxelGrid
