"""Kernel-map records, kernel regions and gather tables of the sparse UNet.

Counterparts of ``SparseLevel``, ``SparsePyramid``, ``hypercube_offsets``,
``hypercross_offsets``, ``kernel_offsets``, ``occupancy_words``,
``lookup`` and ``neighbor_table`` in ``roreg_tpu/sparse/kernel_map.py``
(and ``pack_keys`` of ``roreg_tpu/sparse/voxelize.py``). The port builds
the UNet's maps on the host (``native/pyramid.py``); :func:`neighbor_table`
builds a table for any kernel region (hypercube, hypercross or custom
offsets) from a level with tensors, for convolutions beyond FCGF's. Level
semantics are the reference's: level ``l`` holds coords that are
multiples of ``2**l``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from roreg_tpu_torch.sparse.voxelize import AXIS_BITS, SENTINEL, VoxelGrid

__all__ = [
    "hypercube_offsets",
    "hypercross_offsets",
    "kernel_offsets",
    "occupancy_words",
    "pack_keys",
    "lookup",
    "neighbor_table",
    "SparseLevel",
    "SparsePyramid",
]


def occupancy_words(kernel_volume: int) -> int:
    """Number of uint32 words holding a packed K-bit occupancy row."""
    return (kernel_volume + 31) // 32


def hypercube_offsets(kernel_size: int) -> np.ndarray:
    """kernel_size**3 offsets, row-major (dx slowest), centred for odd sizes."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.int32)


def hypercross_offsets(kernel_size: int) -> np.ndarray:
    """The 'hypercross' region: the origin, then per axis (x, y, z) the
    radii 1..kernel_size//2, minus before plus; ``1 + 3 * (kernel_size -
    1)`` offsets (7 at size 3, 13 at size 5)."""
    if kernel_size % 2 != 1 or kernel_size < 3:
        raise ValueError("hypercross needs an odd kernel_size >= 3")
    offs = [np.zeros(3, np.int32)]
    for axis in range(3):
        for r in range(1, kernel_size // 2 + 1):
            for sign in (-1, 1):
                o = np.zeros(3, np.int32)
                o[axis] = sign * r
                offs.append(o)
    return np.stack(offs).astype(np.int32)


def kernel_offsets(
    kernel_size: int, region_type: str = "hypercube", custom_offsets: np.ndarray | None = None
) -> np.ndarray:
    """Kernel-region dispatch: ``hypercube``, ``hypercross`` or ``custom``
    (the caller's (K, 3) int offsets)."""
    if region_type == "hypercube":
        return hypercube_offsets(kernel_size)
    if region_type == "hypercross":
        return hypercross_offsets(kernel_size)
    if region_type == "custom":
        if custom_offsets is None:
            raise ValueError("custom region requires custom_offsets")
        off = np.asarray(custom_offsets, np.int32)
        if off.ndim != 2 or off.shape[1] != 3:
            raise ValueError("custom_offsets must be (K, 3)")
        return off
    raise ValueError(f"unknown region_type {region_type!r}")


def pack_keys(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative int32 voxel coords -> (...,) sortable int32
    keys (x, y, z in 10 bits each, x most significant)."""
    c = coords.to(torch.int32)
    return (c[..., 0] << (2 * AXIS_BITS)) | (c[..., 1] << AXIS_BITS) | c[..., 2]


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """The row of each query key in ``sorted_keys`` (binary search), -1
    where absent or where the query is ``SENTINEL``."""
    idx = torch.searchsorted(sorted_keys, query_keys).clamp(0, sorted_keys.shape[0] - 1)
    found = (sorted_keys[idx] == query_keys) & (query_keys != SENTINEL)
    return torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32)


def neighbor_table(level: "SparseLevel", offsets, step: int = 1) -> torch.Tensor:
    """A same-level gather table for any kernel region: (C, K) int32 rows
    of ``coord + offset * step`` in ``level``, -1 where absent or where the
    row is padding. ``level``'s leaves may be numpy arrays or tensors; the
    table lies on the tensors' device. Feed it to ``kernels.gather_conv``."""
    keys, coords, mask = (torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) else a
                          for a in (level.keys, level.coords, level.mask))
    off = torch.as_tensor(np.asarray(offsets, np.int32), device=coords.device)
    q = coords.to(torch.int32)[:, None, :] + off[None] * step  # (C, K, 3)
    ok = ((q >= 0) & (q < (1 << AXIS_BITS))).all(-1) & mask.bool()[:, None]
    qk = torch.where(ok, pack_keys(q), torch.full((), SENTINEL, dtype=torch.int32, device=q.device))
    return lookup(keys.to(torch.int32).contiguous(), qk)


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
