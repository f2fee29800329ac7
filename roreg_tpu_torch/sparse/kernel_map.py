"""Kernel-map records, kernel regions and gather tables of the sparse UNet.

Counterparts of ``SparseLevel``, ``SparsePyramid``, ``hypercube_offsets``,
``hypercross_offsets``, ``kernel_offsets``, ``occupancy_words``,
``lookup``, ``neighbor_table``, ``pack_occupancy`` and ``build_pyramid``
in ``roreg_tpu/sparse/kernel_map.py`` (and ``pack_keys`` of
``roreg_tpu/sparse/voxelize.py``). The UNet's maps are built on the host
(``native/pyramid.py``, the production path) or, by
:func:`build_pyramid`, on the device with tensors (``host_maps=False``):
sorted keys and a binary search per (row, offset), the reference's
construction. :func:`neighbor_table` builds a table for any kernel region
(hypercube, hypercross or custom offsets) from a level with tensors, for
convolutions beyond FCGF's. Level semantics are the reference's: level
``l`` holds coords that are multiples of ``2**l``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from roreg_tpu_torch.sparse.voxelize import (
    AXIS_BITS,
    SENTINEL,
    VoxelGrid,
    _first_of_runs,
    pack_keys,
    unpack_keys,
    voxelize,
)

__all__ = [
    "hypercube_offsets",
    "hypercross_offsets",
    "kernel_offsets",
    "occupancy_words",
    "pack_occupancy",
    "pack_keys",
    "lookup",
    "neighbor_table",
    "SparseLevel",
    "SparsePyramid",
    "build_pyramid",
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


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """The row of each query key in ``sorted_keys`` (binary search), -1
    where absent or where the query is ``SENTINEL``."""
    idx = torch.searchsorted(sorted_keys, query_keys).clamp(0, sorted_keys.shape[0] - 1)
    found = (sorted_keys[idx] == query_keys) & (query_keys != SENTINEL)
    return torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32)


def _table(src_keys, dst_coords, dst_mask, offsets, step: int) -> torch.Tensor:
    """(C_dst, K) int32 gather table: the src row of ``dst_coord + offset
    * step``, -1 where absent or where the dst row is padding."""
    off = torch.as_tensor(np.asarray(offsets, np.int32), device=dst_coords.device)
    q = dst_coords.to(torch.int32)[:, None, :] + off[None] * step  # (C, K, 3)
    ok = ((q >= 0) & (q < (1 << AXIS_BITS))).all(-1) & dst_mask.bool()[:, None]
    qk = torch.where(ok, pack_keys(q), torch.full((), SENTINEL, dtype=torch.int32, device=q.device))
    return lookup(src_keys.to(torch.int32).contiguous(), qk)


def neighbor_table(level: "SparseLevel", offsets, step: int = 1) -> torch.Tensor:
    """A same-level gather table for any kernel region: (C, K) int32 rows
    of ``coord + offset * step`` in ``level``, -1 where absent or where the
    row is padding. ``level``'s leaves may be numpy arrays or tensors; the
    table lies on the tensors' device. Feed it to ``kernels.gather_conv``."""
    keys, coords, mask = (torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) else a
                          for a in (level.keys, level.coords, level.mask))
    return _table(keys, coords, mask, offsets, step)


def pack_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """(M, K) bool occupancy -> (M, ceil(K/32)) packed words, bit j of word
    w = offset 32*w + j: the reference's uint32 words carried as int32 bits
    (bit 31 is the sign bit; read a bit by shift, then ``& 1``)."""
    m, k = occ.shape
    w = occupancy_words(k)
    bits = torch.zeros((m, w * 32), dtype=torch.int64, device=occ.device)
    bits[:, :k] = occ.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = (bits.view(m, w, 32) << shifts).sum(-1)  # in [0, 2**32)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # the same 32 bits as int32


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
    Leaves are numpy arrays (the host builders) or tensors
    (:func:`build_pyramid`).
    """

    levels: tuple
    conv1_occ: np.ndarray
    same: tuple
    down: tuple
    up: tuple
    grid: VoxelGrid


def _downsample(level: SparseLevel, stride: int, capacity: int) -> SparseLevel:
    """Coords snapped to multiples of ``stride`` (ME's stride map),
    deduplicated in key order, compacted into ``capacity`` rows."""
    snapped = torch.div(level.coords, stride, rounding_mode="floor") * stride
    sentinel = torch.tensor(SENTINEL, dtype=torch.int32, device=snapped.device)
    sk = torch.sort(torch.where(level.mask, pack_keys(snapped), sentinel)).values
    isfirst = _first_of_runs(sk)
    uidx = (torch.cumsum(isfirst, 0) - 1).to(torch.int32)
    num = isfirst.sum().to(torch.int32)
    in_cap = isfirst & (uidx < capacity)
    out = torch.full((capacity + 1,), SENTINEL, dtype=torch.int32, device=sk.device)
    out[torch.where(in_cap, uidx, capacity).long()] = torch.where(in_cap, sk, sentinel)
    out = out[:capacity]
    return SparseLevel(keys=out, coords=unpack_keys(out), mask=out != SENTINEL,
                       num=torch.clamp(num, max=capacity))


def build_pyramid(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    voxel_size: float,
    capacities: tuple[int, ...],
    conv1_kernel_size: int = 7,
    num_levels: int = 4,
) -> SparsePyramid:
    """Voxelize a cloud and build every kernel map of the FCGF UNet on the
    points' device, as the reference's ``build_pyramid``: level ``l`` the
    multiples of ``2**l`` of level ``l-1`` (``_downsample``), the first
    conv's packed occupancy, ``same[l]`` (level l into level l at step
    ``2**l``), ``down[l]`` (level l+1's coords into level l) and ``up[l]``
    (level l's coords into level l+1), both at step ``2**l``. Every leaf
    is a tensor; the tables are int32."""
    if len(capacities) != num_levels:
        raise ValueError(f"{num_levels} levels need {num_levels} capacities, got {capacities}")
    grid = voxelize(points, point_mask, voxel_size, capacities[0])
    levels = [SparseLevel(keys=grid.keys, coords=grid.coords, mask=grid.mask, num=grid.num_voxels)]
    for l in range(1, num_levels):
        levels.append(_downsample(levels[-1], 2**l, capacities[l]))
    off3 = hypercube_offsets(3)
    lvl0 = levels[0]
    conv1_occ = pack_occupancy(
        _table(lvl0.keys, lvl0.coords, lvl0.mask, hypercube_offsets(conv1_kernel_size), 1) >= 0)
    same = tuple(_table(lv.keys, lv.coords, lv.mask, off3, 2**l) for l, lv in enumerate(levels))
    down = tuple(_table(levels[l].keys, levels[l + 1].coords, levels[l + 1].mask, off3, 2**l)
                 for l in range(num_levels - 1))
    up = tuple(_table(levels[l + 1].keys, levels[l].coords, levels[l].mask, off3, 2**l)
               for l in range(num_levels - 1))
    return SparsePyramid(levels=tuple(levels), conv1_occ=conv1_occ, same=same, down=down, up=up,
                         grid=grid)
