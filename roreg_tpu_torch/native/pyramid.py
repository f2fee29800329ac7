"""Host-side pyramid construction for the gather engine (numpy + C++).

Counterpart of ``roreg_tpu/native/pyramid.py``: voxelize one rotated cloud
and build every kernel map of the ResUNet on the host, into preallocated
buffers padded to the static capacities. The device then runs only
gathers and GEMMs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from roreg_tpu_torch.native.lib import (
    neighbor_occupancy_host,
    neighbor_table_host,
    unique_snapped_host,
    voxelize_host,
)
from roreg_tpu_torch.sparse.kernel_map import (
    SparseLevel,
    SparsePyramid,
    hypercube_offsets,
    occupancy_words,
)
from roreg_tpu_torch.sparse.voxelize import SENTINEL, VoxelGrid

__all__ = ["alloc_pyramid_buffers", "tree_slice", "fill_pyramid_host", "pyramid_leaves", "host_to_voxel"]


def alloc_pyramid_buffers(
    capacities: tuple[int, ...],
    conv1_kernel_size: int,
    batch: int | None = None,
    num_levels: int = 4,
    empty: Callable[[tuple, np.dtype], np.ndarray] | None = None,
) -> SparsePyramid:
    """Preallocate a (optionally batched) SparsePyramid of numpy buffers in
    their pad state. With ``batch`` every leaf gets a leading batch axis;
    fill slot ``i`` through ``fill_pyramid_host(..., out=tree_slice(buf, i))``.
    ``empty(shape, dtype)`` allocates each leaf (default ``np.empty``); the
    extractor passes one that returns views of pinned host memory.
    """
    empty = empty or (lambda shape, dtype: np.empty(shape, dtype))

    def arr(shape, dtype, fill=0):
        s = (batch,) + shape if batch is not None else shape
        a = empty(s, np.dtype(dtype))
        a.fill(fill)
        return a

    caps = capacities
    k1 = conv1_kernel_size**3
    # int16 tables when every row index fits: halves the host->device bytes
    idx_dt = np.int16 if max(caps) <= 32768 else np.int32
    levels = tuple(
        SparseLevel(
            keys=arr((caps[l],), np.int32, SENTINEL),
            coords=arr((caps[l], 3), np.int32),
            mask=arr((caps[l],), bool, False),
            num=arr((), np.int32),
        )
        for l in range(num_levels)
    )
    same = tuple(arr((caps[l], 27), idx_dt, -1) for l in range(num_levels))
    down = tuple(arr((caps[l + 1], 27), idx_dt, -1) for l in range(num_levels - 1))
    up = tuple(arr((caps[l], 27), idx_dt, -1) for l in range(num_levels - 1))
    conv1_occ = arr((caps[0], occupancy_words(k1)), np.uint32, 0)
    grid = VoxelGrid(
        keys=levels[0].keys,
        coords=levels[0].coords,
        mask=levels[0].mask,
        num_voxels=arr((), np.int32),
        to_voxel=arr((0,), np.int32),  # not tracked in batched mode
        rep_point=arr((caps[0], 3), np.float32),
        origin=arr((3,), np.int32),
        num_dropped=arr((), np.int32),
    )
    return SparsePyramid(
        levels=levels, conv1_occ=conv1_occ, same=same, down=down, up=up, grid=grid
    )


def _map(fn, pyr: SparsePyramid) -> SparsePyramid:
    return SparsePyramid(
        levels=tuple(SparseLevel(*(fn(x) for x in lvl)) for lvl in pyr.levels),
        conv1_occ=fn(pyr.conv1_occ),
        same=tuple(fn(x) for x in pyr.same),
        down=tuple(fn(x) for x in pyr.down),
        up=tuple(fn(x) for x in pyr.up),
        grid=VoxelGrid(*(fn(x) for x in pyr.grid)),
    )


def tree_slice(buf: SparsePyramid, i: int) -> SparsePyramid:
    """Slot ``i`` of batched buffers as writable views (no copies). 1-D
    leaves (per-slot scalars like ``num``) become shape-(1,) views so that
    writes land in the buffer."""
    return _map(lambda x: x[i] if x.ndim > 1 else x[i : i + 1], buf)


def pyramid_leaves(pyr: SparsePyramid) -> list[np.ndarray]:
    """Every leaf of a pyramid, in a fixed order."""
    out: list[np.ndarray] = []
    _map(lambda x: out.append(x) or x, pyr)
    return out


def _packed_keys(c: np.ndarray) -> np.ndarray:
    return (
        c[:, 0].astype(np.int64) * (1 << 20)
        + c[:, 1].astype(np.int64) * (1 << 10)
        + c[:, 2].astype(np.int64)
    )


def fill_pyramid_host(
    points: np.ndarray,
    voxel_size: float,
    out: SparsePyramid,
    conv1_kernel_size: int = 7,
    num_levels: int = 4,
) -> None:
    """Fill preallocated pyramid buffers in place (they must start in their
    pad state: keys=SENTINEL, tables=-1, mask=False). Rows are sorted by
    packed key (x-major, z fastest), as in the reference."""
    pts = np.ascontiguousarray(points, np.float32)
    _, rep, coords0 = voxelize_host(pts, voxel_size)
    origin = coords0.min(axis=0) if len(coords0) else np.zeros(3, np.int32)
    coords0 = coords0 - origin

    off3 = hypercube_offsets(3)
    offc1 = hypercube_offsets(conv1_kernel_size)
    caps = tuple(out.levels[l].keys.shape[0] for l in range(num_levels))

    order0 = np.argsort(_packed_keys(coords0))
    coords0 = coords0[order0]
    rep = rep[order0]

    level_coords = [coords0]
    for l in range(1, num_levels):
        c = unique_snapped_host(level_coords[-1], 2**l)
        level_coords.append(c[np.argsort(_packed_keys(c))])
    for l in range(num_levels):
        level_coords[l] = level_coords[l][: caps[l]]

    for l in range(num_levels):
        c = level_coords[l]
        n = len(c)
        lvl = out.levels[l]
        lvl.keys[:n] = _packed_keys(c).astype(np.int32)
        lvl.coords[:n] = c
        lvl.mask[:n] = True
        lvl.mask[n:] = False  # clear stale rows on buffer reuse
        lvl.num[...] = n
        neighbor_table_host(c, c, off3, 2**l, out=out.same[l])
        out.same[l][n:] = -1
    neighbor_occupancy_host(
        level_coords[0], level_coords[0], offc1, 1, out=out.conv1_occ
    )
    for l in range(num_levels - 1):
        step = 2**l
        neighbor_table_host(
            level_coords[l], level_coords[l + 1], off3, step, out=out.down[l]
        )
        out.down[l][len(level_coords[l + 1]):] = -1
        neighbor_table_host(
            level_coords[l + 1], level_coords[l], off3, step, out=out.up[l]
        )
        out.up[l][len(level_coords[l]):] = -1

    n0 = len(level_coords[0])
    out.grid.rep_point[:n0] = pts[rep[:n0]]
    out.grid.num_voxels[...] = n0
    out.grid.origin[:] = origin


def host_to_voxel(points: np.ndarray, voxel_size: float, capacity: int) -> np.ndarray:
    """Each point's level-0 row in the pyramid ``fill_pyramid_host`` builds
    from ``points`` (rows in packed-key order, cut at ``capacity``): (N,)
    int32, -1 past the capacity; the ``to_voxel`` that batched buffers do
    not keep."""
    to_voxel, _, coords = voxelize_host(np.ascontiguousarray(points, np.float32), voxel_size)
    if not len(coords):
        return np.full(len(to_voxel), -1, np.int32)
    order = np.argsort(_packed_keys(coords - coords.min(axis=0)))
    row = np.empty(len(order), np.int64)
    row[order] = np.arange(len(order))
    return np.where(row < capacity, row, -1).astype(np.int32)[to_voxel]
