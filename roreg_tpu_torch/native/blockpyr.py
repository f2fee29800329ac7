"""Host-side block-pyramid construction for the block-dense engine.

Counterpart of ``roreg_tpu/native/blockpyr.py``: per level, 4x4x4-cell
blocks with 64-bit cell occupancy words and (B, 27) block tables, built for
one rotated cloud by the C++ builder (``voxelhash.cpp``
``build_block_pyramid``) straight into views of one packed uint8 payload.
The payload goes to the device in one copy and is unpacked there by
:func:`roreg_tpu_torch.sparse.block.unpack_block_payload` (same layout).

There is no numpy builder here: a missing or failed native build raises.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np

from roreg_tpu_torch.native.lib import build_block_pyramid_native
from roreg_tpu_torch.sparse.block import BlockLevelDev, BlockPyramidDev

__all__ = [
    "payload_spec",
    "alloc_block_buffers_packed_rows",
    "block_tree_slice",
    "fill_block_pyramid_host",
]


def payload_spec(block_caps: tuple[int, ...], batch: int | None, num_levels: int = 4):
    """Deterministic (name, shape, dtype, byte offset) layout of one packed
    block-pyramid payload, and its total size. Offsets are 8-byte aligned,
    so every field of a uint8 payload can be viewed as its own dtype."""
    caps = block_caps
    fields = []
    for l in range(num_levels):
        fields.append((f"occ{l}", (caps[l], 2), np.uint32))
        fields.append((f"same{l}", (caps[l], 27), np.int16))
    for l in range(num_levels - 1):
        fields.append((f"down{l}", (caps[l + 1], 27), np.int16))
    for l in range(num_levels - 1):
        fields.append((f"up{l}", (caps[l], 27), np.int32))
    fields.append(("l0_coords", (caps[0], 3), np.int16))
    fields.append(("origin", (3,), np.int32))
    spec, off = [], 0
    for name, shape, dt in fields:
        s = (batch,) + shape if batch is not None else shape
        nb = int(np.prod(s)) * np.dtype(dt).itemsize
        spec.append((name, s, np.dtype(dt), off))
        off += (nb + 7) // 8 * 8
    return spec, off


def _tree_from_fields(f: dict, num_levels: int) -> BlockPyramidDev:
    return BlockPyramidDev(
        levels=tuple(
            BlockLevelDev(occ_words=f[f"occ{l}"], same_tbl=f[f"same{l}"])
            for l in range(num_levels)
        ),
        down_tbl=tuple(f[f"down{l}"] for l in range(num_levels - 1)),
        up_tbl=tuple(f[f"up{l}"] for l in range(num_levels - 1)),
        l0_coords=f["l0_coords"],
        origin=f["origin"],
    )


def alloc_block_buffers_packed_rows(
    block_caps: tuple[int, ...],
    batch: int | None,
    rows: int,
    num_levels: int = 4,
    empty: Callable[[tuple, np.dtype], np.ndarray] | None = None,
):
    """-> (payload (rows, total) uint8, [BlockPyramidDev of views per row]).

    One row per rotation chunk, all rows in one contiguous array, so a whole
    cloud goes to the device in one copy. The payload starts zeroed with
    every table at -1 (the pad state). ``empty(shape, dtype)`` allocates it
    (default ``np.empty``); the extractor passes one that returns pinned
    host memory.
    """
    empty = empty or (lambda shape, dtype: np.empty(shape, dtype))
    spec, total = payload_spec(block_caps, batch, num_levels)
    payload = empty((rows, total), np.dtype(np.uint8))
    payload.fill(0)
    trees = []
    for r in range(rows):
        fields = {
            name: payload[r, off: off + int(np.prod(shape)) * dt.itemsize].view(dt).reshape(shape)
            for name, shape, dt, off in spec
        }
        tree = _tree_from_fields(fields, num_levels)
        for lvl in tree.levels:
            lvl.same_tbl[...] = -1
        for t in tree.down_tbl + tree.up_tbl:
            t[...] = -1
        trees.append(tree)
    return payload, trees


def block_tree_slice(buf: BlockPyramidDev, i: int) -> BlockPyramidDev:
    """Batch slot ``i`` of batched buffers as writable views."""
    return BlockPyramidDev(
        levels=tuple(BlockLevelDev(*(x[i] for x in lvl)) for lvl in buf.levels),
        down_tbl=tuple(x[i] for x in buf.down_tbl),
        up_tbl=tuple(x[i] for x in buf.up_tbl),
        l0_coords=buf.l0_coords[i],
        origin=buf.origin[i],
    )


def fill_block_pyramid_host(
    points: np.ndarray,
    voxel_size: float,
    out: BlockPyramidDev,
    num_levels: int = 4,
    warn_overflow: bool = True,
    keys: np.ndarray | None = None,
    key_rows: np.ndarray | None = None,
) -> int:
    """Fill one rotation's preallocated buffers in place with the C++
    builder; returns the dropped block count. With ``keys`` (K, 3) and
    ``key_rows`` (K,) int32, also resolves each keypoint to the flat
    level-0 cell row (``block * 64 + cell``) of its nearest surviving
    voxel.

    Capacity overflow is loud (a stderr line and the returned count), never
    a silent truncation: dropped blocks are the largest packed keys, and
    every cross-reference (tables, key rows) treats them as absent. Units
    outside the 1024^3 block extent are dropped with their own stderr line
    from the builder.
    """
    if num_levels != len(out.levels):
        raise ValueError(f"num_levels {num_levels} vs {len(out.levels)} levels in the buffers")
    dropped = build_block_pyramid_native(
        points, voxel_size, out, keys=keys, key_rows=key_rows
    )
    if dropped and warn_overflow:
        print(
            f"[blockpyr] {dropped} blocks exceed level capacities "
            "— dropped (largest keys); raise block_caps",
            file=sys.stderr,
            flush=True,
        )
    return dropped
