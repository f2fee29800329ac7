"""ctypes bindings for the port's copy of the host voxel-hash library.

``voxelhash.cpp`` (beside this file) is compiled with ``g++`` into the
port's build directory at first use. A failed build raises: there is no
numpy fallback, for the gather pyramid or for the block pyramid.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from roreg_tpu_torch.build import BUILD_DIR, compile_shared, needs_build

__all__ = [
    "build",
    "voxelize_host",
    "unique_snapped_host",
    "neighbor_table_host",
    "neighbor_occupancy_host",
    "build_block_pyramid_native",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "voxelhash.cpp")
_SO = os.path.join(BUILD_DIR, "libvoxelhash.so")
_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build(force: bool = False) -> float:
    """Compile the library if it is missing or stale (or ``force``);
    returns the compiler's seconds (0.0 when nothing was built)."""
    if force or needs_build(_SRC, _SO):
        return compile_shared(_CMD, _SRC, _SO)
    return 0.0


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(_SO)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.voxelize_hash.restype = i64
        lib.voxelize_hash.argtypes = [f32p, i64, ctypes.c_float, i32p, i32p, i32p]
        lib.unique_snapped.restype = i64
        lib.unique_snapped.argtypes = [i32p, i64, i32, i32p]
        table_args = [i32p, i64, i32p, i64, i32p, i64, i32]
        lib.neighbor_table.restype = None
        lib.neighbor_table.argtypes = table_args + [i32p]
        lib.neighbor_table16.restype = None
        lib.neighbor_table16.argtypes = table_args + [i16p]
        lib.neighbor_occupancy.restype = None
        lib.neighbor_occupancy.argtypes = table_args + [u32p]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.build_block_pyramid.restype = i64
        lib.build_block_pyramid.argtypes = (
            [f32p, i64, ctypes.c_float, i64p, i64]
            + [u32p] * 4 + [i16p] * 7 + [i32p] * 3
            + [i16p, i32p, f32p, i64, i32p]
        )
        _lib = lib
        return lib


def voxelize_host(points: np.ndarray, voxel_size: float):
    """-> (to_voxel (n,), rep_index (n_vox,), vox_coords (n_vox, 3)),
    first-appearance voxel order."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    to_voxel = np.empty(n, np.int32)
    rep = np.empty(n, np.int32)
    vc = np.empty((n, 3), np.int32)
    nv = _load().voxelize_hash(pts, n, voxel_size, to_voxel, rep, vc)
    return to_voxel, rep[:nv].copy(), vc[:nv].copy()


def unique_snapped_host(coords: np.ndarray, stride: int) -> np.ndarray:
    """Snap int coords to multiples of stride, dedupe (first appearance)."""
    c = np.ascontiguousarray(coords, np.int32)
    out = np.empty_like(c)
    n = _load().unique_snapped(c, len(c), stride, out)
    return out[:n].copy()


def neighbor_table_host(
    src_coords: np.ndarray,
    dst_coords: np.ndarray,
    offsets: np.ndarray,
    step: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """(n_dst, K) gather table into src rows; -1 where absent. ``out`` may
    be a preallocated int16 or int32 buffer with >= n_dst rows."""
    sc = np.ascontiguousarray(src_coords, np.int32)
    dc = np.ascontiguousarray(dst_coords, np.int32)
    off = np.ascontiguousarray(offsets, np.int32)
    if out is None:
        out = np.empty((len(dc), len(off)), np.int32)
    lib = _load()
    fn = lib.neighbor_table16 if out.dtype == np.int16 else lib.neighbor_table
    fn(sc, len(sc), dc, len(dc), off, len(off), step, out)
    return out


def neighbor_occupancy_host(
    src_coords: np.ndarray,
    dst_coords: np.ndarray,
    offsets: np.ndarray,
    step: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """(n_dst, ceil(K/32)) packed uint32 occupancy words: bit j of word w is
    set iff ``dst + offsets[32*w + j]*step`` exists in src."""
    sc = np.ascontiguousarray(src_coords, np.int32)
    dc = np.ascontiguousarray(dst_coords, np.int32)
    off = np.ascontiguousarray(offsets, np.int32)
    k = len(off)
    if out is None:
        out = np.zeros((len(dc), (k + 31) // 32), np.uint32)
    _load().neighbor_occupancy(sc, len(sc), dc, len(dc), off, k, step, out)
    return out


def build_block_pyramid_native(points, voxel_size, out, keys=None, key_rows=None) -> int:
    """Fill one rotation's 4-level block pyramid (a ``BlockPyramidDev`` of
    writable numpy views, such as one slot of the packed payload) in one
    GIL-free C++ call; with ``keys`` (K, 3) in the same rotated frame, also
    write each keypoint's flat level-0 cell row into ``key_rows`` (K,)
    int32. Returns the dropped block count (capacity or extent overflow,
    largest keys dropped)."""
    if len(out.levels) != 4:
        raise ValueError(f"the block-pyramid builder takes 4 levels, got {len(out.levels)}")
    pts = np.ascontiguousarray(points, np.float32)
    caps = np.asarray([lvl.occ_words.shape[0] for lvl in out.levels], np.int64)
    keys = np.empty((0, 3), np.float32) if keys is None else np.ascontiguousarray(keys, np.float32)
    if key_rows is None:
        key_rows = np.empty(len(keys), np.int32)
    return int(_load().build_block_pyramid(
        pts, len(pts), voxel_size, caps, 4,
        *(lvl.occ_words for lvl in out.levels),
        *(lvl.same_tbl for lvl in out.levels),
        *out.down_tbl, *out.up_tbl,
        out.l0_coords, out.origin,
        keys, len(keys), key_rows,
    ))
