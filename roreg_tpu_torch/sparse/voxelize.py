"""Static-capacity voxelization on the device, and the voxel-grid record.

Counterparts of ``VoxelGrid``, ``pack_keys`` and ``voxelize`` in
``roreg_tpu/sparse/voxelize.py``. The host builders (``native/pyramid.py``)
fill a ``VoxelGrid`` of numpy arrays; :func:`voxelize` builds one of
tensors on the points' device (the device-built pyramids,
``host_maps=False``) with the reference's semantics: voxel ``floor(p /
voxel_size)``, coordinates shifted by the masked minimum, packed into
sortable int32 keys, compacted in key order into ``capacity`` rows.

The division is exact on every device, as the reference's: the divisor is
a 0-dim f32 tensor on the points' device, because PyTorch's CUDA kernel
turns a division by a Python number (a CPU scalar) into a product with
its f32 reciprocal, which puts a point one ulp from a voxel face into the
voxel ``floor(p * (1 / voxel_size))``. That is how the host builder
(``native/voxelhash.cpp``) quantizes, so where such a point exists the
device build follows the reference and not the host builder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["VoxelGrid", "SENTINEL", "AXIS_BITS", "exact_divisor", "pack_keys", "unpack_keys", "voxelize"]

AXIS_BITS = 10  # 1024 voxels per axis
_EXTENT = 1 << AXIS_BITS
SENTINEL = 2**31 - 1  # sorts after every valid key


def pack_keys(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative int32 voxel coords -> (...,) sortable int32
    keys (x, y, z in 10 bits each, x most significant)."""
    c = coords.to(torch.int32)
    return (c[..., 0] << (2 * AXIS_BITS)) | (c[..., 1] << AXIS_BITS) | c[..., 2]


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """(...,) int32 keys -> (..., 3) int32 coords (SENTINEL rows decode to
    (1023, 1023, 1023), as in the reference)."""
    m = _EXTENT - 1
    return torch.stack([(keys >> (2 * AXIS_BITS)) & m, (keys >> AXIS_BITS) & m, keys & m], -1)


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


def exact_divisor(value: float, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``device``: dividing by it is an
    exact division on the CPU and on CUDA alike (a Python-number divisor
    becomes a product with its reciprocal on CUDA)."""
    return torch.tensor(value, dtype=dtype, device=device)


def _first_of_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Where a valid key differs from its predecessor in a sorted key list."""
    new = torch.ones_like(sorted_keys, dtype=torch.bool)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return new & (sorted_keys != SENTINEL)


def voxelize(points: torch.Tensor, point_mask: torch.Tensor, voxel_size: float, capacity: int) -> VoxelGrid:
    """Quantize (N, 3) f32 points (``point_mask`` (N,) bool) to a compacted
    voxel grid of ``capacity`` rows on the points' device, every leaf as
    the reference's ``voxelize`` gives it: keys sorted (a stable sort);
    beyond ``capacity`` the largest keys are dropped and their points map
    to -1; each voxel's representative point is its lowest original index;
    ``origin`` the masked minimum (0 for an empty cloud); ``num_dropped``
    the valid points outside the 2**AXIS_BITS extent."""
    n = points.shape[0]
    dev = points.device
    i32 = dict(dtype=torch.int32, device=dev)
    vcoords = torch.floor(points.float() / exact_divisor(voxel_size, dev)).to(torch.int32)
    big = torch.tensor(2**30, **i32)
    origin = torch.where(point_mask[:, None], vcoords, big).amin(0)
    origin = torch.where(origin == big, torch.zeros_like(origin), origin)  # empty cloud guard
    shifted = vcoords - origin
    in_range = ((shifted >= 0) & (shifted < _EXTENT)).all(-1) & point_mask
    num_dropped = (point_mask & ~in_range).sum().to(torch.int32)
    keys = torch.where(in_range, pack_keys(shifted), torch.tensor(SENTINEL, **i32))

    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    valid = sk != SENTINEL
    isfirst = _first_of_runs(sk)
    uidx = (torch.cumsum(isfirst, 0) - 1).to(torch.int32)  # voxel row per sorted position
    num = isfirst.sum().to(torch.int32)
    in_cap = valid & (uidx < capacity)
    safe = torch.where(in_cap, uidx, torch.tensor(capacity, **i32)).long()  # row capacity: dropped

    ukeys = torch.full((capacity + 1,), SENTINEL, **i32)
    ukeys[safe] = torch.where(in_cap, sk, torch.tensor(SENTINEL, **i32))
    rep_idx = torch.full((capacity + 1,), n, dtype=torch.long, device=dev)
    rep_idx = rep_idx.scatter_reduce(0, safe, torch.where(in_cap, order, n), "amin")
    padded = torch.cat([points.float(), torch.zeros((1, 3), dtype=torch.float32, device=dev)])
    to_voxel = torch.empty(n, **i32)
    to_voxel[order] = torch.where(in_cap, uidx, torch.tensor(-1, **i32))
    ukeys = ukeys[:capacity]
    return VoxelGrid(
        keys=ukeys, coords=unpack_keys(ukeys), mask=ukeys != SENTINEL,
        num_voxels=torch.clamp(num, max=capacity), to_voxel=to_voxel,
        rep_point=padded[rep_idx[:capacity]], origin=origin, num_dropped=num_dropped,
    )
