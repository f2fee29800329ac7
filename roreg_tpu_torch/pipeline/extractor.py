"""Backbone group-feature extraction over host-built maps, for both engines.

Gather engine (``engine="gather"``): counterpart of
``extract_group_features_hostmaps`` and ``_backbone_chunk`` in
``roreg_tpu/pipeline/extractor.py``. For each of the G group rotations the
cloud is rotated and its pyramid built on the host (C++, on a thread pool,
double-buffered); each chunk of ``group_chunk`` rotations is copied to the
device from pinned buffers with ``non_blocking`` copies and runs as ONE
batched ResUNet forward (every gather conv is one kernel launch per chunk);
keypoints read their features at the nearest voxel representative point.

Block engine (``engine="block"``, the default): counterpart of
``build_cloud_payloads``, ``dispatch_cloud_payloads`` and
``_backbone_chunk_blocks_rows``. All G rotations' block pyramids and
keypoint cell rows are built on the host (C++, thread pool) into one packed
payload in pinned memory, copied to the device in one upload per cloud,
and each chunk runs as ONE batched BlockResUNet forward; keypoints read the
feature of their host-resolved level-0 cell row.

Device-built pyramids (``engine="gather"``, ``host_maps=False``):
counterpart of ``extract_group_features``. Each chunk's rotations of the
cloud are made on the device and their pyramids built there
(``sparse/kernel_map.build_pyramid``); the chunk then runs the same
batched forward as the host-map path. :func:`extract` dispatches between
the three as the reference's ``extract`` does (the block engine always
builds host payloads).

The output is ``(K, G, 32)`` in every case.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from roreg_tpu_torch.core.group import get_group
from roreg_tpu_torch.core.knn import nn as knn_nn
from roreg_tpu_torch.native.blockpyr import (
    alloc_block_buffers_packed_rows,
    block_tree_slice,
    fill_block_pyramid_host,
)
from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host, tree_slice
from roreg_tpu_torch.pipeline.config import PipelineConfig
from roreg_tpu_torch.sparse.block import (
    CELLS,
    BlockResUNet,
    flatten_block_batch,
    unpack_block_payload,
)
from roreg_tpu_torch.sparse.kernel_map import SparsePyramid, build_pyramid
from roreg_tpu_torch.sparse.resunet import (
    SIMPLENET_VARIANTS,
    ResUNet,
    SimpleNet,
    flatten_batch,
    offset_table,
)

__all__ = [
    "make_backbone",
    "effective_chunk",
    "PinnedArena",
    "extract",
    "extract_group_features",
    "device_chunk",
    "extract_group_features_hostmaps",
    "upload_chunk",
    "upload_pyramid",
    "backbone_chunk",
    "build_cloud_payloads",
    "upload_cloud_payloads",
    "chunk_block_pyramid",
    "backbone_chunk_blocks",
    "dispatch_cloud_payloads",
    "extract_group_features_blocks",
]


def make_backbone(cfg: PipelineConfig, engine: str = "gather"):
    """The FCGF model zoo by ``cfg.backbone_variant``, on the CPU: a
    ``SimpleNet`` for the SimpleNet family, else a ``ResUNet`` (any BN or
    IN variant) on the gather engine, or a ``BlockResUNet`` (BN variants)
    on the block engine; out_channels 32, ``cfg``'s conv1 kernel and
    compute dtype. The counterpart of the JAX package's ``make_backbone``,
    which builds the gather engine's networks."""
    args = (cfg.backbone_variant, 32, cfg.conv1_kernel_size, True, cfg.backbone_compute_dtype)
    if engine == "block":
        return BlockResUNet(*args)
    if cfg.backbone_variant in SIMPLENET_VARIANTS:
        return SimpleNet(*args)
    return ResUNet(*args)


def effective_chunk(g: int, requested: int) -> int:
    """Largest divisor of the group size not exceeding the requested chunk."""
    c = min(requested, g)
    while g % c:
        c -= 1
    return c


class PinnedArena:
    """Allocates numpy views of page-locked host memory; holds the tensors
    that own it for as long as the arena lives."""

    def __init__(self) -> None:
        self._blocks: list[torch.Tensor] = []

    def __call__(self, shape: tuple, dtype: np.dtype) -> np.ndarray:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        t = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        self._blocks.append(t)
        return t.numpy()[:nbytes].view(dtype).reshape(shape)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host buffer to ``device``. From pinned memory to a GPU the copy
    is asynchronous; on the CPU it is a real copy, because the host buffer
    is refilled while the previous chunk may still be read."""
    if x.dtype == np.uint32:  # torch has few uint32 ops: carry the bits as int32
        x = x.view(np.int32)
    t = torch.from_numpy(x)
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def upload_chunk(buf: SparsePyramid, keys_rot: np.ndarray, device: torch.device):
    """Copy a chunk's B host pyramids and rotated keypoints to ``device``:
    -> (batched DevicePyramid, rep points (B, C0, 3), keys (B, K, 3))."""
    dev = lambda x: _to_device(x, device)  # noqa: E731
    pyr = flatten_batch(
        [dev(lvl.mask) for lvl in buf.levels],
        dev(buf.conv1_occ),
        [dev(t) for t in buf.same],
        [dev(t) for t in buf.down],
        [dev(t) for t in buf.up],
    )
    return pyr, dev(buf.grid.rep_point), dev(keys_rot)


def upload_pyramid(pyr: SparsePyramid, device: torch.device):
    """Copy one host pyramid (no batch axis) to ``device`` as a
    DevicePyramid of one cloud (the training forward's input)."""
    dev = lambda x: _to_device(np.ascontiguousarray(x)[None], device)  # noqa: E731
    return flatten_batch(
        [dev(lvl.mask) for lvl in pyr.levels], dev(pyr.conv1_occ),
        [dev(t) for t in pyr.same], [dev(t) for t in pyr.down], [dev(t) for t in pyr.up],
    )


def backbone_chunk(backbone: ResUNet, pyr, rep: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One chunk as one batched forward, then each rotation's keypoints read
    the feature of their nearest valid voxel representative point.
    -> (B, K, 32)."""
    feats = backbone(pyr)  # (B*C0, 32)
    b, cap0 = rep.shape[:2]
    mask0 = pyr.masks[0].view(b, cap0)
    out = []
    for i in range(b):
        _, idx = knn_nn(keys[i], rep[i], ref_mask=mask0[i])
        out.append(feats[idx + i * cap0])
    return torch.stack(out)


def extract_group_features_hostmaps(
    backbone: ResUNet,
    points: np.ndarray,
    keypoints: np.ndarray,
    cfg: PipelineConfig,
    device: torch.device,
    timings: dict[str, float] | None = None,
) -> torch.Tensor:
    """(N, 3) host cloud + (K, 3) host keypoints -> (K, G, 32) backbone group
    features on ``device``. With ``timings``, the seconds the caller's
    thread waited for host pyramid builds are added to ``host_wait``."""
    group = get_group(cfg.group_size)
    rots = group.rotations.astype(np.float32)
    g = cfg.group_size
    chunk = effective_chunk(g, cfg.group_chunk)
    n_chunks = g // chunk
    pts = np.ascontiguousarray(points, np.float32)
    kps = np.ascontiguousarray(keypoints, np.float32)

    cuda = device.type == "cuda"
    empty = PinnedArena() if cuda else (lambda shape, dtype: np.empty(shape, dtype))
    bufs = [
        alloc_pyramid_buffers(cfg.capacities, cfg.conv1_kernel_size, chunk, empty=empty)
        for _ in range(2)
    ]
    keys_bufs = [empty((chunk, kps.shape[0], 3), np.dtype(np.float32)) for _ in range(2)]
    copied = [None, None]  # per slot: CUDA event after its last copies

    def fill(slot: int, r: int, gi: int) -> None:
        R = rots[r]
        fill_pyramid_host(
            pts @ R.T, cfg.voxel_size, tree_slice(bufs[slot], gi),
            conv1_kernel_size=cfg.conv1_kernel_size,
        )
        keys_bufs[slot][gi] = kps @ R.T

    outs = []
    workers = max(1, min(chunk, os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:

        def submit(ci: int):
            slot = ci % 2
            if copied[slot] is not None:
                copied[slot].synchronize()  # the slot's last copies are done
            return [pool.submit(fill, slot, ci * chunk + gi, gi) for gi in range(chunk)]

        waited = 0.0
        pending = submit(0)
        for ci in range(n_chunks):
            t0 = time.perf_counter()
            for f in pending:
                f.result()
            waited += time.perf_counter() - t0
            slot = ci % 2
            uploaded = upload_chunk(bufs[slot], keys_bufs[slot], device)
            if cuda:
                copied[slot] = torch.cuda.Event()
                copied[slot].record()
            # build the next chunk on the host while the device runs this one
            pending = submit(ci + 1) if ci + 1 < n_chunks else []
            outs.append(backbone_chunk(backbone, *uploaded))
        for f in pending:
            f.result()
    for e in copied:  # the pinned buffers are released on return
        if e is not None:
            e.synchronize()
    if timings is not None:
        timings["host_wait"] = timings.get("host_wait", 0.0) + waited
    out = torch.cat(outs, 0)  # (G, K, 32)
    return out.permute(1, 0, 2).contiguous()


# ---- device-built pyramids ----


def device_chunk(points: torch.Tensor, point_mask: torch.Tensor, keypoints: torch.Tensor,
                 rots: torch.Tensor, cfg: PipelineConfig):
    """One chunk's rotations (B, 3, 3) of a cloud on its device: each
    rotation's cloud ``points @ R.T`` (f32, as the reference rotates) and
    its pyramid built there, stacked as one batched DevicePyramid. ->
    (batched DevicePyramid, rep points (B, C0, 3), rotated keypoints (B, K,
    3))."""
    pyrs = [build_pyramid(points @ R.T, point_mask, cfg.voxel_size, cfg.capacities,
                          conv1_kernel_size=cfg.conv1_kernel_size) for R in rots]
    stack = lambda leaves: torch.stack(list(leaves))  # noqa: E731
    pyr = flatten_batch(
        [stack(p.levels[l].mask for p in pyrs) for l in range(len(cfg.capacities))],
        stack(p.conv1_occ for p in pyrs),
        [stack(t) for t in zip(*(p.same for p in pyrs))],
        [stack(t) for t in zip(*(p.down for p in pyrs))],
        [stack(t) for t in zip(*(p.up for p in pyrs))],
    )
    return pyr, stack(p.grid.rep_point for p in pyrs), keypoints @ rots.transpose(1, 2)


def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device=device, dtype=dtype)


def extract_group_features(
    backbone: ResUNet,
    points,
    point_mask,
    keypoints,
    cfg: PipelineConfig,
    device: torch.device,
) -> torch.Tensor:
    """(N, 3) cloud (``point_mask`` (N,) bool, or None for all points) and
    (K, 3) keypoints -> (K, G, 32) backbone group features, with every
    pyramid built on ``device``: for each chunk of ``group_chunk``
    rotations, the rotated clouds' pyramids (:func:`device_chunk`), one
    batched forward, and each rotated keypoint's feature at its nearest
    voxel representative point (ties to the lower index)."""
    pts, kps = (_tensor(x, device, torch.float32) for x in (points, keypoints))
    mask = (torch.ones(pts.shape[0], dtype=torch.bool, device=device) if point_mask is None
            else _tensor(point_mask, device, torch.bool))
    g = cfg.group_size
    rots = torch.as_tensor(get_group(g).rotations.astype(np.float32), device=device)
    chunk = effective_chunk(g, cfg.group_chunk)
    outs = []
    for ci in range(g // chunk):
        pyr, rep, keys = device_chunk(pts, mask, kps, rots[ci * chunk:(ci + 1) * chunk], cfg)
        outs.append(backbone_chunk(backbone, pyr, rep, keys))
    return torch.cat(outs, 0).permute(1, 0, 2).contiguous()  # (K, G, 32)


def extract(backbone, points, point_mask, keypoints, cfg: PipelineConfig, device: torch.device,
            timings: dict[str, float] | None = None, dropped: list | None = None) -> torch.Tensor:
    """Dispatch as the reference's ``extract``: the block engine over host
    payloads (whatever ``host_maps`` says; the cloud's dropped block count
    is appended to ``dropped`` when one is given), the gather engine over
    host pyramids, or, with ``host_maps=False``, over device-built ones.
    ``points``, ``point_mask`` and ``keypoints`` are host arrays or tensors.
    -> (K, G, 32) on ``device``."""
    if cfg.engine == "gather" and not cfg.host_maps:
        return extract_group_features(backbone, points, point_mask, keypoints, cfg, device)
    host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    pts = host(points)
    if point_mask is not None:
        pts = pts[host(point_mask).astype(bool)]
    args = (backbone, pts, host(keypoints), cfg, device, timings)
    if cfg.engine == "gather":
        return extract_group_features_hostmaps(*args)
    feats, n = extract_group_features_blocks(*args)
    if dropped is not None:
        dropped.append(n)
    return feats


# ---- block engine ----


def build_cloud_payloads(points, keypoints, cfg: PipelineConfig, pool=None, empty=None):
    """Host half of the block-engine extractor: build all G rotations'
    block pyramids and keypoint cell rows (GIL-free C++ on a thread pool)
    into one whole-cloud payload, one row per chunk, with the loud
    overflow -> ``block_caps_fallback`` rebuild of the JAX package.

    ``empty(shape, dtype)`` allocates the payload and the key rows (the
    extractor passes pinned memory). Returns ``(payload (n_chunks,
    chunk_bytes) uint8, key_rows (n_chunks, chunk, K) int32, caps,
    dropped)``: ``caps`` the block capacities the payload was built at,
    ``dropped`` the blocks the build dropped at them.
    """
    g = cfg.group_size
    if pool is None:
        with ThreadPoolExecutor(max_workers=max(1, min(g, os.cpu_count() or 1))) as own:
            return build_cloud_payloads(points, keypoints, cfg, own, empty)
    rots = get_group(g).rotations.astype(np.float32)
    chunk = effective_chunk(g, cfg.group_chunk)
    n_chunks = g // chunk
    pts = np.ascontiguousarray(points, np.float32)
    kps = np.ascontiguousarray(keypoints, np.float32)
    empty = empty or (lambda shape, dtype: np.empty(shape, dtype))

    def build_cloud(caps):
        payload, trees = alloc_block_buffers_packed_rows(caps, chunk, n_chunks, empty=empty)
        kb = empty((n_chunks, chunk, kps.shape[0]), np.dtype(np.int32))

        def one(gi: int) -> int:
            ci, gj = divmod(gi, chunk)
            R = rots[gi]
            return fill_block_pyramid_host(
                pts @ R.T, cfg.voxel_size, block_tree_slice(trees[ci], gj),
                keys=kps @ R.T, key_rows=kb[ci, gj],
            )

        return payload, kb, sum(pool.map(one, range(g)))

    caps = cfg.block_caps
    payload, kb, dropped = build_cloud(caps)
    if dropped and cfg.block_caps_fallback is not None:
        print(
            f"[extract] cloud overflows block_caps {cfg.block_caps} "
            f"({dropped} blocks) -> rebuilding at fallback "
            f"{cfg.block_caps_fallback}",
            file=sys.stderr, flush=True,
        )
        caps = cfg.block_caps_fallback
        payload, kb, dropped = build_cloud(caps)
        if dropped:
            print(
                f"[extract] fallback capacities ALSO overflow "
                f"({dropped} blocks dropped) — results degrade",
                file=sys.stderr, flush=True,
            )
    return payload, kb, tuple(caps), dropped


def upload_cloud_payloads(payload: np.ndarray, key_rows: np.ndarray, device: torch.device):
    """One copy of the whole cloud's payload and key rows to ``device``
    (asynchronous from pinned memory to a GPU)."""
    return _to_device(payload, device), _to_device(key_rows, device)


def chunk_block_pyramid(dev_payload: torch.Tensor, ci: int, caps: tuple[int, ...], chunk: int):
    """Chunk ``ci``'s row of an uploaded payload as one batched block
    pyramid (views of the row, tables offset per rotation)."""
    return flatten_block_batch(unpack_block_payload(dev_payload[ci], caps, chunk), caps)


def backbone_chunk_blocks(
    backbone: BlockResUNet, pyr, rows: torch.Tensor, bcap0: int
) -> torch.Tensor:
    """One chunk as one batched forward; each rotation's keypoints read the
    feature at their flat level-0 cell row (zero where the row is -1).
    rows (B, K) -> (B, K, 32)."""
    feats = backbone(pyr)  # (B*bcap0*64, 32)
    b, k = rows.shape
    flat = offset_table(rows[:, :, None], bcap0 * CELLS).view(b, k).long()
    f = feats[flat.clamp_min(0)]
    return torch.where((flat >= 0)[..., None], f, torch.zeros((), device=f.device))


def dispatch_cloud_payloads(
    backbone: BlockResUNet, payload, key_rows, caps, cfg: PipelineConfig, device: torch.device
) -> torch.Tensor:
    """Device half of the block-engine extractor: one upload per cloud,
    then one batched forward per chunk. -> (K, G, 32)."""
    chunk = effective_chunk(cfg.group_size, cfg.group_chunk)
    dev_payload, dev_rows = upload_cloud_payloads(payload, key_rows, device)
    copied = None
    if device.type == "cuda":
        copied = torch.cuda.Event()
        copied.record()
    outs = [
        backbone_chunk_blocks(
            backbone, chunk_block_pyramid(dev_payload, ci, caps, chunk), dev_rows[ci], caps[0]
        )
        for ci in range(payload.shape[0])
    ]
    if copied is not None:  # the pinned host buffers may be released after this
        copied.synchronize()
    out = torch.cat(outs, 0)  # (G, K, 32)
    return out.permute(1, 0, 2).contiguous()


def extract_group_features_blocks(
    backbone: BlockResUNet,
    points: np.ndarray,
    keypoints: np.ndarray,
    cfg: PipelineConfig,
    device: torch.device,
    timings: dict[str, float] | None = None,
) -> tuple[torch.Tensor, int]:
    """(N, 3) host cloud + (K, 3) host keypoints -> ((K, G, 32) backbone
    group features on ``device``, dropped blocks). With ``timings``, the
    seconds the host builds took are added to ``host_wait``."""
    empty = PinnedArena() if device.type == "cuda" else None
    t0 = time.perf_counter()
    payload, key_rows, caps, dropped = build_cloud_payloads(points, keypoints, cfg, empty=empty)
    if timings is not None:
        timings["host_wait"] = timings.get("host_wait", 0.0) + time.perf_counter() - t0
    return dispatch_cloud_payloads(backbone, payload, key_rows, caps, cfg, device), dropped
