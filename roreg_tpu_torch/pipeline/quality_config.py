"""Canonical configs of the committed quality weights.

A copy of ``roreg_tpu/pipeline/quality_config.py``: the weights under
``roreg_tpu_torch/checkpoints/quality_full/`` were trained and evaluated
under :func:`quality_full_config`, and the held-out quality run
(``python -m roreg_tpu_torch.quality``) takes its configuration and scene
parameters from here.
"""

from __future__ import annotations

from roreg_tpu_torch.pipeline.config import PipelineConfig

__all__ = [
    "quality_small_config",
    "quality_full_config",
    "quality_scene_params",
]


def quality_small_config(group_size: int = 60) -> PipelineConfig:
    """The small quality config: coarser voxels and smaller clouds."""
    return PipelineConfig(
        voxel_size=0.05,
        group_size=group_size,
        capacities=(8192, 4096, 2048, 1024),
        block_caps=(1024, 512, 256, 128),
        conv1_kernel_size=5,
        group_chunk=6 if group_size == 60 else 4,
        num_keypoints=1024,
        keynum=1024,
        max_iter=1000,
        ransac_ird=0.1,
    )


def quality_full_config(group_size: int = 60) -> PipelineConfig:
    """The protocol-scale quality config: 2.5 cm voxels, 20k-point clouds."""
    return PipelineConfig(
        voxel_size=0.025,
        group_size=group_size,
        capacities=(16384, 8192, 4096, 2048),
        conv1_kernel_size=5,
        group_chunk=6 if group_size == 60 else 4,
        num_keypoints=2048,
        keynum=2048,
        max_iter=1000,
        ransac_ird=0.07,
    )


def quality_scene_params(small: bool) -> tuple[int, float]:
    """(points_per_cloud, surface_extent) of the synthetic quality scenes:
    about 2.7 points per voxel, as in real 3DMatch fragments."""
    return (8000, 1.6) if small else (20000, 2.0)
