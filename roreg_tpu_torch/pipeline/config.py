"""Single typed config tree for the inference pipeline.

A copy of ``roreg_tpu/pipeline/config.py``'s ``PipelineConfig``: same
fields, same defaults (the paper's 3DMatch evaluation settings).
:func:`check_supported` refuses the values and combinations the reference
cannot run either.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PipelineConfig", "check_supported", "rm_row_block"]


@dataclass(frozen=True)
class PipelineConfig:
    # geometry
    voxel_size: float = 0.025
    group_size: int = 60

    # static capacities (buckets) for the sparse pyramid, finest level first
    capacities: tuple[int, ...] = (32768, 16384, 8192, 4096)
    conv1_kernel_size: int = 7
    backbone_variant: str = "ResUNetBN2C"
    backbone_compute_dtype: str | None = "bfloat16"  # conv gather+GEMM dtype

    # how many of the G rotations run per backbone pass (one batched
    # forward per chunk in the port)
    group_chunk: int = 10
    rot_vmap: int = 1
    # backbone execution engine: "block" (block-dense engine over host
    # block tables) or "gather" (row-gather engine over host kernel maps)
    engine: str = "block"
    block_caps: tuple[int, ...] = (3072, 1024, 512, 256)
    block_caps_fallback: tuple[int, ...] | None = None
    # TPU slab width of the windowed gather conv. Accepted for config
    # compatibility and ignored: the Hopper kernel gathers rows directly and
    # has no locality bound.
    conv_window: int | None = None
    # build coordinate pyramids on host (native C++); False builds the
    # gather engine's pyramids on the device (the block engine ignores it)
    host_maps: bool = True

    # keypoints
    num_keypoints: int = 5000
    keynum: int = 1000
    nms_k: int = 5

    # matcher
    use_rd: bool = True
    use_rm: bool = True
    match_n: float = 0.5
    sinkhorn_iters: int = 100
    coor_norm_step: float = 0.025
    rm_row_block: int | None = None

    # estimator
    estimator: str = "yohoo"  # or "yohoc"
    max_iter: int = 1000
    ransac_ird: float = 0.1

    pose_sync: bool = False

    # eval thresholds
    tau_1: float = 0.05
    tau_2: float = 0.1
    tau_3: float = 0.2
    rr_rot_deg: float = 15.0
    rr_trans: float = 0.3

    # batching
    bs_gf: int = 1250
    bs_et: int = 1000
    eval_pair_batch: int = 6


def check_supported(cfg: PipelineConfig) -> None:
    """Raise ``ValueError`` for unknown values and for the combinations the
    reference cannot run either."""
    if cfg.engine not in ("block", "gather"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.estimator not in ("yohoo", "yohoc"):
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    from roreg_tpu_torch.sparse.resunet import RESUNET_VARIANTS, SIMPLENET_VARIANTS

    variant = cfg.backbone_variant
    if variant not in RESUNET_VARIANTS and variant not in SIMPLENET_VARIANTS:
        raise ValueError(f"unknown backbone variant {variant!r}")
    # the combinations the reference cannot run either: its block engine
    # builds batch-norm ResUNet blocks only, and its host-map gather
    # describe builds a ResUNet
    if cfg.engine == "block" and RESUNET_VARIANTS.get(variant, (0, 0, ""))[2] != "BN":
        raise ValueError(f"backbone {variant!r} does not run on the block engine, whose residual "
                         "blocks are batch-norm ResUNet blocks only (as in the reference); use "
                         "engine='gather' for the IN ResUNets")
    if cfg.engine == "gather" and variant in SIMPLENET_VARIANTS:
        raise ValueError(f"backbone {variant!r}: the host-map gather describe runs the ResUNets "
                         "only (as in the reference); a SimpleNet runs through make_backbone")


def rm_row_block(cfg: PipelineConfig) -> int | None:
    """The RM matcher's kNN row block: ``rm_row_block`` where set, else 512
    rows when ``keynum`` exceeds 1536 (peak attention memory block x N, not
    M x N), else none."""
    if cfg.rm_row_block is not None:
        return cfg.rm_row_block
    return 512 if cfg.keynum > 1536 else None
