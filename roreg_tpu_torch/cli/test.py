"""Evaluation CLI, the counterpart of ``roreg_tpu/cli/test.py``.

    python -m roreg_tpu_torch.cli.test --testset 3dmatch --RD --RM --ET yohoo \
        --keynum 1000 --max_iter 1000 --origin_data_dir ./data/origin_data

The JAX package's flags (the reference's ``Test.py:7-17``), plus
``--device`` (CUDA unless ``cpu``). ``--checkpoint_dir`` names a converted
npz set (one ``<component>.npz`` a network, as in ``checkpoints/``):
each component whose file is present is loaded and shape-checked, the
others keep the seeded init (``--random_init`` loads none). With
``--testset synthetic`` a 4-cloud synthetic scene is written and
evaluated, so the pipeline runs without 3DMatch downloads. Descriptors go
to the npz cache ``<output_dir>/desc_cache`` (which ``cli.testset`` fills
beforehand), each scene's transforms to ``<output_dir>/<scene>/pre.log``,
and the summary is appended to ``<output_dir>/results.log``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from roreg_tpu_torch.data.dataset import ThreeDMatchDataset, get_dataset_group
from roreg_tpu_torch.data.synthetic import make_synthetic_scene
from roreg_tpu_torch.eval.evaluator import Evaluator
from roreg_tpu_torch.pipeline.config import PipelineConfig
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
from roreg_tpu_torch.weights import init_variables, load_components

__all__ = ["get_parser", "apply_testset_presets", "pipeline_from_args", "load_pipeline", "main"]


def get_parser():
    p = argparse.ArgumentParser(description="roreg_tpu_torch evaluation")
    p.add_argument("--testset", default="demo",
                   choices=["demo", "3dmatch", "3dLomatch", "ETH", "WHU-TLS",
                            "synthetic"])
    p.add_argument("--origin_data_dir", default="./data/origin_data")
    p.add_argument("--output_dir", default="./data/eval_output")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--RD", action="store_true", help="use rotation detector")
    p.add_argument("--RM", action="store_true", help="use rotation matcher")
    p.add_argument("--ET", default="yohoo", choices=["yohoo", "yohoc"])
    p.add_argument("--keynum", type=int, default=1000)
    p.add_argument("--max_iter", type=int, default=1000)
    # None = "apply the per-testset preset"; explicit flags always win
    p.add_argument("--ransac_d", type=float, default=None)
    p.add_argument("--tau_1", type=float, default=0.05)
    p.add_argument("--tau_2", type=float, default=None)
    p.add_argument("--tau_3", type=float, default=None)
    p.add_argument("--voxel_size", type=float, default=None)
    p.add_argument("--group_size", type=int, default=60)
    p.add_argument("--random_init", action="store_true",
                   help="random weights (pipeline smoke/perf runs)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


# per-testset evaluation presets (reference Test.py:7-17, README.md:141-177);
# 3DMatch-family defaults fill whatever the preset leaves unset
_TESTSET_PRESETS = {
    "ETH": dict(voxel_size=0.15, ransac_d=0.5, tau_2=0.2, tau_3=0.5),
    "WHU-TLS": dict(voxel_size=0.15, ransac_d=0.5, tau_2=0.2, tau_3=0.5),
}
_GLOBAL_DEFAULTS = dict(voxel_size=0.025, ransac_d=0.1, tau_2=0.1, tau_3=0.2)


def apply_testset_presets(args):
    """Fill unset (None) eval flags from the testset's preset, then the
    3DMatch-family defaults."""
    preset = _TESTSET_PRESETS.get(args.testset, {})
    for k, v in _GLOBAL_DEFAULTS.items():
        if getattr(args, k) is None:
            setattr(args, k, preset.get(k, v))
    return args


def pipeline_from_args(cfg: PipelineConfig, args) -> RegistrationPipeline:
    """``cfg``'s pipeline on ``args.device`` with seeded random weights,
    then each component of ``args.checkpoint_dir`` loaded over them unless
    ``args.random_init``; prints which were loaded."""
    variables = init_variables(cfg, 0)
    if not args.random_init:
        loaded = load_components(args.checkpoint_dir, cfg, variables) if os.path.isdir(args.checkpoint_dir) else []
        print(f"weights: loaded {', '.join(loaded) or 'no component'} from {args.checkpoint_dir}; "
              f"seeded init for the others", flush=True)
    return RegistrationPipeline(cfg, variables, args.device)


def load_pipeline(args) -> RegistrationPipeline:
    cfg = PipelineConfig(
        voxel_size=args.voxel_size,
        group_size=args.group_size,
        keynum=args.keynum,
        max_iter=args.max_iter,
        ransac_ird=args.ransac_d,
        use_rd=args.RD,
        use_rm=args.RM,
        estimator=args.ET,
        tau_1=args.tau_1,
        tau_2=args.tau_2,
        tau_3=args.tau_3,
    )
    return pipeline_from_args(cfg, args)


def main(argv=None):
    args = apply_testset_presets(get_parser().parse_args(argv))
    if args.testset == "synthetic":
        root = os.path.join(args.origin_data_dir, "synthetic", "scene0")
        if not os.path.exists(root):
            make_synthetic_scene(
                root, np.random.default_rng(0), num_clouds=4,
                points_per_cloud=20000, num_keypoints=5000,
            )
        ds = ThreeDMatchDataset(root, 4)
        ds.name = "synthetic/scene0"
        datasets = {"wholesetname": "synthetic", "scene0": ds}
    else:
        datasets = get_dataset_group(args.testset, args.origin_data_dir)

    pipe = load_pipeline(args)
    ev = Evaluator(
        pipe,
        cache_dir=os.path.join(args.output_dir, "desc_cache"),
        results_log=os.path.join(args.output_dir, "results.log"),
    )
    summary = ev.run(datasets, args.output_dir)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
