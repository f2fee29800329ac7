"""Demo CLI, the counterpart of ``roreg_tpu/cli/demo.py``.

    python -m roreg_tpu_torch.cli.demo [--random_init] [--out_png reg.png]

Writes (or reuses) a synthetic two-cloud scene at
``<data_root>/demo/kitchen``, registers its pair through
``RegistrationPipeline.register_pair``, prints the predicted and the
ground-truth transform and a JSON line of RRE, RTE and success. Weights
and ``--device`` as in ``cli.test``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from roreg_tpu_torch.cli.test import pipeline_from_args
from roreg_tpu_torch.data.dataset import ThreeDMatchDataset
from roreg_tpu_torch.data.synthetic import make_synthetic_scene
from roreg_tpu_torch.eval.metrics import registration_errors
from roreg_tpu_torch.pipeline.config import PipelineConfig

__all__ = ["main"]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="./data/origin_data")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--keynum", type=int, default=250)
    p.add_argument("--group_size", type=int, default=60)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--out_png", default=None,
                   help="write a before/after registration rendering "
                        "(headless analog of utils_o3d.py "
                        "draw_registration_result)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    root = os.path.join(args.data_root, "demo", "kitchen")
    if not os.path.exists(f"{root}/PointCloud/gt.log"):
        make_synthetic_scene(
            root, np.random.default_rng(0), num_clouds=2,
            points_per_cloud=20000, num_keypoints=5000,
        )
    ds = ThreeDMatchDataset(root, 2)

    cfg = PipelineConfig(keynum=args.keynum, group_size=args.group_size)
    pipe = pipeline_from_args(cfg, args)
    pc0, pc1 = (ds.get_pc(k).astype(np.float32) for k in (0, 1))
    k0, k1 = (ds.get_kps(k).astype(np.float32) for k in (0, 1))
    out = pipe.register_pair(pc0, None, k0, pc1, None, k1,
                             generator=torch.Generator(device=pipe.device).manual_seed(1))
    T = out["transform"].cpu().numpy()
    T_gt = ds.get_transform("0", "1")
    rre, rte = registration_errors(T, T_gt)
    print("predicted transform:\n", np.round(T, 4))
    print("ground truth:\n", np.round(T_gt, 4))
    if args.out_png:
        from roreg_tpu_torch.data.visualize import draw_registration

        # gt convention pts0 = T @ pts1: cloud 1 is the source
        draw_registration(pc1, pc0, T, args.out_png)
        print(f"registration rendering written to {args.out_png}")
    result = {"rre_deg": rre, "rte_m": rte, "success": bool(rre < 15 and rte < 0.3)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
