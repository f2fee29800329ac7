"""Trainset CLI, the counterpart of ``roreg_tpu/cli/trainset.py``.

    python -m roreg_tpu_torch.cli.trainset --component GF --num_batches 1000 \
        --out_dir ./data/trainset_cache

The trainers draw their batches on the fly (``train/data.py``); this tool
writes them as ``<out_dir>/<comp>/<i>.npz`` for runs that should not
describe inside the training loop. The JAX package's flags, plus
``--device`` (CUDA unless ``cpu``); the scenes and the pipeline are
``cli.train``'s.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from roreg_tpu_torch.cli.train import build_scenes, train_pipeline
from roreg_tpu_torch.train.data import RotatedFeatureCache, gf_et_batches, rm_batches

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description="roreg_tpu_torch trainset pre-generation")
    p.add_argument("--component", required=True, choices=["GF", "ET", "RM"])
    p.add_argument("--data_root", default="./data/origin_data")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--out_dir", default="./data/trainset_cache")
    p.add_argument("--num_batches", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--group_size", type=int, default=60)
    p.add_argument("--synthetic_scenes", type=int, default=4)
    p.add_argument("--voxel_size", type=float, default=0.025)
    # the PCA-planarity keypoint filter of GF/ET; <= 0 disables it
    p.add_argument("--pca_thre", type=float, default=0.03)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    comp = args.component.lower()
    pipe, _ = train_pipeline(args)
    scenes = build_scenes(args)
    rng = np.random.default_rng(args.seed + 1)
    out = os.path.join(args.out_dir, comp)
    os.makedirs(out, exist_ok=True)
    if comp in ("gf", "et"):
        it = gf_et_batches(RotatedFeatureCache(pipe), scenes, args.batch_size, rng,
                           pca_thre=args.pca_thre if args.pca_thre > 0 else None)
    else:
        gf_feats = {}
        for ds in scenes:
            for pc_id in ds.pc_ids:
                _, gf = pipe.describe(ds.get_pc(pc_id).astype(np.float32), None,
                                      ds.get_kps(pc_id).astype(np.float32))
                gf_feats[(ds.name, pc_id)] = gf.float().cpu().numpy()
        it = rm_batches(gf_feats, scenes, rng, min_ps=256, max_ps=1024, capacity=1024, group_size=args.group_size)
    for i in range(args.num_batches):
        np.savez_compressed(os.path.join(out, f"{i}.npz"), **{k: np.asarray(v) for k, v in next(it).items()})
    summary = {"component": comp, "batches": args.num_batches, "dir": out}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
