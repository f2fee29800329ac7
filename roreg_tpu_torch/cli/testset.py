"""Descriptor pre-extraction CLI, the counterpart of
``roreg_tpu/cli/testset.py``.

    python -m roreg_tpu_torch.cli.testset --dataset 3dmatch --voxel_size 0.025 \
        --origin_data_dir ./data/origin_data --outdir ./data/eval_output

Describes every cloud of the named dataset group into the evaluator's npz
cache, ``<outdir>/desc_cache/<scene>/<id>.npz`` with keys ``bb``, ``gf``
and ``det`` (the JAX package's layout), so that a later ``cli.test`` run
with ``--output_dir <outdir>`` skips the describes. Weights and
``--device`` as in ``cli.test``.
"""

from __future__ import annotations

import argparse
import os

from roreg_tpu_torch.cli.test import pipeline_from_args
from roreg_tpu_torch.data.dataset import ThreeDMatchDataset, get_dataset_group
from roreg_tpu_torch.eval.evaluator import Evaluator
from roreg_tpu_torch.pipeline.config import PipelineConfig

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="demo")
    p.add_argument("--origin_data_dir", default="./data/origin_data")
    p.add_argument("--outdir", default="./data/eval_output")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--voxel_size", type=float, default=0.025)
    p.add_argument("--group_size", type=int, default=60)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = PipelineConfig(voxel_size=args.voxel_size, group_size=args.group_size)
    pipe = pipeline_from_args(cfg, args)
    ev = Evaluator(pipe, cache_dir=os.path.join(args.outdir, "desc_cache"))
    datasets = get_dataset_group(args.dataset, args.origin_data_dir)
    n = 0
    for ds in datasets.values():
        if not isinstance(ds, ThreeDMatchDataset):
            continue
        for pc_id in ds.pc_ids:
            ev.describe_cloud(ds, pc_id)
            n += 1
    print(f"extracted {n} clouds into {args.outdir}/desc_cache")
    return n


if __name__ == "__main__":
    main()
