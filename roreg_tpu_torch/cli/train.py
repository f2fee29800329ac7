"""Training CLI, the counterpart of ``roreg_tpu/cli/train.py``.

    python -m roreg_tpu_torch.cli.train --component GF --steps 100000 \
        --data_root ./data/origin_data --checkpoint_dir ./checkpoints

Components: GF (descriptor), RD (detector), RM (matcher), ET (local
rotation) and the FCGF backbone; the JAX package's flags, plus
``--device`` (CUDA unless ``cpu``). Training scenes are synthetic
(``make_synthetic_scene``, 3 clouds of 20000 points and 1024 keypoints
each, written under
``<data_root>/synthetic_train/scene<i>`` unless present there). The
pipeline behind the features carries seeded random weights, with each
network found in ``--checkpoint_dir`` loaded over them (``<comp>.npz`` or
a trainer's ``<COMP>/model_best``); the trained head starts from the
port's seeded init, or resumes from ``<checkpoint_dir>/<COMP>/model``.
Checkpoints go to ``<checkpoint_dir>/<COMP>/model`` and ``model_best`` in
the layout ``RegistrationPipeline`` loads (``train/checkpoints.py``): name
a directory outside the source tree.

``--component backbone`` trains the backbone of ``PipelineConfig(voxel,
group size, 1024 keypoints)`` (ResUNetBN2C, the gather engine's network,
bf16 convs) with the hardest-contrastive loss and SGD (``train/backbone.py``)
for ``--steps`` (default 20000) steps on fragment pairs of the scenes
(``seed + 1`` draws them), printing every 200 steps, and writes its
variables to ``<checkpoint_dir>/backbone_variables/backbone.npz``, which
``train.checkpoints.load_pipeline_variables`` loads into either engine.

``--n_devices N`` trains a head data-parallel over a world of N
processes, one a device (``dist.mesh.shard_train_step``: each rank runs
its shard of every batch, and the update equals one process's on the
whole batch); run it as ``torchrun --nproc_per_node N -m
roreg_tpu_torch.cli.train --n_devices N ...`` (NCCL on the cards, gloo on
the CPU); a world of another size raises. Only the first process writes
logs and checkpoints. The backbone trains in one process, as in the
reference, whose ``--n_devices`` shards the heads' steps only.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from roreg_tpu_torch.data.dataset import ThreeDMatchDataset
from roreg_tpu_torch.data.synthetic import make_synthetic_scene
from roreg_tpu_torch.dist import multihost
from roreg_tpu_torch.dist.mesh import make_mesh, shard_train_step
from roreg_tpu_torch.pipeline.config import PipelineConfig
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
from roreg_tpu_torch.train.backbone import backbone_pair_batches, make_backbone_train_step
from roreg_tpu_torch.train.checkpoints import load_pipeline_variables, save_variables
from roreg_tpu_torch.train.data import RotatedFeatureCache, gf_et_batches, rd_batches, rm_batches
from roreg_tpu_torch.train.selfrun import build_rd_match_bank
from roreg_tpu_torch.train.trainer import TrainConfig, Trainer
from roreg_tpu_torch.train.validators import make_val_fn
from roreg_tpu_torch.weights import export_variables, init_variables

__all__ = ["get_parser", "build_scenes", "train_pipeline", "prepare", "train_backbone", "main", "SCENE"]

# the training scenes' size (the JAX package's cli.train)
SCENE = dict(num_clouds=3, points_per_cloud=20000, num_keypoints=1024)


def get_parser():
    p = argparse.ArgumentParser(description="roreg_tpu_torch training")
    p.add_argument("--component", required=True, choices=["GF", "RD", "RM", "ET", "backbone"])
    p.add_argument("--data_root", default="./data/origin_data")
    p.add_argument("--trainset", default="synthetic")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--val_interval", type=int, default=None,
                   help="steps between validation passes (default: the component's reference setting)")
    p.add_argument("--val_batches", type=int, default=4,
                   help="held-out batches for the best-checkpoint gate (0 disables validation)")
    p.add_argument("--group_size", type=int, default=60)
    p.add_argument("--synthetic_scenes", type=int, default=4)
    p.add_argument("--voxel_size", type=float, default=0.025)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_devices", type=int, default=0,
                   help="data parallel over a device mesh (0 or 1: the one device)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def build_scenes(args) -> list:
    """``--synthetic_scenes`` scenes of :data:`SCENE`'s size, read from
    ``<data_root>/synthetic_train/scene<i>`` where a gt.log is there, else
    written there first (draws from ``default_rng(seed)``)."""
    rng = np.random.default_rng(args.seed)
    scenes = []
    for i in range(args.synthetic_scenes):
        root = os.path.join(args.data_root, "synthetic_train", f"scene{i}")
        if os.path.exists(f"{root}/PointCloud/gt.log"):
            ds = ThreeDMatchDataset(root, SCENE["num_clouds"])
        else:
            ds = make_synthetic_scene(root, rng, **SCENE)
        ds.name = f"synthetic_train/scene{i}"
        scenes.append(ds)
    return scenes


def train_pipeline(args) -> tuple[RegistrationPipeline, dict]:
    """The pipeline whose describe feeds training, and its variables:
    ``PipelineConfig`` at the flags' voxel and group size (the default
    block engine), seeded random weights, the networks of
    ``--checkpoint_dir`` loaded over them."""
    cfg = PipelineConfig(voxel_size=args.voxel_size, group_size=args.group_size,
                         num_keypoints=SCENE["num_keypoints"])
    variables = init_variables(cfg, args.seed)
    if os.path.isdir(args.checkpoint_dir):
        load_pipeline_variables(args.checkpoint_dir, variables, cfg)
    return RegistrationPipeline(cfg, variables, args.device), variables


def prepare(args) -> tuple[Trainer, dict]:
    """Everything before the step loop: the component's pipeline, scenes,
    batch iterator (the feature cache, the RM descriptors or the RD match
    bank: each describes on the device), held-out batches and trainer.
    Returns the trainer and ``{"pipeline", "scenes", "cache"}`` (``cache``
    the GF/ET feature cache, else None)."""
    comp = args.component.lower()
    mesh = _mesh(args)
    pipe, variables = train_pipeline(args)
    with multihost.primary_first():  # the first process writes the scenes the others read
        scenes = build_scenes(args)
    rng = np.random.default_rng(args.seed + 1)
    tcfg_kw = dict(group_size=args.group_size, model_dir=args.checkpoint_dir)
    if args.val_interval:
        tcfg_kw["val_interval"] = args.val_interval
    tcfg = TrainConfig.defaults(comp, **tcfg_kw)

    frozen, cache = None, None
    if comp in ("gf", "et"):
        cache = RotatedFeatureCache(pipe)
        data = gf_et_batches(cache, scenes, tcfg.batch_size, rng)
        if comp == "et":
            frozen = {"gf": variables["gf"]}
    elif comp == "rm":
        # each cloud's descriptor features from the current GF weights
        gf_feats = {}
        for ds in scenes:
            for pc_id in ds.pc_ids:
                kp = ds.get_kps(pc_id).astype(np.float32)
                _, gf = pipe.describe(ds.get_pc(pc_id).astype(np.float32), None, kp)
                gf_feats[(ds.name, pc_id)] = gf.float().cpu().numpy()
        data = rm_batches(gf_feats, scenes, rng, min_ps=256, max_ps=1024, capacity=1024,
                          group_size=args.group_size)
    else:
        data = rd_batches(build_rd_match_bank(pipe, scenes, seed=args.seed), tcfg.batch_size, rng)

    # held-out batches drive the best-checkpoint gate
    val_fn = None
    if args.val_batches:
        val_batches = [next(data) for _ in range(args.val_batches)]
        val_fn = make_val_fn(comp, args.group_size, val_batches, frozen=frozen)
    trainer = Trainer(tcfg, data, val_fn=val_fn, frozen=frozen, device=pipe.device)
    if mesh is not None:
        trainer.step_fn = shard_train_step(trainer.step_fn, mesh)
    return trainer, {"pipeline": pipe, "scenes": scenes, "cache": cache}


def _mesh(args):
    """``--n_devices``: None for 0; else the mesh of the world this process
    joins from ``torchrun``'s environment, which must hold that many
    processes (each then computes on its own card unless ``--device cpu``)."""
    if not args.n_devices:
        return None
    backend = "gloo" if args.device == "cpu" else None
    multihost.initialize(backend=backend)
    return make_mesh(args.n_devices, device=args.device)


def train_backbone(args) -> dict:
    """``--component backbone``: the JAX package's loop. The first batch
    is drawn before the loop, each step trains on the batch in hand and
    then draws the next. Returns ``final_step``, the checkpoint's directory,
    every step's loss, and the seconds spent building batches on the host
    (pyramids and pairing) and in the steps (synchronised)."""
    if args.n_devices > 1:
        raise ValueError(f"--n_devices {args.n_devices}: the backbone trains in one process (the reference's "
                         "--n_devices shards the heads' steps only)")
    cfg = PipelineConfig(voxel_size=args.voxel_size, group_size=args.group_size,
                         num_keypoints=SCENE["num_keypoints"])
    scenes = build_scenes(args)
    rng = np.random.default_rng(args.seed + 1)
    init_fn, step_fn = make_backbone_train_step(cfg, device=args.device)
    it = backbone_pair_batches(scenes, cfg, rng)
    t0 = time.perf_counter()
    batch = next(it)
    host_s = time.perf_counter() - t0
    state = init_fn(seed=args.seed)
    steps = args.steps or 20000
    losses, step_s = [], 0.0
    for i in range(steps):
        t0 = time.perf_counter()
        m = step_fn(state, batch)
        losses.append(float(m["loss"]))  # synchronises with the device
        step_s += time.perf_counter() - t0
        if (i + 1) % 200 == 0:
            print(f"step {i + 1} loss {losses[-1]:.4f} pos {float(m['pos_dist']):.3f} "
                  f"neg {float(m['neg_dist']):.3f}")
        t0 = time.perf_counter()
        batch = next(it)
        host_s += time.perf_counter() - t0
    path = os.path.join(args.checkpoint_dir, "backbone_variables")
    save_variables(path, "backbone", export_variables(state.net), cfg.group_size)
    print(json.dumps({"final_step": steps}))
    return {"final_step": steps, "checkpoint": path, "losses": losses, "host_s": host_s,
            "step_s": step_s}


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.component == "backbone":
        return train_backbone(args)
    trainer, _ = prepare(args)
    result = trainer.run(steps=args.steps)
    print(json.dumps({k: str(v) for k, v in result.items()}))
    return result


if __name__ == "__main__":
    main()
