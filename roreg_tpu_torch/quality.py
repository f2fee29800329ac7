"""Held-out registration quality of the committed weights.

    python -m roreg_tpu_torch.quality [--keynums 1024,500,250] [--variants all] [--out PATH]

The port of the JAX package's protocol benchmark
(``scripts/quality_benchmark.py --full``, without its pose-sync probe): the
weights of ``checkpoints/quality_full/`` under ``quality_full_config()``,
on 4 held-out synthetic scenes of 7 clouds at overlap 0.75
(``3dmatch_analog``) and 4 at overlap 0.45 (``3dlomatch_analog``), all
drawn from one ``numpy.random.default_rng(7)``; 21 pairs a scene, 84 a
split. Four chain variants (the ablation of the reference's Appendix Table
2) run at each keynum, each with ``seed=keynum``. Every cloud is described
once, into one descriptor store that all variants and keynums share, and
the describes are timed apart from the pair stages.

It prints FMR, IR, RR, RRE and RTE per variant, split and keynum, with the
JAX package's rows beside each (on the CPU with these weights at keynum
1024, ``checkpoints/quality_full/jax_cpu_reference.json``; on a TPU,
``QUALITY.json``'s ``benchmark``), and the pair stages' pairs per second; ``--out`` also writes them as JSON. It runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from roreg_tpu_torch.data.synthetic import synthetic_scene
from roreg_tpu_torch.eval.evaluator import Evaluator
from roreg_tpu_torch.pipeline.config import PipelineConfig
from roreg_tpu_torch.pipeline.quality_config import quality_full_config, quality_scene_params
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

__all__ = [
    "VARIANTS",
    "SPLITS",
    "quality_scenes",
    "jax_references",
    "describe_scenes",
    "run_variants",
    "format_row",
]

VARIANTS = {
    "mutual_yohoc": dict(use_rd=False, use_rm=False, estimator="yohoc"),
    "rd_yohoc": dict(use_rd=True, use_rm=False, estimator="yohoc"),
    "rd_rm_yohoc": dict(use_rd=True, use_rm=True, estimator="yohoc"),
    "full_rd_rm_et_yohoo": dict(use_rd=True, use_rm=True, estimator="yohoo"),
}
# (split, overlap of its scenes); the hi-overlap scenes are drawn first
SPLITS = (("3dmatch_analog", 0.75), ("3dlomatch_analog", 0.45))
QUALITY_JSON = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "QUALITY.json")
# the JAX package's numbers for the committed weights on the CPU at keynum
# 1024 (written by tests/test_torch_quality_reference.py)
JAX_CPU_REFERENCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "checkpoints", "quality_full", "jax_cpu_reference.json")


def quality_scenes(
    cfg: PipelineConfig, scenes: int = 4, clouds: int = 7,
    points_per_cloud: int | None = None, surface_extent: float | None = None,
) -> dict[str, dict]:
    """{split: {scene name: SyntheticScene}}: ``scenes`` scenes a split, the
    splits in :data:`SPLITS`'s order, all from one ``default_rng(7)`` as
    the JAX benchmark draws them. Points per cloud and surface extent
    default to ``quality_scene_params(small=False)``."""
    ppc, extent = quality_scene_params(small=False)
    ppc = points_per_cloud or ppc
    extent = surface_extent or extent
    rng = np.random.default_rng(7)
    out = {}
    for split, overlap in SPLITS:
        prefix = "" if split == SPLITS[0][0] else "lo_"
        out[split] = {
            f"{prefix}scene{i}": synthetic_scene(
                rng, num_clouds=clouds, points_per_cloud=ppc, num_keypoints=cfg.num_keypoints,
                overlap=overlap, max_angle_deg=50.0, surface_extent=extent, name=f"{prefix}scene{i}",
            )
            for i in range(scenes)
        }
    return out


def jax_references() -> dict[str, dict]:
    """The JAX package's rows, ``{"cpu": rows, "tpu": rows}`` with rows
    ``{variant: {"split@keynum": summary}}``: on the CPU with the committed
    weights at keynum 1024 (:data:`JAX_CPU_REFERENCE`), and on a TPU at
    every keynum (``QUALITY.json``'s ``benchmark``). A missing file gives
    no rows."""
    out = {"cpu": {}, "tpu": {}}
    if os.path.exists(JAX_CPU_REFERENCE):
        with open(JAX_CPU_REFERENCE) as f:
            out["cpu"] = json.load(f)["splits"]
    if os.path.exists(QUALITY_JSON):
        with open(QUALITY_JSON) as f:
            out["tpu"] = json.load(f).get("benchmark", {}).get("splits", {})
    return out


def describe_scenes(pipe: RegistrationPipeline, groups: dict[str, dict], desc_store: dict) -> dict:
    """Describe every cloud of ``groups`` once into ``desc_store``. Returns
    ``{"clouds", "seconds", "dropped_blocks"}`` (the dropped block count
    summed over the clouds)."""
    ev = Evaluator(pipe, desc_store=desc_store)
    t0 = time.perf_counter()
    n = 0
    for scenes in groups.values():
        for scene in scenes.values():
            for k in range(len(scene.clouds)):
                ev.describe_cloud(scene, k)
                n += 1
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    return {"clouds": n, "seconds": time.perf_counter() - t0,
            "dropped_blocks": int(sum(ev.dropped_blocks.values()))}


def run_variants(
    variables: dict, cfg: PipelineConfig, groups: dict[str, dict], variants: dict,
    keynums: list[int], desc_store: dict, device=None, log=print,
) -> dict:
    """Every variant at every keynum on every split, from ``desc_store``
    (clouds not in it are described on the way). ``{variant:
    {"split@keynum": Evaluator.run summary}}``."""
    results = {}
    for vname, flags in variants.items():
        results[vname] = {}
        for keynum in keynums:
            pipe = RegistrationPipeline(dataclasses.replace(cfg, keynum=keynum, **flags), variables, device)
            ev = Evaluator(pipe, desc_store=desc_store)
            for split, scenes in groups.items():
                summary = ev.run(scenes, seed=keynum)
                results[vname][f"{split}@{keynum}"] = summary
                log(format_row(vname, f"{split}@{keynum}", summary))
    return results


def format_row(variant: str, cell: str, summary: dict, refs: dict | None = None) -> str:
    """One line of the table: the port's numbers, the JAX package's in
    brackets (``refs``: ``{label: summary}``, by default every row of
    :func:`jax_references` for this variant and cell)."""
    if refs is None:
        refs = {k: r[variant][cell] for k, r in jax_references().items() if cell in r.get(variant, {})}

    def val(key: str, fmt: str) -> str:
        mine = format(summary[key], fmt)
        if not refs:
            return mine
        return f"{mine} (JAX " + ", ".join(f"{k} {format(r[key], fmt)}" for k, r in refs.items()) + ")"

    return (f"{variant:20s} {cell:22s} FMR {val('fmr', '.3f')} IR {val('ir', '.3f')} "
            f"RR {val('rr_pointdsc', '.3f')} RRE {val('rre', '.3f')} RTE {val('rte', '.4f')} "
            f"{summary['pairs']} pairs, {summary['pairs_per_sec']:.2f} pairs/s")


def main(argv=None) -> int:
    from roreg_tpu_torch.weights import QUALITY_FULL_DIR, load_checkpoint_dir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keynums", default="1024,500,250")
    ap.add_argument("--variants", default="all", help="comma list of variants, or 'all'")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[quality +{time.perf_counter() - t0:.0f}s] {msg}", flush=True)

    cfg = quality_full_config()
    variables = load_checkpoint_dir(QUALITY_FULL_DIR, cfg)
    variants = dict(VARIANTS) if args.variants == "all" else {
        v: VARIANTS[v] for v in args.variants.split(",")}
    keynums = [int(k) for k in args.keynums.split(",")]
    groups = quality_scenes(cfg)
    log(f"scenes built: {', '.join(f'{s} {len(g)} scenes' for s, g in groups.items())}")
    desc_store: dict = {}
    pipe = RegistrationPipeline(cfg, variables, args.device)
    device = {"name": "cpu"}
    if pipe.device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        device = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    log(f"device: {device}")
    described = describe_scenes(pipe, groups, desc_store)
    del pipe
    log(f"described {described['clouds']} clouds in {described['seconds']:.1f} s, "
        f"{described['dropped_blocks']} dropped blocks")
    results = run_variants(variables, cfg, groups, variants, keynums, desc_store, args.device, log)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "describe": described, "splits": results,
                       "wall_s": time.perf_counter() - t0}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
