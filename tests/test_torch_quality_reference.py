"""The JAX package's own quality numbers for the committed weights, on the
CPU, as the reference of the card's quality run.

``QUALITY.json``'s ``benchmark`` rows were computed on a TPU. The JAX
package on the CPU, with the weights the port converts
(``checkpoints_quality_full/``), on the same held-out scenes, gives the
numbers that the deterministic parts of the card's run (IR and FMR of the
RD variants, RR of ``full_rd_rm_et_yohoo``) are held to:
``roreg_tpu_torch/checkpoints/quality_full/jax_cpu_reference.json``. It
records, per variant and split at keynum 1024, the JAX ``Evaluator.run``
summary, and a digest of every scene's clouds and keypoints so that the
port's scenes can be checked against the ones the reference used.

Regenerate it (about two and a half hours on 8 CPU cores; full-config
describes of 56 clouds):

    python tests/test_torch_quality_reference.py [--out PATH]
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from roreg_tpu_torch.pipeline.quality_config import quality_full_config  # noqa: E402
from roreg_tpu_torch.quality import JAX_CPU_REFERENCE, SPLITS, VARIANTS, quality_scenes  # noqa: E402

KEYNUM = 1024


def scene_digest(clouds, keypoints) -> str:
    """sha256 of a scene's float32 clouds and keypoints, in cloud order."""
    h = hashlib.sha256()
    for c, k in zip(clouds, keypoints):
        h.update(np.ascontiguousarray(c, np.float32).tobytes())
        h.update(np.ascontiguousarray(k, np.float32).tobytes())
    return h.hexdigest()


def jax_cpu_reference(root: str, log=print) -> dict:
    """The JAX package's held-out benchmark (``scripts/quality_benchmark.py
    --full``'s scenes, variants and seeds) on the CPU at keynum 1024, with
    the scenes written under ``root``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from roreg_tpu.data.synthetic import make_synthetic_scene
    from roreg_tpu.eval.evaluator import Evaluator
    from roreg_tpu.pipeline.quality_config import quality_full_config as jax_full_config
    from roreg_tpu.pipeline.quality_config import quality_scene_params
    from roreg_tpu.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.weights import QUALITY_FULL_DIR, load_checkpoint_dir

    t0 = time.time()
    cfg = jax_full_config()
    ppc, extent = quality_scene_params(small=False)
    rng = np.random.default_rng(7)
    groups, digests = {}, {}
    for split, overlap in SPLITS:
        prefix = "" if split == SPLITS[0][0] else "lo_"
        groups[split] = {}
        for i in range(4):
            name = f"{prefix}scene{i}"
            ds = make_synthetic_scene(
                os.path.join(root, name), rng, num_clouds=7, points_per_cloud=ppc,
                num_keypoints=cfg.num_keypoints, overlap=overlap, max_angle_deg=50.0,
                surface_extent=extent,
            )
            ds.name = name
            groups[split][name] = ds
            digests[name] = scene_digest(
                [ds.get_pc(k).astype(np.float32) for k in ds.pc_ids],
                [ds.get_kps(k).astype(np.float32) for k in ds.pc_ids])
    variables = jax.tree_util.tree_map(jnp.asarray, load_checkpoint_dir(QUALITY_FULL_DIR, quality_full_config()))
    store: dict = {}
    rows: dict = {}
    for vname, flags in VARIANTS.items():
        rows[vname] = {}
        for split, group in groups.items():
            pipe = RegistrationPipeline(dataclasses.replace(cfg, keynum=KEYNUM, **flags), variables)
            summary = Evaluator(pipe, desc_store=store).run(
                {**group, "wholesetname": split}, os.path.join(root, "out"), seed=KEYNUM)
            summary.pop("stage_times", None)
            rows[vname][f"{split}@{KEYNUM}"] = summary
            log(f"[+{time.time() - t0:.0f}s] {vname} {split}@{KEYNUM}: FMR {summary['fmr']:.4f} "
                f"IR {summary['ir']:.4f} RR {summary['rr_pointdsc']:.4f}")
    return {"backend": "cpu", "keynum": KEYNUM, "splits": rows, "scene_digests": digests,
            "config": dataclasses.asdict(cfg), "wall_s": time.time() - t0}


@pytest.fixture(scope="module")
def reference():
    with open(JAX_CPU_REFERENCE) as f:
        return json.load(f)


def test_reference_covers_every_variant_and_split(reference):
    cells = {f"{split}@{KEYNUM}" for split, _ in SPLITS}
    assert reference["backend"] == "cpu" and reference["keynum"] == KEYNUM
    assert set(reference["splits"]) == set(VARIANTS)
    for rows in reference["splits"].values():
        assert set(rows) == cells
        for summary in rows.values():
            assert summary["pairs"] == 84 and 0.0 <= summary["ir"] <= 1.0


def test_reference_config_is_the_ports_quality_config(reference):
    port = json.loads(json.dumps(dataclasses.asdict(quality_full_config())))
    assert reference["config"] == port


def test_port_scenes_are_the_reference_scenes(reference):
    """The port's in-memory scenes hold the very clouds and keypoints the
    JAX package read back from its files for the reference."""
    groups = quality_scenes(quality_full_config())
    digests = {name: scene_digest(s.clouds, s.keypoints) for g in groups.values() for name, s in g.items()}
    assert digests == reference["scene_digests"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the JAX package's quality numbers on the CPU")
    ap.add_argument("--out", default=JAX_CPU_REFERENCE)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_cpu_reference(tmp)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
    print(f"wrote {args.out}")
