"""The quality slice's host pieces against the JAX package: the quality
configs, the metrics, and the in-memory synthetic scenes of the held-out
benchmark."""

import dataclasses

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from roreg_tpu_torch.eval import metrics  # noqa: E402
from roreg_tpu_torch.pipeline import quality_config  # noqa: E402

METRIC_TOL = 1e-12  # the same float64 numpy arithmetic
GT_TOL = 1e-8  # gt.log keeps 9 decimals


@pytest.mark.parametrize("name", ["quality_small_config", "quality_full_config"])
@pytest.mark.parametrize("group_size", [60, 24])
def test_quality_configs_equal_jax(name, group_size):
    from roreg_tpu.pipeline import quality_config as jq

    port = dataclasses.asdict(getattr(quality_config, name)(group_size))
    ref = dataclasses.asdict(getattr(jq, name)(group_size))
    assert port == ref


def test_quality_scene_params_equal_jax():
    from roreg_tpu.pipeline import quality_config as jq

    for small in (True, False):
        assert quality_config.quality_scene_params(small) == jq.quality_scene_params(small)


def test_metrics_equal_jax():
    from roreg_tpu.eval import metrics as jm

    rng = np.random.default_rng(0)
    for _ in range(20):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.normal(size=3)
        T_pre = T.copy()
        T_pre[:3, 3] += 0.05 * rng.normal(size=3)
        k1 = rng.uniform(-1, 1, (200, 3))
        k0 = k1 @ T[:3, :3].T + T[:3, 3] + 0.08 * rng.normal(size=(200, 3))
        valid = rng.random(200) > 0.3
        got = metrics.fmr_ir(k0, k1, valid, T, 0.05, 0.1)
        ref = jm.fmr_ir(k0, k1, valid, T, 0.05, 0.1)
        assert np.abs(np.subtract(got, ref)).max() <= METRIC_TOL
        got = metrics.registration_errors(T_pre, T)
        ref = jm.registration_errors(T_pre, T)
        assert np.abs(np.subtract(got, ref)).max() <= METRIC_TOL
    assert metrics.fmr_ir(k0, k1, np.zeros(200, bool), T) == jm.fmr_ir(k0, k1, np.zeros(200, bool), T)


@pytest.mark.parametrize("overlap", [0.75, 0.45])
def test_synthetic_scene_equals_the_files_of_make_synthetic_scene(tmp_path, overlap):
    """The same draws as ``make_synthetic_scene`` read back through
    ``ThreeDMatchDataset``: clouds and keypoints bit-equal, gt to 1e-8,
    and both generators left at the same place of the stream."""
    from roreg_tpu.data.synthetic import make_synthetic_scene

    kw = dict(num_clouds=3, points_per_cloud=2000, num_keypoints=300, overlap=overlap,
              max_angle_deg=50.0, surface_extent=1.2)
    rng_j, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    ds = make_synthetic_scene(str(tmp_path / "scene"), rng_j, **kw)
    scene = synthetic_scene(rng_p, **kw, name="scene")
    assert len(scene.clouds) == 3 and list(scene.gt) == [(0, 1), (0, 2), (1, 2)]
    assert [tuple(map(int, p)) for p in ds.pair_ids] == list(scene.gt)
    for k in range(3):
        pc = ds.get_pc(str(k)).astype(np.float32)
        kp = ds.get_kps(str(k)).astype(np.float32)
        assert scene.clouds[k].dtype == np.float32 and np.array_equal(scene.clouds[k], pc)
        assert scene.keypoints[k].dtype == np.float32 and np.array_equal(scene.keypoints[k], kp)
    for (i, j), T in scene.gt.items():
        assert np.abs(T - ds.get_transform(str(i), str(j))).max() <= GT_TOL
    assert rng_p.random() == rng_j.random()


def test_quality_scenes_draw_the_splits_from_one_stream():
    """Both splits come from one default_rng(7), the hi-overlap split first:
    the lo split's first scene is the one a second synthetic_scene call on
    the same stream makes."""
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.quality import quality_scenes

    cfg = dataclasses.replace(quality_full_config(), num_keypoints=50)
    groups = quality_scenes(cfg, scenes=1, clouds=2, points_per_cloud=600, surface_extent=1.0)
    assert list(groups) == ["3dmatch_analog", "3dlomatch_analog"]
    assert list(groups["3dlomatch_analog"]) == ["lo_scene0"]
    rng = np.random.default_rng(7)
    kw = dict(num_clouds=2, points_per_cloud=600, num_keypoints=50, max_angle_deg=50.0, surface_extent=1.0)
    hi = synthetic_scene(rng, overlap=0.75, **kw)
    lo = synthetic_scene(rng, overlap=0.45, **kw)
    assert np.array_equal(groups["3dmatch_analog"]["scene0"].clouds[1], hi.clouds[1])
    assert np.array_equal(groups["3dlomatch_analog"]["lo_scene0"].keypoints[0], lo.keypoints[0])


def test_quality_sweep_describes_each_cloud_once():
    """The quality run's flow at a tiny size on the CPU: every cloud is
    described once into the shared store, then every variant and keynum
    registers every pair from it; rows carry the JAX row beside them."""
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.quality import VARIANTS, describe_scenes, format_row, quality_scenes, run_variants
    from roreg_tpu_torch.weights import init_variables

    cfg = dataclasses.replace(
        quality_full_config(12), voxel_size=0.05, block_caps=(256, 128, 64, 32), num_keypoints=48,
        max_iter=32, backbone_compute_dtype=None)
    variables = init_variables(cfg, 0)
    groups = quality_scenes(cfg, scenes=1, clouds=2, points_per_cloud=1200, surface_extent=1.0)
    store: dict = {}
    described = describe_scenes(RegistrationPipeline(cfg, variables, device="cpu"), groups, store)
    assert described["clouds"] == len(store) == 4 and described["dropped_blocks"] == 0
    before = dict(store)
    results = run_variants(variables, cfg, groups, VARIANTS, [16, 8], store, "cpu", log=lambda m: None)
    assert all(store[k] is v for k, v in before.items()) and len(store) == 4
    assert list(results) == list(VARIANTS)
    for rows in results.values():
        assert list(rows) == [f"{s}@{k}" for k in (16, 8) for s in groups]
        for summary in rows.values():
            assert summary["pairs"] == 1 and 0.0 <= summary["ir"] <= 1.0 and summary["rr_predator"] is None
    ref = {"fmr": 1.0, "ir": 0.5, "rr_pointdsc": 1.0, "rre": 1.0, "rte": 0.01}
    line = format_row("rd_yohoc", "3dmatch_analog@16", results["rd_yohoc"]["3dmatch_analog@16"], {"cpu": ref})
    assert "(JAX cpu 0.500)" in line


def test_pose_sync_probe_flow():
    """The pose-sync probe at a tiny size on the CPU: 3 pairs from the
    shared store (no describe), pair 0 corrupted by 90 degrees and 1 m,
    which fails it whenever it had registered."""
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.quality import describe_scenes, pose_sync_probe, quality_scenes
    from roreg_tpu_torch.weights import init_variables

    cfg = dataclasses.replace(
        quality_full_config(12), voxel_size=0.05, block_caps=(256, 128, 64, 32), num_keypoints=48,
        max_iter=32, backbone_compute_dtype=None)
    variables = init_variables(cfg, 0)
    groups = quality_scenes(cfg, scenes=1, clouds=3, points_per_cloud=1200, surface_extent=1.0)
    store: dict = {}
    describe_scenes(RegistrationPipeline(cfg, variables, device="cpu"), {"hi": groups["3dmatch_analog"]}, store)
    scene = groups["3dmatch_analog"]["scene0"]
    before = dict(store)
    probe = pose_sync_probe(variables, cfg, scene, store, device="cpu")
    assert store == before
    assert set(probe) == {"pairs", "pair0_registered", "rr_raw", "rr_corrupted", "rr_corrupted_synced"}
    assert probe["pairs"] == 3
    assert probe["rr_corrupted"] == pytest.approx(probe["rr_raw"] - probe["pair0_registered"] / 3)
    assert 0.0 <= probe["rr_corrupted_synced"] <= 1.0
