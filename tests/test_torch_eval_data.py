"""The port's data layer (PLY, the 3DMatch layout, synthetic scenes) and
the Predator RR protocol against the JAX package's.

Files are compared byte for byte, parsed arrays exactly, and the protocol's
numbers within ``PROTOCOL_TOL`` (the same float64 numpy + scipy arithmetic
on the same inputs)."""

import os

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data import dataset, ply  # noqa: E402
from roreg_tpu_torch.data.synthetic import make_synthetic_scene, synthetic_scene  # noqa: E402
from roreg_tpu_torch.eval import benchmark  # noqa: E402

PROTOCOL_TOL = 1e-12
GT_TOL = 1e-8  # gt.log keeps 9 decimals
SCENE = dict(points_per_cloud=1500, num_keypoints=64, overlap=0.7, max_angle_deg=50.0, surface_extent=1.2)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_ply_equals_jax(tmp_path):
    from roreg_tpu.data import ply as jply

    pts = np.random.default_rng(0).normal(size=(1000, 3))
    ply.write_ply(str(tmp_path / "a.ply"), pts)
    jply.write_ply(str(tmp_path / "b.ply"), pts)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    got, ref = ply.read_ply(str(tmp_path / "a.ply")), jply.read_ply(str(tmp_path / "a.ply"))
    assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)
    (tmp_path / "c.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\n"
        "property float z\nend_header\n1 2 3\n4 5 6\n")
    assert np.array_equal(ply.read_ply(str(tmp_path / "c.ply")), jply.read_ply(str(tmp_path / "c.ply")))


@pytest.mark.parametrize("num_clouds", [2, 5])
def test_make_synthetic_scene_writes_the_files_of_jax(tmp_path, num_clouds):
    """Byte-equal files from the same seed, the same dataset read back, and
    both generators left at the same point of their stream."""
    from roreg_tpu.data.synthetic import make_synthetic_scene as jmake

    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    ds = make_synthetic_scene(str(tmp_path / "port" / "s"), rng, num_clouds=num_clouds, **SCENE)
    jds = jmake(str(tmp_path / "jax" / "s"), jrng, num_clouds=num_clouds, **SCENE)
    files, jfiles = _tree(tmp_path / "port" / "s"), _tree(tmp_path / "jax" / "s")
    assert len(files) == 2 * num_clouds + 2 and files == jfiles
    assert rng.random() == jrng.random()
    assert ds.name == jds.name == "synthetic/s"
    assert ds.pc_ids == jds.pc_ids and ds.pair_ids == jds.pair_ids
    for k in ds.pc_ids:
        assert np.array_equal(ds.get_pc(k), jds.get_pc(k)) and np.array_equal(ds.get_kps(k), jds.get_kps(k))
    for p in ds.pair_ids:
        assert np.array_equal(ds.get_transform(*p), jds.get_transform(*p))


def test_in_memory_scene_reads_as_the_written_one(tmp_path):
    """``synthetic_scene`` through the dataset interface gives what
    ``make_synthetic_scene``'s files hold, gt.info matrices included."""
    ds = make_synthetic_scene(str(tmp_path / "s"), np.random.default_rng(2), num_clouds=4, **SCENE)
    scene = synthetic_scene(np.random.default_rng(2), num_clouds=4, **SCENE, name=ds.name)
    assert scene.pc_ids == ds.pc_ids and scene.pair_ids == ds.pair_ids
    for k in ds.pc_ids:
        assert np.array_equal(scene.get_pc(k), ds.get_pc(k).astype(np.float32))
        assert np.array_equal(scene.get_kps(k), ds.get_kps(k).astype(np.float32))
    mine, files = scene.predator_gt(), ds.predator_gt()
    assert mine["n_fragments"] == files["n_fragments"] == 4
    assert np.array_equal(mine["gt_pairs"].astype(str), files["gt_pairs"])
    assert np.abs(mine["gt_traj"] - files["gt_traj"]).max() <= GT_TOL
    assert np.array_equal(mine["gt_cov"], files["gt_cov"])


def test_parse_gt_log_and_get_kps_equal_jax(tmp_path):
    from roreg_tpu.data import dataset as jdataset

    ds = make_synthetic_scene(str(tmp_path / "s"), np.random.default_rng(1), num_clouds=3, **SCENE)
    got, ref = dataset.parse_gt_log(ds.gt_log), jdataset.parse_gt_log(ds.gt_log)
    assert list(got) == list(ref) == [("0", "1"), ("0", "2"), ("1", "2")]
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    # a missing keypoint file: a random subset from numpy's global stream, persisted
    os.remove(ds.kps_path(1))
    np.random.seed(11)
    kp = dataset.ThreeDMatchDataset(ds.root, 3, num_keypoints=20).get_kps(1)
    ids = np.loadtxt(ds.kps_path(1)).astype(np.int64)
    os.remove(ds.kps_path(1))
    np.random.seed(11)
    jkp = jdataset.ThreeDMatchDataset(ds.root, 3, num_keypoints=20).get_kps(1)
    assert kp.shape == (20, 3) and np.array_equal(kp, jkp)
    assert np.array_equal(ids, np.loadtxt(ds.kps_path(1)).astype(np.int64))


@pytest.mark.parametrize("name", ["demo", "3dmatch", "3dLomatch", "ETH", "WHU-TLS", "3dmatch_train"])
def test_get_dataset_group_equals_jax(name, monkeypatch):
    """The same scenes, roots, gt files and station counts; no file is read
    (the constructors only record their arguments)."""
    from roreg_tpu.data import dataset as jdataset

    assert dataset.SCENE_LISTS == jdataset.SCENE_LISTS
    assert dataset.TRAIN_VAL_SCENES == jdataset.TRAIN_VAL_SCENES
    made = {}
    for mod in (dataset, jdataset):
        made[mod] = []
        monkeypatch.setattr(mod.ThreeDMatchDataset, "__post_init__",
                            lambda self, _m=made[mod]: _m.append((self.root, self.station_num, self.gt_log)))
        group = mod.get_dataset_group(name, "origin_data")
        made[mod].append({k: v if isinstance(v, (str, list)) else v.name for k, v in group.items()})
    assert made[dataset] == made[jdataset] and len(made[dataset]) > 1
    with pytest.raises(NotImplementedError):
        dataset.get_dataset_group("nope", "origin_data")


def _perturbed(ds, rng, scale):
    pairs, gt = benchmark.read_trajectory(ds.gt_log)
    est = gt.copy()
    for T in est:
        a = rng.normal(size=3) * scale
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        T[:3, :3] = (np.eye(3) + K) @ T[:3, :3]
        T[:3, 3] += rng.normal(size=3) * scale
    est_pairs = np.asarray([[int(p[0]), int(p[1])] for p in pairs])
    return est_pairs, est.astype(np.float32)


def test_predator_protocol_equals_jax(tmp_path):
    """``evaluate_registration``, ``benchmark_scenes`` (with its per-scene
    file) and ``write_trajectory`` on 5-cloud scenes with perturbed
    transforms, some pairs past the RMSE threshold."""
    from roreg_tpu.eval import benchmark as jbench

    rng = np.random.default_rng(0)
    results, jres = {}, {}
    for s in range(2):
        ds = make_synthetic_scene(str(tmp_path / f"s{s}"), np.random.default_rng(10 + s), num_clouds=5, **SCENE)
        est_pairs, est = _perturbed(ds, rng, 0.15)
        args = (ds.gt_log,)
        gt_pairs, gt = benchmark.read_trajectory(*args)
        jgt_pairs, jgt = jbench.read_trajectory(*args)
        assert np.array_equal(gt_pairs, jgt_pairs) and np.array_equal(gt, jgt)
        n, cov = benchmark.read_trajectory_info(ds.gt_info)
        jn, jcov = jbench.read_trajectory_info(ds.gt_info)
        assert n == jn == 5 and np.array_equal(cov, jcov)
        got = benchmark.evaluate_registration(n, est, est_pairs, gt_pairs, gt, cov)
        ref = jbench.evaluate_registration(n, est, est_pairs, gt_pairs, gt, cov)
        assert got[2] == ref[2] and 0 < ref[1] < 1  # flags; some pairs fail
        assert np.abs(np.subtract(got[:2], ref[:2])).max() <= PROTOCOL_TOL
        assert np.abs(np.subtract(got[3], ref[3])).max() <= PROTOCOL_TOL
        for t in (np.eye(4), est[0].astype(np.float64)):
            assert abs(benchmark.compute_transformation_error(t, cov[0])
                       - jbench.compute_transformation_error(t, cov[0])) <= PROTOCOL_TOL
        results[f"s{s}"] = dict(gt_log=ds.gt_log, gt_info=ds.gt_info, est_pairs=est_pairs, est_traj=est)
        benchmark.write_trajectory(est_pairs, est, str(tmp_path / f"pre{s}.log"), 5)
        jbench.write_trajectory(est_pairs, est, str(tmp_path / f"jpre{s}.log"), 5)
        assert (tmp_path / f"pre{s}.log").read_bytes() == (tmp_path / f"jpre{s}.log").read_bytes()
    for nonconsecutive in (True, False):
        rr, per = benchmark.benchmark_scenes(results, 0.2, nonconsecutive, str(tmp_path / "rr.txt"))
        jrr, jper = jbench.benchmark_scenes(results, 0.2, nonconsecutive, str(tmp_path / "jrr.txt"))
        assert abs(rr - jrr) <= PROTOCOL_TOL and 0 < jrr < 1
        assert per.keys() == jper.keys()
        for k in per:
            assert all(abs(per[k][m] - jper[k][m]) <= PROTOCOL_TOL for m in per[k])
        assert (tmp_path / "rr.txt").read_bytes() == (tmp_path / "jrr.txt").read_bytes()


def test_scene_without_a_pair_to_count(tmp_path):
    """A 2-cloud scene has no non-consecutive pair: the reference divides by
    zero; the port gives no recall and leaves the scene out of the mean."""
    from roreg_tpu.eval import benchmark as jbench

    two = make_synthetic_scene(str(tmp_path / "two"), np.random.default_rng(0), num_clouds=2, **SCENE)
    five = make_synthetic_scene(str(tmp_path / "five"), np.random.default_rng(1), num_clouds=5, **SCENE)
    res = {}
    for name, ds in (("two", two), ("five", five)):
        pairs, gt = benchmark.read_trajectory(ds.gt_log)
        res[name] = dict(gt_log=ds.gt_log, gt_info=ds.gt_info,
                         est_pairs=np.asarray([[int(p[0]), int(p[1])] for p in pairs]), est_traj=gt)
    with pytest.raises(ZeroDivisionError):
        jbench.benchmark_scenes({"two": res["two"]})
    rr, per = benchmark.benchmark_scenes({"two": res["two"]})
    assert rr is None and per == {}
    rr, per = benchmark.benchmark_scenes(res)
    assert rr == jbench.benchmark_scenes({"five": res["five"]})[0] == 1.0 and list(per) == ["five"]


def test_draw_registration(tmp_path):
    pytest.importorskip("matplotlib")
    from roreg_tpu_torch.data.visualize import draw_registration_with_keys

    src = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    T = np.eye(4)
    T[:3, 3] = [0.1, 0, 0]
    out = str(tmp_path / "reg.png")
    assert draw_registration_with_keys(src, src @ T[:3, :3].T + T[:3, 3], src[:20], T, out) == out
    assert os.path.getsize(out) > 10000
