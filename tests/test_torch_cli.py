"""The port's CLIs (``cli.demo``, ``cli.testset``, ``cli.test``) against
the JAX package's: the parser defaults and testset presets, and the demo ->
testset -> test chain through ``main(argv)`` on the CPU.

The chain runs at a small configuration: each CLI's ``PipelineConfig`` is
replaced by one that applies ``SMALL`` over the CLI's own arguments (G = 12,
small capacities), and the scenes are written beforehand at 1500 points a
cloud, so no CLI runs at full width here."""

import json
import os

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.cli import demo, test as cli_test, testset  # noqa: E402
from roreg_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402

SMALL = dict(
    voxel_size=0.05, group_size=12, block_caps=(256, 128, 64, 32), conv1_kernel_size=5, group_chunk=4,
    num_keypoints=96, keynum=48, max_iter=64, bs_gf=48, bs_et=48, ransac_ird=0.5, backbone_compute_dtype=None,
)
SCENE = dict(points_per_cloud=1500, num_keypoints=96, overlap=0.7, max_angle_deg=50.0, surface_extent=1.2)


@pytest.mark.parametrize("argv", [[], ["--testset", "ETH"], ["--testset", "WHU-TLS"],
                                  ["--testset", "3dmatch", "--tau_2", "0.3"],
                                  ["--testset", "ETH", "--voxel_size", "0.3", "--RD", "--ET", "yohoc"]])
def test_parser_and_presets_equal_jax(argv):
    from roreg_tpu.cli import test as jtest

    mine = vars(cli_test.apply_testset_presets(cli_test.get_parser().parse_args(argv)))
    ref = vars(jtest.apply_testset_presets(jtest.get_parser().parse_args(argv)))
    assert mine.pop("device") is None
    assert mine == ref


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """Every CLI on the small configuration, the demo and synthetic scenes
    written small."""
    for mod in (demo, testset, cli_test):
        monkeypatch.setattr(mod, "PipelineConfig", lambda **kw: PipelineConfig(**{**kw, **SMALL}))
    data = tmp_path / "data"
    make_synthetic_scene(str(data / "demo" / "kitchen"), np.random.default_rng(0), num_clouds=2, **SCENE)
    make_synthetic_scene(str(data / "synthetic" / "scene0"), np.random.default_rng(1), num_clouds=4, **SCENE)
    return data, tmp_path / "out"


def test_demo_testset_test_chain(small_cli, monkeypatch, capsys):
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

    data, out = small_cli
    common = ["--random_init", "--device", "cpu"]
    res = demo.main(["--data_root", str(data)] + common)
    assert set(res) == {"rre_deg", "rte_m", "success"} and np.isfinite(res["rre_deg"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res

    assert testset.main(["--dataset", "demo", "--origin_data_dir", str(data), "--outdir", str(out)] + common) == 2
    for k in (0, 1):
        with np.load(out / "desc_cache" / "demo_kitchen" / f"{k}.npz") as z:
            assert sorted(z.files) == ["bb", "det", "gf"] and z["bb"].shape == (96, 12, 32)

    def no_describe(*a, **k):
        raise AssertionError("cli.test described a cloud that the cache holds")

    with monkeypatch.context() as m:
        m.setattr(RegistrationPipeline, "extract", no_describe)
        summary = cli_test.main(["--testset", "demo", "--origin_data_dir", str(data),
                                 "--output_dir", str(out)] + common)
    assert summary["pairs"] == 1 and summary["rr_predator"] is None  # 2 clouds: no non-consecutive pair
    assert (out / "demo_kitchen" / "pre.log").exists()
    log = (out / "results.log").read_text().splitlines()
    assert log[0] == "demo-RD:False-RM:False-yohoo-48keys-64iters" and "rr_predator: None" in log

    summary = cli_test.main(["--testset", "synthetic", "--origin_data_dir", str(data),
                             "--output_dir", str(out)] + common)
    assert summary["pairs"] == 6 and isinstance(summary["rr_predator"], float)
    assert os.path.exists(out / "desc_cache" / "synthetic_scene0" / "3.npz")
    assert (out / "results.log").read_text().count("iters\n") == 2


def test_checkpoint_dir_loads_present_components(small_cli, tmp_path, capsys):
    """``--checkpoint_dir``: each ``<comp>.npz`` present is loaded, the
    others keep the seeded init; a set of other shapes is refused."""
    from roreg_tpu_torch.weights import export_variables, flatten_variables, init_variables

    cfg = PipelineConfig(**SMALL)
    ck = tmp_path / "ck"
    ck.mkdir()
    other = init_variables(cfg, 7)
    np.savez(ck / "gf.npz", **flatten_variables(other["gf"]))
    args = cli_test.apply_testset_presets(cli_test.get_parser().parse_args(
        ["--checkpoint_dir", str(ck), "--device", "cpu"]))
    pipe = cli_test.load_pipeline(args)
    assert "loaded gf from" in capsys.readouterr().out
    got = flatten_variables(export_variables(pipe.nets["gf"]))
    assert all(np.array_equal(got[k], v) for k, v in flatten_variables(other["gf"]).items())
    seeded = flatten_variables(init_variables(cfg, 0)["rd"])
    got = flatten_variables(export_variables(pipe.nets["rd"]))
    assert all(np.array_equal(got[k], v) for k, v in seeded.items())
    wrong = init_variables(PipelineConfig(**{**SMALL, "group_size": 24}), 0)
    np.savez(ck / "et.npz", **flatten_variables(wrong["et"]))
    with pytest.raises(ValueError, match="shapes differ"):
        cli_test.load_pipeline(args)
