"""The port's training CLI (``cli.train``) and trainset CLI
(``cli.trainset``) on the CPU at a small configuration.

``cli.train``'s ``PipelineConfig`` is replaced by one that applies
``SMALL`` over the CLI's arguments (G = 12), its training scenes are 3
clouds of 2000 points with 400 keypoints, RM's batches are cut to 320 rows
(the CLI's 1024-row capacity backpropagates through 100 Sinkhorn
iterations, work for the card), and the backbone describe is stubbed by a
fixed function of each keypoint's position (the describe has its own tests
against the JAX package, and the card's smoke phase 10 runs it under
training). Nothing here runs at full width."""

import json

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.cli import train as cli_train, trainset as cli_trainset  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.train import data as D  # noqa: E402

G = 12
SMALL = dict(
    voxel_size=0.05, group_size=G, block_caps=(256, 128, 64, 32), conv1_kernel_size=5, group_chunk=4,
    keynum=48, max_iter=64, bs_gf=48, bs_et=48, ransac_ird=0.5, backbone_compute_dtype=None,
)
SCENE = dict(num_clouds=3, points_per_cloud=2000, num_keypoints=400, overlap=0.7, max_angle_deg=50.0,
             surface_extent=1.2)


def test_parser_equals_jax():
    from roreg_tpu.cli import train as jtrain

    mine = vars(cli_train.get_parser().parse_args(["--component", "GF"]))
    ref = vars(jtrain.get_parser().parse_args(["--component", "GF"]))
    assert mine.pop("device") is None
    assert mine == ref


@pytest.mark.parametrize("argv,item", [(["--component", "backbone", "--n_devices", "2"], "A7"),
                                       (["--component", "GF", "--n_devices", "2"], "A7")])
def test_not_ported_options_raise(argv, item, tmp_path):
    """``--n_devices 2`` (ROADMAP item ``item``, now ported) outside a world
    of 2: a head's data-parallel training needs ``torchrun
    --nproc_per_node 2`` and raises naming it before anything is built;
    the backbone trains in one process, as in the reference, and raises."""
    match = "one process" if "backbone" in argv else "torchrun --nproc_per_node 2"
    with pytest.raises(ValueError, match=match):
        cli_train.main(argv + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "ckpt"),
                               "--data_root", str(tmp_path / "data")])
    assert item == "A7" and not (tmp_path / "data").exists()


@pytest.fixture
def small_train(monkeypatch, tmp_path):
    small = lambda **kw: PipelineConfig(**{**kw, **SMALL})  # noqa: E731
    monkeypatch.setattr(cli_train, "PipelineConfig", small)
    monkeypatch.setattr(cli_train, "SCENE", SCENE)
    real_rm = D.rm_batches
    monkeypatch.setattr(cli_train, "rm_batches", lambda *a, **k: real_rm(*a, **{**k, "capacity": 320,
                                                                                "max_ps": 300}))
    monkeypatch.setattr(cli_trainset, "rm_batches", cli_train.rm_batches)
    proj = np.random.default_rng(0).normal(size=(3, G * 32)) * 3.0

    def extract(self, points, point_mask, keypoints, timings=None, dropped=None):
        f = np.sin(np.asarray(keypoints, np.float64) @ proj).reshape(-1, G, 32)
        return torch.from_numpy(f.astype(np.float32)).to(self.device)

    monkeypatch.setattr(RegistrationPipeline, "extract", extract)
    return ["--device", "cpu", "--group_size", str(G), "--synthetic_scenes", "1",
            "--data_root", str(tmp_path / "data"), "--checkpoint_dir", str(tmp_path / "ckpt")], tmp_path


def test_train_cli_dispatch(small_train, capsys):
    """Each component trains 2 steps from its own data path (the feature
    cache for GF and ET, the descriptors for RM, the self-run bank for RD),
    validates at step 2, writes ``model_best`` in the pipeline's layout, and
    the next component's pipeline loads the checkpoints already there."""
    from roreg_tpu_torch.train.checkpoints import load_pipeline_variables
    from roreg_tpu_torch.weights import init_variables

    common, tmp = small_train
    for comp in ("GF", "ET", "RM", "RD"):
        res = cli_train.main(["--component", comp, "--steps", "2", "--val_interval", "2", "--val_batches", "1"]
                             + common)
        assert res["final_step"] == 2 and np.isfinite(res["best"]), comp
        assert (tmp / "ckpt" / comp / "model_best" / f"{comp.lower()}.npz").exists()
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["final_step"] == "2"
    cfg = PipelineConfig(**SMALL)
    variables = init_variables(cfg, 0)
    assert sorted(load_pipeline_variables(str(tmp / "ckpt"), variables, cfg)) == ["et", "gf", "rd", "rm"]


def test_trainset_cli_writes_batches(small_train):
    common, tmp = small_train
    out = cli_trainset.main(["--component", "RM", "--num_batches", "2", "--out_dir", str(tmp / "ts")] + common)
    assert out["batches"] == 2
    with np.load(tmp / "ts" / "rm" / "1.npz") as z:
        assert z["feats0"].shape == (1, 320, G, 32) and z["pair_mask"].any()
