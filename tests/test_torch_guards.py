"""Guards on the port: it imports no JAX, runs on CUDA unless told
otherwise, and refuses the options it has not ported."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.weights import init_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "roreg_tpu"}


def _port_sources():
    root = os.path.join(REPO, "roreg_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_imports_in_port():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {
        "roreg_tpu_torch/kernels/block_gather.py", "roreg_tpu_torch/kernels/halo_conv.py",
        "roreg_tpu_torch/sparse/block.py", "roreg_tpu_torch/native/blockpyr.py",
        "roreg_tpu_torch/pipeline/extractor.py", "roreg_tpu_torch/kernels/up_conv.py",
        "roreg_tpu_torch/kernels/cell_dense.py", "roreg_tpu_torch/kernels/skip_concat.py",
        "roreg_tpu_torch/models/rm.py", "roreg_tpu_torch/eval/evaluator.py",
        "roreg_tpu_torch/quality.py", "roreg_tpu_torch/weights.py", "chip_smoke.py",
    } <= scanned
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'roreg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, roreg_tpu_torch\n"
        "for m in pkgutil.walk_packages(roreg_tpu_torch.__path__, 'roreg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


SMALL = dict(group_size=12, capacities=(512, 256, 128, 64), conv1_kernel_size=3,
             engine="gather", use_rm=False)


def test_entry_point_needs_cuda_unless_cpu(monkeypatch):
    cfg = PipelineConfig(**SMALL)
    v = init_variables(cfg, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RegistrationPipeline(cfg, v)
    pipe = RegistrationPipeline(cfg, v, device="cpu")
    assert pipe.device.type == "cpu"


@pytest.mark.parametrize(
    "change,item",
    [({"host_maps": False}, "A9"), ({"backbone_variant": "ResUNetIN2C"}, "A8")],
)
def test_unported_options_raise(change, item):
    cfg = PipelineConfig(**{**SMALL, **change})
    with pytest.raises(NotImplementedError, match=item):
        RegistrationPipeline(cfg, {}, device="cpu")


def test_yohoc_is_accepted():
    """The yohoc estimator is ported: a pipeline builds with it, and an
    unknown estimator is still refused."""
    from roreg_tpu_torch.pipeline.config import check_supported

    cfg = PipelineConfig(**{**SMALL, "estimator": "yohoc"})
    check_supported(cfg)
    assert RegistrationPipeline(cfg, init_variables(cfg, 0), device="cpu").cfg.estimator == "yohoc"
    with pytest.raises(ValueError, match="unknown estimator"):
        check_supported(PipelineConfig(**{**SMALL, "estimator": "ransac"}))


def test_default_config_is_supported():
    """The JAX package's default chain is ported: ``PipelineConfig()`` with
    no argument builds a pipeline on the block engine with the RM matcher."""
    from roreg_tpu_torch.models.rm import RotationCoherenceMatcher
    from roreg_tpu_torch.pipeline.config import check_supported
    from roreg_tpu_torch.sparse.block import BlockResUNet

    cfg = PipelineConfig()
    assert cfg.engine == "block" and cfg.use_rm
    check_supported(cfg)
    pipe = RegistrationPipeline(cfg, init_variables(cfg, 0), device="cpu")
    assert isinstance(pipe.nets["backbone"], BlockResUNet)
    assert isinstance(pipe.nets["rm"], RotationCoherenceMatcher)
    assert pipe.nets["rm"].layer0.cross_s2t.row_block is None  # keynum 1000 <= 1536
    with pytest.raises(ValueError, match="unknown engine"):
        check_supported(PipelineConfig(engine="dense"))


def test_rm_row_block_follows_keynum():
    """RM's kNN row block: the config's value, else 512 rows above keynum
    1536 (the JAX package's pair stage), else none."""
    from roreg_tpu_torch.pipeline.config import rm_row_block

    assert rm_row_block(PipelineConfig()) is None
    assert rm_row_block(PipelineConfig(keynum=2048)) == 512
    assert rm_row_block(PipelineConfig(keynum=2048, rm_row_block=128)) == 128


def test_conv_window_is_accepted_and_ignored():
    """conv_window was a TPU locality workaround; it changes nothing here."""
    base = PipelineConfig(**{**SMALL, "backbone_compute_dtype": None})
    v = init_variables(base, 0)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 0.6, size=(600, 3)).astype(np.float32)
    keys = pts[:20]
    a = RegistrationPipeline(base, v, device="cpu").extract(pts, None, keys)
    b = RegistrationPipeline(PipelineConfig(**{**SMALL, "backbone_compute_dtype": None, "conv_window": 1024}),
                             v, device="cpu").extract(pts, None, keys)
    assert torch.equal(a, b) and a.shape == (20, 12, 32)


def test_config_copies_jax_fields_and_defaults():
    import dataclasses

    from roreg_tpu.pipeline.config import PipelineConfig as JConfig

    port = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert port == ref
