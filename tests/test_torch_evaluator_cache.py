"""The evaluator's npz descriptor cache in the JAX package's layout
(``<cache_dir>/<scene name with / as _>/<id>.npz``, keys ``bb``, ``gf``,
``det``): a cache written by the JAX package's evaluator is read by the
port's without a describe, and the reverse. Arrays round-trip exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from roreg_tpu_torch.eval.evaluator import Evaluator, cache_path  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.weights import init_variables  # noqa: E402

G, K = 12, 64
CFG = dict(voxel_size=0.05, group_size=G, block_caps=(256, 128, 64, 32), conv1_kernel_size=5, group_chunk=4,
           num_keypoints=K, keynum=32, bs_gf=64, use_rm=False)
SCENE = dict(num_clouds=2, points_per_cloud=1500, num_keypoints=K, surface_extent=1.2)


class _JaxStub:
    """What the JAX evaluator asks of a pipeline when it describes a cloud,
    answering with fixed arrays; ``calls`` counts the describes."""

    def __init__(self, arrays):
        self.variables = {}
        self.arrays = arrays
        self.calls = 0

    def describe(self, pc, mask, kp):
        self.calls += 1
        bb, gf, _ = self.arrays[self.calls - 1]
        return jnp.asarray(bb), jnp.asarray(gf)

    def detect(self, gf, mask):
        return jnp.asarray(self.arrays[self.calls - 1][2])


def _scene(tmp_path):
    ds = make_synthetic_scene(str(tmp_path / "scene"), np.random.default_rng(0), **SCENE)
    assert ds.name == "synthetic/scene"
    return ds


def _port(no_describe, monkeypatch):
    cfg = PipelineConfig(**CFG)
    pipe = RegistrationPipeline(cfg, init_variables(cfg, 0), device="cpu")
    if no_describe:
        monkeypatch.setattr(pipe, "extract", lambda *a, **k: pytest.fail("the port described a cached cloud"))
    return pipe


def test_port_reads_the_cache_of_jax(tmp_path, monkeypatch):
    from roreg_tpu.eval.evaluator import Evaluator as JEvaluator

    ds = _scene(tmp_path)
    rng = np.random.default_rng(1)
    arrays = [(rng.normal(size=(K, G, 32)).astype(np.float32), rng.normal(size=(K, G, 32)).astype(np.float32),
               rng.random(K).astype(np.float32)) for _ in range(2)]
    stub = _JaxStub(arrays)
    jev = JEvaluator(stub, cache_dir=str(tmp_path / "cache"))
    for pc_id in ds.pc_ids:
        jev.describe_cloud(ds, pc_id)
    assert stub.calls == 2
    ev = Evaluator(_port(True, monkeypatch), cache_dir=str(tmp_path / "cache"))
    for k, pc_id in enumerate(ds.pc_ids):
        assert (tmp_path / "cache" / "synthetic_scene" / f"{pc_id}.npz").exists()
        got = ev.describe_cloud(ds, pc_id)
        for g, a in zip(got, arrays[k]):
            assert g.dtype == torch.float32 and np.array_equal(g.numpy(), a)


def test_jax_reads_the_cache_of_the_port(tmp_path, monkeypatch):
    from roreg_tpu.eval.evaluator import Evaluator as JEvaluator

    ds = _scene(tmp_path)
    ev = Evaluator(_port(False, monkeypatch), cache_dir=str(tmp_path / "cache"))
    mine = [ev.describe_cloud(ds, pc_id) for pc_id in ds.pc_ids]
    assert ev.timer.counts["describe"] == 2
    stub = _JaxStub([])
    jev = JEvaluator(stub, cache_dir=str(tmp_path / "cache"))
    for pc_id, arrays in zip(ds.pc_ids, mine):
        with np.load(cache_path(str(tmp_path / "cache"), ds.name, pc_id)) as z:
            assert sorted(z.files) == ["bb", "det", "gf"]
        got = jev.describe_cloud(ds, pc_id)
        assert [a.shape for a in arrays] == [(K, G, 32), (K, G, 32), (K,)]
        for g, a in zip(got, arrays):
            assert np.array_equal(np.asarray(g), a.numpy())
    assert stub.calls == 0
    again = Evaluator(_port(True, monkeypatch), cache_dir=str(tmp_path / "cache"))
    assert all(torch.equal(a, b) for a, b in zip(again.describe_cloud(ds, "1"), mine[1]))
