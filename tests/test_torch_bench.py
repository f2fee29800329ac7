"""The port's bench and its per-cloud tail.

``describe_tail`` against the JAX package's on the same backbone features
(G = 12, random weights converted between the packages); then the bench's
body (``run_bench``) on the CPU at 3 clouds of 1500 points, keynum 48, with
G = 12 heads in place of the trained G = 60 ones, and its handling of a
host build that raises on the builder thread."""

import dataclasses
import json
import threading

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch import bench  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.weights import flatten_variables, init_variables  # noqa: E402

G, K = 12, 200
# capacities that overflow, so that the fallback rebuild runs (and drops
# blocks: the run is about the bench's flow, not its numbers)
SMALL = dict(voxel_size=0.05, group_size=G, block_caps=(32, 16, 8, 4), block_caps_fallback=(64, 32, 16, 8),
             conv1_kernel_size=5, group_chunk=4, num_keypoints=96, keynum=48, max_iter=64, bs_gf=48, bs_et=48,
             ransac_ird=0.5, backbone_compute_dtype=None)
FEAT_TOL = 1e-5  # GF in f32 on both sides
# bench.py's result keys; the port reports warm-up seconds where the JAX
# bench reports its compile seconds, and adds the fallback and drop counts
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"n_clouds", "n_pairs", "timing", "elapsed_s", "describe_s", "pair_stage_s", "device_only",
               "warmup_s", "keynum", "max_iter", "trained_heads", "device", "fallback_clouds", "dropped_blocks"}
DEVICE_ONLY_KEYS = {"pairs_per_sec", "elapsed_s", "describe_s", "pair_stage_s", "timing"}


@pytest.mark.parametrize("use_rd", [True, False])
def test_describe_tail_equals_jax(use_rd):
    import jax
    import jax.numpy as jnp

    from roreg_tpu.pipeline.config import PipelineConfig as JConfig
    from roreg_tpu.pipeline.registration import describe_tail as jtail
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

    kw = dict(group_size=G, num_keypoints=K, keynum=48, bs_gf=64, use_rd=use_rd, use_rm=False)
    cfg = PipelineConfig(**kw)
    variables = init_variables(cfg, 1)
    rng = np.random.default_rng(0)
    bb = rng.normal(size=(K, G, 32)).astype(np.float32)
    bb /= np.linalg.norm(bb, axis=-1, keepdims=True)
    kp = rng.uniform(0, 2, (K, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jtail(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(bb), jnp.asarray(kp), key, JConfig(**kw))
    noise = None if use_rd else np.array(jax.random.uniform(key, (K,)))
    pipe = RegistrationPipeline(cfg, variables, device="cpu")
    got = pipe.describe_tail(torch.from_numpy(bb), kp, noise=noise)
    bb_s, gf_s, kp_s = (np.asarray(x) for x in ref)
    assert np.array_equal(got[0].numpy(), bb_s) and np.array_equal(got[2].numpy(), kp_s)
    assert np.abs(got[1].numpy() - gf_s).max() <= FEAT_TOL


@pytest.fixture
def small_bench(monkeypatch, tmp_path):
    """The bench at ``SMALL``, its heads read from a G = 12 set."""
    cfg = dataclasses.replace(bench.bench_config(), **SMALL)
    v = init_variables(cfg, 5)
    for comp in bench.HEADS:
        np.savez(tmp_path / f"{comp}.npz", **flatten_variables(v[comp]))
    monkeypatch.setattr(bench, "QUALITY_FULL_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "bench_config", lambda: cfg)
    return cfg


def test_bench_prints_the_line_of_bench_py(small_bench, monkeypatch, capsys):
    real = bench.run_bench
    runs = []

    def small_run(cfg, device=None):
        runs.append(real(cfg, 3, 1500, device))
        return runs[-1]

    monkeypatch.setattr(bench, "run_bench", small_run)
    assert bench.main(["--device", "cpu"]) == 0
    result, transforms = runs[0]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(result) == RESULT_KEYS and DETAIL_KEYS <= set(result["detail"])
    d = result["detail"]
    assert set(d["device_only"]) == DEVICE_ONLY_KEYS
    assert result["metric"] == "registered_pairs_per_sec_per_chip" and result["unit"] == "pairs/s"
    assert result["value"] == 3 / d["elapsed_s"] and result["vs_baseline"] == result["value"] / 0.73
    assert (d["n_clouds"], d["n_pairs"], d["keynum"], d["describes"]) == (3, 3, 48, 6)
    assert d["trained_heads"] == ["gf", "rd", "rm", "et"] and d["device"] == {"name": "cpu"}
    assert d["describe_s"] + d["pair_stage_s"] == pytest.approx(d["elapsed_s"])
    assert d["fallback_clouds"] == [0, 1, 2] and d["dropped_blocks"] > 0
    for T in transforms.values():
        assert T.shape == (3, 4, 4) and bool(torch.isfinite(T).all())


class _Fault(RuntimeError):
    pass


def test_a_failing_host_build_ends_the_bench(small_bench, monkeypatch):
    """A build that raises on the builder thread ends the end-to-end phase
    with that exception, within a time limit of its own, and leaves no
    builder thread behind."""
    real = bench.build_cloud_payloads
    callers = []

    def failing(*a, **k):  # the untimed builds pass; the builder thread's first build raises
        callers.append(threading.current_thread().name)
        if callers[-1] == "bench-builder":
            raise _Fault("host build failed")
        return real(*a, **k)

    monkeypatch.setattr(bench, "build_cloud_payloads", failing)
    caught = []

    def run():
        try:
            bench.run_bench(small_bench, 2, 1500, "cpu")
        except BaseException as e:  # noqa: BLE001 - the test inspects it
            caught.append(e)

    th = threading.Thread(target=run, name="bench-run", daemon=True)
    th.start()
    th.join(300)
    assert not th.is_alive(), "the bench hung on a failing build"
    assert len(caught) == 1 and isinstance(caught[0], _Fault)
    assert callers == ["bench-run", "bench-run", "bench-builder"]
    assert not any(t.name == "bench-builder" for t in threading.enumerate())


def test_heads_must_load(small_bench, tmp_path):
    """A missing trained head fails the bench instead of running random."""
    (tmp_path / "rm.npz").unlink()
    with pytest.raises(FileNotFoundError, match="rm"):
        bench.run_bench(small_bench, 2, 1500, "cpu")
