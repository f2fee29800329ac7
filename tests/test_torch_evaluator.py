"""The port's Evaluator against the JAX package's, on the same stored
descriptors.

One 3-cloud synthetic scene, written to disk by ``make_synthetic_scene``
for the JAX evaluator and made in memory by ``synthetic_scene`` for the
port's from the same seed. Both descriptor stores hold the same
descriptors, a smooth function of each keypoint's position in cloud 0's
frame (so corresponding keypoints of two clouds look alike), and the same
RD scores; no backbone runs. The networks carry the committed quality
weights (G = 60). The chain is ``full_rd_rm_et_yohoo`` with ``max_iter``
>= ``keynum``, so every hypothesis is scored and the random permutation
only orders them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402

G, K, KEYNUM = 60, 96, 48
SMALL = dict(
    voxel_size=0.05, group_size=G, capacities=(512, 256, 128, 64), block_caps=(64, 32, 16, 8),
    conv1_kernel_size=5, group_chunk=6, num_keypoints=K, keynum=KEYNUM, max_iter=64, bs_gf=48,
    bs_et=48, backbone_compute_dtype=None, ransac_ird=0.5, eval_pair_batch=3,
    use_rd=True, use_rm=True, estimator="yohoo",
)
SCENE = dict(num_clouds=3, points_per_cloud=1500, num_keypoints=K, overlap=0.7,
             max_angle_deg=50.0, surface_extent=1.2)
METRIC_TOL = 1e-12  # means of the same per-pair numbers
ERR_TOL = 1e-4  # RRE (degrees) and RTE (metres) of f32 transforms


def _descriptors(scene, seed=0):
    """(bb, gf) (K, G, 32) per cloud: unit rows of sines of the keypoints'
    positions in cloud 0's frame."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(2, 3, G * 32)) * 3.0
    b = rng.uniform(0, 2 * np.pi, (2, G * 32))
    out = []
    for k, kp in enumerate(scene.keypoints):
        T = np.eye(4) if k == 0 else scene.gt[(0, k)]
        p = kp.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        feats = []
        for w, bias in zip(W, b):
            f = np.sin(p @ w + bias).reshape(K, G, 32)
            feats.append((f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32))
        out.append(feats)
    return out


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    from roreg_tpu.data.synthetic import make_synthetic_scene
    from roreg_tpu.eval.evaluator import Evaluator as JEvaluator
    from roreg_tpu.pipeline.config import PipelineConfig as JConfig
    from roreg_tpu.pipeline.registration import RegistrationPipeline as JPipe, rd_apply
    from roreg_tpu_torch.eval.evaluator import Evaluator
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

    tmp = tmp_path_factory.mktemp("evaluator")
    ds = make_synthetic_scene(str(tmp / "scene"), np.random.default_rng(3), **SCENE)
    ds.name = "scene"
    scene = synthetic_scene(np.random.default_rng(3), **SCENE, name="scene")
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.weights import QUALITY_FULL_DIR, load_checkpoint_dir

    variables = load_checkpoint_dir(QUALITY_FULL_DIR, quality_full_config())
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jcfg = JConfig(**SMALL)
    jpipe = JPipe(jcfg, jvars)
    jstore, store = {}, {}
    ones = jnp.ones(K, bool)
    for k, (bb, gf) in enumerate(_descriptors(scene)):
        det = rd_apply(jvars["rd"], jnp.asarray(gf), ones, jcfg)
        jstore[("scene", str(k))] = (jnp.asarray(bb), jnp.asarray(gf), det)
        store[("scene", str(k))] = tuple(torch.from_numpy(np.array(a)) for a in (bb, gf, det))
    ref = JEvaluator(jpipe, desc_store=jstore).run(
        {"scene": ds, "wholesetname": "synthetic"}, str(tmp / "out"), seed=5)
    pipe = RegistrationPipeline(PipelineConfig(**SMALL), variables, device="cpu")
    ev = Evaluator(pipe, desc_store=store)
    out = ev.run({"scene": scene, "wholesetname": "synthetic"}, seed=5)
    return ref, out, ev, scene


def test_evaluator_run_matches_jax(evaluated):
    ref, out, _, _ = evaluated
    assert out["pairs"] == ref["pairs"] == 3
    for k in ("fmr", "ir", "rr_pointdsc"):
        assert abs(out[k] - ref[k]) <= METRIC_TOL, k
    for k in ("rre", "rte"):
        assert abs(out[k] - ref[k]) <= ERR_TOL, k
    assert 0.0 < out["ir"] <= 1.0
    assert out["rr_predator"] is None and out["pairs_per_sec"] > 0


def test_evaluator_uses_the_store_and_keeps_the_pair_order(evaluated):
    """Stored descriptors are used as they are (no cloud is described
    again), and the pairs come in the order of the scene's gt."""
    _, _, ev, scene = evaluated
    before = dict(ev.desc_store)
    res = ev.process_scene(scene, seed=5)
    assert res["pairs"] == [(0, 1), (0, 2), (1, 2)]
    assert all(ev.desc_store[k] is v for k, v in before.items()) and len(ev.desc_store) == 3
    assert ev.dropped_blocks == {}
    again = ev.process_scene(scene, seed=5)
    assert np.array_equal(np.stack(res["transforms"]), np.stack(again["transforms"]))
