"""The ported slice end to end: register_pair against the JAX package.

Both pipelines run the gather engine over host maps with the mutual-NN
matcher (``use_rm=False``) and yohoo, at a small size in f32, with the
same variables (JAX init, converted) and the reference's random draws fed
to the port as numpy. Keypoint samples are set-equal, matches and group
indices equal, the winning hypothesis the same, the transform within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.core.group import get_group as jax_group  # noqa: E402
from roreg_tpu.pipeline import estimator as jest  # noqa: E402
from roreg_tpu.pipeline.config import PipelineConfig as JConfig  # noqa: E402
from roreg_tpu.pipeline.registration import RegistrationPipeline as JPipe  # noqa: E402
from roreg_tpu.pipeline.registration import et_apply as jet_apply  # noqa: E402
from roreg_tpu_torch.data.synthetic import synthetic_pair  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402

SMALL = dict(
    voxel_size=0.05, group_size=12, capacities=(2048, 1024, 512, 256),
    conv1_kernel_size=3, group_chunk=4, num_keypoints=128, keynum=64,
    max_iter=48, bs_gf=48, bs_et=48, engine="gather", host_maps=True,
    use_rm=False, backbone_compute_dtype=None,
    # With random weights the winning hypothesis at the default 0.1 keeps
    # two inliers, where the weighted Kabsch refit is rank-deficient and its
    # rotation not unique (the frameworks' SVDs then pick different ones).
    # At 0.5 the refits see several inliers and the transform is determined.
    ransac_ird=0.5,
)
TOL = 1e-4


@pytest.fixture(scope="module")
def run():
    jcfg = JConfig(**SMALL)
    jpipe = JPipe(jcfg, {})
    jvars = jpipe.init_variables(jax.random.PRNGKey(0))
    pair = synthetic_pair(3, points_per_cloud=2500, num_keypoints=128, surface_extent=1.3)
    args = (pair["points0"], None, pair["keys0"], pair["points1"], None, pair["keys1"])
    rng = jax.random.PRNGKey(5)
    ref = jax.tree_util.tree_map(np.asarray, jpipe.register_pair(rng, *args))
    _, _, r_ransac = jax.random.split(rng, 3)
    perm = np.array(jax.random.permutation(r_ransac, SMALL["keynum"]))

    variables = jax.tree_util.tree_map(np.asarray, {k: jvars[k] for k in ("backbone", "gf", "rd", "et")})
    pipe = RegistrationPipeline(PipelineConfig(**SMALL), variables, device="cpu")
    out = {k: v.numpy() for k, v in pipe.register_pair(*args, perm=perm).items()}
    bb, gf = pipe.describe(*args[:3])
    assert np.array_equal(bb.numpy(), out["bb0"]) and np.array_equal(gf.numpy(), out["gf0"])

    # the reference's winning hypothesis, from its own stages
    bb0, gf0 = jpipe.describe(*args[:3])
    bb1, gf1 = jpipe.describe(*args[3:])
    s0, m1s = ref["matches"][:, 0], ref["matches"][:, 1]
    k0, k1 = jnp.asarray(pair["keys0"])[s0], jnp.asarray(pair["keys1"])[m1s]
    quats = jet_apply(jvars["et"], bb0[s0], bb1[m1s], gf0[s0], gf1[m1s], jnp.asarray(ref["dr_index"]), jcfg)
    T_hyp = jest.local_transforms(quats, jnp.asarray(ref["dr_index"]), k0, k1, jax_group(12).rotations)
    valid = jnp.asarray(ref["est_valid"])
    take = perm[: min(SMALL["max_iter"], SMALL["keynum"])]
    ov = jest.score_hypotheses(T_hyp[take], k0, k1, jnp.ones(SMALL["keynum"]), valid, jcfg.ransac_ird)
    ov = jnp.where(valid[take], ov, -1.0)
    ref_winner = int(take[int(jnp.argmax(ov))])
    return ref, out, ref_winner


def test_samples_and_matches_equal(run):
    ref, out, _ = run
    assert set(out["sample0"].tolist()) == set(ref["matches"][:, 0].tolist())
    assert np.array_equal(out["matches"], ref["matches"])
    assert np.array_equal(out["match_valid"], ref["match_valid"])
    assert out["match_valid"].sum() >= 5
    assert np.array_equal(out["dr_index"], ref["dr_index"])


def test_winner_and_transform_match(run):
    ref, out, ref_winner = run
    assert int(out["winner"]) == ref_winner
    assert np.abs(out["transform"] - ref["transform"]).max() <= TOL
    assert abs(float(out["overlap"]) - float(ref["overlap"])) <= 1e-6
    assert float(ref["overlap"]) * ref["est_valid"].sum() >= 3  # a determined refit


def test_descriptors_unit_norm(run):
    _, out, _ = run
    assert out["bb0"].shape == (128, 12, 32) and out["gf0"].shape == (128, 12, 32)
    assert np.allclose(np.linalg.norm(out["gf0"], axis=-1), 1.0, atol=1e-5)
    assert np.allclose(np.linalg.norm(out["bb0"], axis=-1), 1.0, atol=1e-5)


def test_random_sampling_takes_injected_noise():
    """With use_rd=False the keypoint sampling reads the injected noise."""
    cfg = PipelineConfig(**{**SMALL, "use_rd": False})
    from roreg_tpu_torch.weights import init_variables

    pipe = RegistrationPipeline(cfg, init_variables(cfg, 0), device="cpu")
    noise = np.random.default_rng(0).random(128).astype(np.float32)
    keys = torch.zeros(128, 3)
    s = pipe.sample_keypoints(keys, None, torch.ones(128, dtype=torch.bool), noise=noise)
    assert set(s.tolist()) == set(np.argsort(-noise)[:64].tolist())
