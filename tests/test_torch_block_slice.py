"""The block-engine describe end to end: register_pair with engine="block"
against the JAX package's.

As tests/test_torch_slice.py, on the JAX default engine: both pipelines run
the block engine with the mutual-NN matcher (``use_rm=False``) and yohoo,
at a small size in f32, with the same variables (JAX init, converted) and
the reference's random draws fed to the port as numpy. Keypoint samples
are set-equal, matches and group indices equal, the winning hypothesis the
same, the transform within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
    block_caps=(256, 128, 64, 32), conv1_kernel_size=3, group_chunk=4,
    num_keypoints=128, keynum=64, max_iter=48, bs_gf=48, bs_et=48,
    engine="block", use_rm=False, backbone_compute_dtype=None,
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
    return ref, out, ref_winner, np.asarray(bb0)


def test_block_describe_matches_jax(run):
    _, out, _, ref_bb0 = run
    assert out["bb0"].shape == ref_bb0.shape == (128, 12, 32)
    assert np.abs(out["bb0"] - ref_bb0).max() <= TOL
    assert np.array_equal(out["dropped_blocks"], [0, 0])


def test_block_samples_and_matches_equal(run):
    ref, out, _, _ = run
    assert set(out["sample0"].tolist()) == set(ref["matches"][:, 0].tolist())
    assert np.array_equal(out["matches"], ref["matches"])
    assert np.array_equal(out["match_valid"], ref["match_valid"])
    assert out["match_valid"].sum() >= 5
    assert np.array_equal(out["dr_index"], ref["dr_index"])


def test_block_winner_and_transform_match(run):
    ref, out, ref_winner, _ = run
    assert int(out["winner"]) == ref_winner
    assert np.abs(out["transform"] - ref["transform"]).max() <= TOL
    assert abs(float(out["overlap"]) - float(ref["overlap"])) <= 1e-6
    assert float(ref["overlap"]) * ref["est_valid"].sum() >= 3  # a determined refit


def test_block_caps_fallback_rebuilds(capsys):
    """Capacities that overflow on this cloud: the extractor rebuilds at
    block_caps_fallback, says so on stderr, and gives the features of the
    roomy capacities with nothing dropped."""
    from roreg_tpu_torch.weights import init_variables

    pair = synthetic_pair(4, points_per_cloud=800, num_keypoints=16, surface_extent=1.1)
    tight = PipelineConfig(**{**SMALL, "block_caps": (8, 4, 4, 4), "block_caps_fallback": SMALL["block_caps"]})
    roomy = PipelineConfig(**SMALL)
    v = init_variables(roomy, 0)
    dropped = []
    a = RegistrationPipeline(tight, v, device="cpu").extract(pair["points0"], None, pair["keys0"], dropped=dropped)
    err = capsys.readouterr().err
    assert "rebuilding at fallback" in err and dropped == [0]
    b = RegistrationPipeline(roomy, v, device="cpu").extract(pair["points0"], None, pair["keys0"])
    assert torch.equal(a, b) and a.shape == (16, 12, 32)
