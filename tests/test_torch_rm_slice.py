"""The JAX default chain end to end: register_pair with the block engine and
the RM matcher (``use_rm=True``) against the JAX package's.

As tests/test_torch_block_slice.py, at its small f32 configuration, with
RM in place of the mutual-NN matcher: the same variables (JAX init,
converted), the reference's RANSAC permutation fed to the port. Matches,
their validity, the top-match subset and the group indices equal; the
matching scores and the transform within 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.pipeline.config import PipelineConfig as JConfig  # noqa: E402
from roreg_tpu.pipeline.registration import RegistrationPipeline as JPipe  # noqa: E402
from roreg_tpu_torch.data.synthetic import synthetic_pair  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402

SMALL = dict(
    voxel_size=0.05, group_size=12, capacities=(2048, 1024, 512, 256),
    block_caps=(256, 128, 64, 32), conv1_kernel_size=3, group_chunk=4,
    num_keypoints=128, keynum=64, max_iter=48, bs_gf=48, bs_et=48,
    engine="block", use_rm=True, backbone_compute_dtype=None,
    # a determined refit (ROADMAP C3), as in tests/test_torch_block_slice.py
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

    variables = jax.tree_util.tree_map(np.asarray, jvars)
    cfg = PipelineConfig(**SMALL)
    pipe = RegistrationPipeline(cfg, variables, device="cpu")
    out = {k: v.numpy() for k, v in pipe.register_pair(*args, perm=perm).items()}
    return ref, out, pipe, dataclasses.replace(cfg, rm_row_block=16), variables, args, perm


def test_rm_chain_matches_equal_jax(run):
    ref, out, *_ = run
    assert np.array_equal(out["matches"], ref["matches"])
    assert np.array_equal(out["match_valid"], ref["match_valid"])
    assert np.array_equal(out["est_valid"], ref["est_valid"])
    assert np.array_equal(out["dr_index"], ref["dr_index"])
    assert out["match_valid"].sum() >= 10 and out["est_valid"].sum() >= 10
    assert np.abs(out["match_scores"] - ref["match_scores"]).max() <= TOL


def test_rm_chain_transform_matches_jax(run):
    ref, out, *_ = run
    assert np.abs(out["transform"] - ref["transform"]).max() <= TOL
    assert abs(float(out["overlap"]) - float(ref["overlap"])) <= 1e-6
    assert np.array_equal(out["dropped_blocks"], [0, 0])


def test_rm_chain_with_row_block_is_the_same(run):
    """A set rm_row_block changes memory, not the result."""
    _, out, _, blocked_cfg, variables, args, perm = run
    blocked = RegistrationPipeline(blocked_cfg, variables, device="cpu")
    assert blocked.nets["rm"].layer0.cross_s2t.row_block == 16
    b = blocked.register_pair(*args, perm=perm)
    assert np.array_equal(b["matches"].numpy(), out["matches"])
    assert torch.equal(b["transform"], torch.from_numpy(out["transform"]))
