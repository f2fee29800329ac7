"""yohoc RANSAC and the descriptor-level pair stage against the JAX package.

The reference draws yohoc's buckets and Gumbel noise from a JAX key, which
torch cannot reproduce; here the reference's own draws (made from the same
key as ``roreg_tpu/pipeline/estimator.py`` makes them) are fed to the port.
Refits use a determined inlier radius where they refit (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.core import se3 as jse3  # noqa: E402
from roreg_tpu.pipeline import estimator as jest  # noqa: E402
from roreg_tpu_torch.core import se3  # noqa: E402
from roreg_tpu_torch.pipeline import estimator as est  # noqa: E402

G = 12
T_TOL = 1e-4  # f32 Kabsch fits and two weighted refits, SVDs of two frameworks
HYP_TOL = 1e-5  # one f32 Kabsch fit of a non-degenerate triple
PROB_TOL = 1e-7  # the cubic vote weights in f32


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _jax_draws(key, indices, valid, max_iter):
    """The draws ``roreg_tpu.pipeline.estimator.yohoc_ransac`` makes from
    ``key`` (estimator.py:151-163)."""
    votes = jnp.zeros((G,), jnp.int32).at[jnp.where(valid, indices, G)].add(1, mode="drop")
    prob = jest._vote_probability(votes)
    degenerate = jnp.sum(prob) < 1e-12
    k_bucket, k_members = jax.random.split(key)
    safe = jnp.where(degenerate, jnp.ones_like(prob) / G, prob)
    buckets = jax.random.categorical(k_bucket, jnp.log(jnp.maximum(safe, 1e-30)), shape=(max_iter,))
    gumbel = jax.random.gumbel(k_members, (max_iter, indices.shape[0]))
    return np.array(buckets), np.array(gumbel)


def _problem(seed, m=96, inlier_share=0.6, buckets_used=4):
    """Matches of which a share follow one rigid motion, their group indices
    concentrated on a few buckets, scores in (0, 1], a few invalid."""
    rng = np.random.default_rng(seed)
    keys1 = rng.uniform(-1, 1, (m, 3))
    R, t = _rotation(rng), rng.uniform(-0.5, 0.5, 3)
    keys0 = keys1 @ R.T + t + 0.01 * rng.normal(size=(m, 3))
    out = rng.random(m) > inlier_share
    keys0[out] = rng.uniform(-1, 1, (int(out.sum()), 3))
    indices = rng.integers(0, buckets_used, m)
    scores = rng.uniform(0.2, 1.0, m)
    valid = rng.random(m) > 0.1
    return (keys0.astype(np.float32), keys1.astype(np.float32), indices.astype(np.int32),
            scores.astype(np.float32), valid)


def test_three_points_to_transform_matches_jax():
    rng = np.random.default_rng(0)
    kps1 = rng.uniform(-1, 1, (64, 3, 3)).astype(np.float32)
    kps0 = np.stack([k @ _rotation(rng).T + rng.uniform(-1, 1, 3) for k in kps1]).astype(np.float32)
    kps0 += 0.02 * rng.normal(size=kps0.shape).astype(np.float32)
    ref = np.asarray(jse3.three_points_to_transform(jnp.asarray(kps0), jnp.asarray(kps1)))
    got = se3.three_points_to_transform(torch.from_numpy(kps0), torch.from_numpy(kps1)).numpy()
    assert np.abs(got - ref).max() <= HYP_TOL


def test_vote_probability_matches_jax():
    rng = np.random.default_rng(1)
    for votes in (rng.integers(0, 200, G), np.array([0, 1, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0]),
                  np.array([3] + [0] * (G - 1)), np.zeros(G, int)):
        votes = votes.astype(np.int32)
        ref = np.asarray(jest._vote_probability(jnp.asarray(votes)))
        got = est._vote_probability(torch.from_numpy(votes)).numpy()
        assert np.abs(got - ref).max() <= PROB_TOL
    assert got.sum() == 0  # no bucket with 2 votes: degenerate


@pytest.mark.parametrize("seed,inlier_dist", [(2, 0.5), (3, 0.5), (4, 0.3)])
def test_yohoc_ransac_with_jax_draws_matches_jax(seed, inlier_dist):
    keys0, keys1, indices, scores, valid = _problem(seed)
    key = jax.random.PRNGKey(seed)
    max_iter = 200
    T_ref, ov_ref = jest.yohoc_ransac(
        key, jnp.asarray(indices), jnp.asarray(keys0), jnp.asarray(keys1), jnp.asarray(scores),
        jnp.asarray(valid), inlier_dist, max_iter, G,
    )
    buckets, gumbel = _jax_draws(key, jnp.asarray(indices), jnp.asarray(valid), max_iter)
    T, ov, winner = est.yohoc_ransac(
        torch.from_numpy(buckets).long(), torch.from_numpy(gumbel), torch.from_numpy(indices).long(),
        torch.from_numpy(keys0), torch.from_numpy(keys1), torch.from_numpy(scores),
        torch.from_numpy(valid), inlier_dist, G,
    )
    assert np.abs(T.numpy() - np.asarray(T_ref)).max() <= T_TOL
    assert abs(float(ov) - float(ov_ref)) <= 1e-6
    assert float(ov) > 0 and 0 <= int(winner) < max_iter


def test_yohoc_tie_order_in_a_bucket_with_two_members():
    """Every bucket holds at most 2 valid matches: no bucket has weight, so
    each iteration's bucket is uniform, every hypothesis scores -1 and the
    first one wins. Its triple fills the slots its bucket lacks with
    non-members, which tie at -1e9: the lowest indices, as jax.lax.top_k
    takes them. The keys are unrelated and the radius small, so the refits
    find no inlier and keep that hypothesis as it is."""
    rng = np.random.default_rng(5)
    m = 20
    keys0 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    keys1 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    indices = np.repeat(np.arange(10), 2).astype(np.int32)  # 2 members a bucket
    rng.shuffle(indices)
    scores = np.ones(m, np.float32)
    valid = np.ones(m, bool)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        T_ref, ov_ref = jest.yohoc_ransac(
            key, jnp.asarray(indices), jnp.asarray(keys0), jnp.asarray(keys1), jnp.asarray(scores),
            jnp.asarray(valid), 1e-3, 8, G,
        )
        buckets, gumbel = _jax_draws(key, jnp.asarray(indices), jnp.asarray(valid), 8)
        T, ov, winner = est.yohoc_ransac(
            torch.from_numpy(buckets).long(), torch.from_numpy(gumbel), torch.from_numpy(indices).long(),
            torch.from_numpy(keys0), torch.from_numpy(keys1), torch.from_numpy(scores),
            torch.from_numpy(valid), 1e-3, G,
        )
        # the winning triple: the bucket's members by Gumbel order, then the
        # lowest-index non-members
        members = np.flatnonzero(indices == buckets[0])
        members = members[np.argsort(-gumbel[0, members], kind="stable")]
        others = np.setdiff1d(np.arange(m), members)
        triple = np.concatenate([members, others])[:3]
        expect = np.asarray(jse3.three_points_to_transform(jnp.asarray(keys0[triple]), jnp.asarray(keys1[triple])))
        assert float(ov) == float(ov_ref) == -1.0 and int(winner) == 0
        assert np.abs(T.numpy() - np.asarray(T_ref)).max() <= HYP_TOL
        assert np.abs(T.numpy() - expect).max() <= HYP_TOL


def test_yohoc_draws_follow_the_vote_probability():
    """The port's own draws: buckets only where the votes give weight, and
    standard Gumbel noise (mean 0.5772, the Euler-Mascheroni constant)."""
    _, _, indices, _, valid = _problem(6, m=400, buckets_used=5)
    idx = torch.from_numpy(indices).long()
    gen = torch.Generator().manual_seed(0)
    buckets, gumbel = est.yohoc_draws(idx, torch.from_numpy(valid), 4000, G, gen)
    assert buckets.shape == (4000,) and gumbel.shape == (4000, 400)
    assert set(buckets.tolist()) <= set(range(5))
    assert abs(float(gumbel.mean()) - 0.5772) < 0.01 and bool(torch.isfinite(gumbel).all())
    # degenerate votes: uniform over the G buckets
    buckets, _ = est.yohoc_draws(idx[:10] * 0 + torch.arange(10), torch.ones(10, dtype=torch.bool), 4000, G, gen)
    assert set(buckets.tolist()) == set(range(G))


# ---------------------------------------------------------------------------
# the descriptor-level pair stage, all four chain variants

K, KEYNUM = 96, 48
SMALL = dict(
    voxel_size=0.05, group_size=G, capacities=(512, 256, 128, 64), block_caps=(64, 32, 16, 8),
    conv1_kernel_size=3, group_chunk=4, num_keypoints=K, keynum=KEYNUM, max_iter=64, bs_gf=48,
    bs_et=48, backbone_compute_dtype=None, ransac_ird=0.5,
)
VARIANTS = {
    "mutual_yohoc": dict(use_rd=False, use_rm=False, estimator="yohoc"),
    "rd_yohoc": dict(use_rd=True, use_rm=False, estimator="yohoc"),
    "rd_rm_yohoc": dict(use_rd=True, use_rm=True, estimator="yohoc"),
    "full_rd_rm_et_yohoo": dict(use_rd=True, use_rm=True, estimator="yohoo"),
}


@pytest.fixture(scope="module")
def descriptors():
    """JAX variables of the small config (converted for the port), and two
    clouds' descriptors of which many keypoints correspond: cloud 1's are
    a rigid motion of a permutation of cloud 0's, its features theirs plus
    noise."""
    from roreg_tpu.pipeline.config import PipelineConfig as JConfig
    from roreg_tpu.pipeline.registration import RegistrationPipeline as JPipe

    jvars = JPipe(JConfig(**SMALL), {}).init_variables(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    gf0 = rng.normal(size=(K, G, 32))
    gf0 /= np.linalg.norm(gf0, axis=-1, keepdims=True)
    bb0 = rng.normal(size=(K, G, 32))
    bb0 /= np.linalg.norm(bb0, axis=-1, keepdims=True)
    kp0 = rng.uniform(0, 1.5, (K, 3))
    p = rng.permutation(K)
    R, t = _rotation(rng), rng.uniform(-0.5, 0.5, 3)
    kp1 = (kp0[p] - t) @ R  # kp0[p] = R kp1 + t
    gf1 = gf0[p] + 0.05 * rng.normal(size=gf0.shape)
    bb1 = bb0[p] + 0.05 * rng.normal(size=bb0.shape)
    arrays = [a.astype(np.float32) for a in (bb0, gf0, kp0, bb1, gf1, kp1)]
    return jax.tree_util.tree_map(np.asarray, jvars), jvars, arrays


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_register_pair_from_descriptors_matches_jax(descriptors, variant):
    from roreg_tpu.pipeline.config import PipelineConfig as JConfig
    from roreg_tpu.pipeline.registration import (
        RegistrationPipeline as JPipe,
        rd_apply as j_rd_apply,
        register_pair_from_descriptors as j_register,
    )
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

    variables, jvars, (bb0, gf0, kp0, bb1, gf1, kp1) = descriptors
    flags = VARIANTS[variant]
    jcfg = JConfig(**SMALL, **flags)
    ones = jnp.ones(K, bool)
    det0 = j_rd_apply(jvars["rd"], jnp.asarray(gf0), ones, jcfg)
    det1 = j_rd_apply(jvars["rd"], jnp.asarray(gf1), ones, jcfg)
    rng = jax.random.PRNGKey(11)
    ref = jax.tree_util.tree_map(np.asarray, j_register(
        JPipe(jcfg, jvars).variables, jcfg, rng, jnp.asarray(bb0), jnp.asarray(gf0), det0,
        jnp.asarray(kp0), jnp.asarray(bb1), jnp.asarray(gf1), det1, jnp.asarray(kp1),
    ))
    # the reference's draws (registration.py:269, estimator.py:102 and :156-163)
    r_s0, r_s1, r_ransac = jax.random.split(rng, 3)
    draws = {}
    if not flags["use_rd"]:
        draws["noise0"] = np.array(jax.random.uniform(r_s0, (K,)))
        draws["noise1"] = np.array(jax.random.uniform(r_s1, (K,)))
    if flags["estimator"] == "yohoo":
        draws["perm"] = np.array(jax.random.permutation(r_ransac, KEYNUM))
    else:
        draws["buckets"], draws["gumbel"] = _jax_draws(
            r_ransac, jnp.asarray(ref["dr_index"]), jnp.asarray(ref["est_valid"]), SMALL["max_iter"])

    pipe = RegistrationPipeline(PipelineConfig(**SMALL, **flags), variables, device="cpu")
    det = [torch.from_numpy(np.array(d)) for d in (det0, det1)]
    t = [torch.from_numpy(a) for a in (bb0, gf0, kp0, bb1, gf1, kp1)]
    out = {k: v.numpy() for k, v in pipe.register_pair_from_descriptors(
        t[0], t[1], det[0], t[2], t[3], t[4], det[1], t[5], **draws).items()}
    for k in ("sample0", "sample1", "m0", "m1", "match_valid", "est_valid", "dr_index"):
        assert np.array_equal(out[k], ref[k]), k
    assert ref["est_valid"].sum() >= 6
    assert np.abs(out["match_scores"] - ref["match_scores"]).max() <= T_TOL
    assert np.abs(out["transform"] - ref["transform"]).max() <= T_TOL
    assert abs(float(out["overlap"]) - float(ref["overlap"])) <= 1e-6
