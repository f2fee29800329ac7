"""The pair axis: the batched pair stage against the one-pair path and
against the JAX package's ``pair_batch_from_stacks``, and the batched
evaluator.

Small config: G = 12, keynum 48, random weights from the port's numpy
initialiser (the same arrays feed both packages). Refits use a determined
inlier radius (ROADMAP C3). Batched reductions sum in another order than
the one-pair path, so transforms are held to 1e-4 and matching scores to
1e-5, as ``tests/test_dist_eval.py`` holds the JAX package's own batching.
"""

import dataclasses

import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from roreg_tpu_torch.dist import eval as dist_eval  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.weights import init_variables  # noqa: E402

G, K, KEYNUM, B = 12, 96, 48, 4
T_TOL = 1e-4
SCORE_TOL = 1e-5
SMALL = dict(
    voxel_size=0.05, group_size=G, capacities=(512, 256, 128, 64), block_caps=(64, 32, 16, 8),
    conv1_kernel_size=3, group_chunk=4, num_keypoints=K, keynum=KEYNUM, max_iter=64, bs_gf=48,
    bs_et=40, backbone_compute_dtype=None, ransac_ird=0.5,
)
VARIANTS = {
    "mutual_yohoc": dict(use_rd=False, use_rm=False, estimator="yohoc"),
    "rd_yohoc": dict(use_rd=True, use_rm=False, estimator="yohoc"),
    "rd_rm_yohoc": dict(use_rd=True, use_rm=True, estimator="yohoc"),
    "full_rd_rm_et_yohoo": dict(use_rd=True, use_rm=True, estimator="yohoo"),
}


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clouds(n, seed=7, rows=KEYNUM):
    """n clouds' descriptor sets (bb, gf (rows, G, 32), kp (rows, 3)):
    cloud c is a rigid motion of a permutation of cloud 0, its features
    cloud 0's plus noise, so that pairs share many correspondences."""
    rng = np.random.default_rng(seed)
    gf0, bb0 = _unit(rng.normal(size=(rows, G, 32))), _unit(rng.normal(size=(rows, G, 32)))
    kp0 = rng.uniform(0, 1.5, (rows, 3))
    out = [(bb0, gf0, kp0)]
    for _ in range(n - 1):
        p = rng.permutation(rows)
        R, t = _rotation(rng), rng.uniform(-0.5, 0.5, 3)
        out.append((bb0[p] + 0.05 * rng.normal(size=bb0.shape), gf0[p] + 0.05 * rng.normal(size=gf0.shape),
                    (kp0[p] - t) @ R))
    return [tuple(a.astype(np.float32) for a in c) for c in out]


def _draws(cfg, rng, b):
    """Draws for b pairs: a permutation per pair for yohoo, uniform buckets
    and standard Gumbel noise for yohoc."""
    if cfg.estimator == "yohoo":
        return {"perm": np.stack([rng.permutation(KEYNUM) for _ in range(b)])}
    return {"buckets": rng.integers(0, G, (b, cfg.max_iter)),
            "gumbel": rng.gumbel(size=(b, cfg.max_iter, KEYNUM)).astype(np.float32)}


@pytest.fixture(scope="module")
def variables():
    return init_variables(PipelineConfig(**SMALL, use_rm=True), 3)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batched_pair_stage_equals_the_one_pair_path(variables, variant):
    cfg = PipelineConfig(**SMALL, **VARIANTS[variant])
    pipe = RegistrationPipeline(cfg, variables, device="cpu")
    clouds = _clouds(B + 1)
    pairs = [(0, 1), (2, 0), (3, 4), (1, 3)]  # clouds shared across pairs
    sets = [torch.from_numpy(np.stack([clouds[p[side]][k] for p in pairs]))
            for k in range(3) for side in (0, 1)]
    bb0, bb1, gf0, gf1, k0, k1 = sets
    draws = _draws(cfg, np.random.default_rng(1), B)
    out = pipe.batched_pair_stage(bb0, bb1, gf0, gf1, k0, k1, **draws)
    assert out["transform"].shape == (B, 4, 4) and out["m0"].shape == (B, KEYNUM)
    for b in range(B):
        one = pipe.pair_stage(bb0[b], bb1[b], gf0[b], gf1[b], k0[b], k1[b],
                              **{k: v[b] for k, v in draws.items()})
        for key in ("m0", "m1", "match_valid", "est_valid", "dr_index", "winner"):
            assert torch.equal(out[key][b], one[key]), (b, key)
        assert (out["match_scores"][b] - one["match_scores"]).abs().max() <= SCORE_TOL
        assert (out["transform"][b] - one["transform"]).abs().max() <= T_TOL
        assert abs(float(out["overlap"][b] - one["overlap"])) <= SCORE_TOL
        assert int(one["est_valid"].sum()) >= 6


def _jax_draws(key, indices, valid, max_iter):
    """yohoc's draws from ``key`` as ``roreg_tpu.pipeline.estimator`` makes
    them (estimator.py:151-163)."""
    import jax
    import jax.numpy as jnp

    from roreg_tpu.pipeline import estimator as jest

    votes = jnp.zeros((G,), jnp.int32).at[jnp.where(valid, indices, G)].add(1, mode="drop")
    prob = jest._vote_probability(votes)
    safe = jnp.where(jnp.sum(prob) < 1e-12, jnp.ones_like(prob) / G, prob)
    k_bucket, k_members = jax.random.split(key)
    buckets = jax.random.categorical(k_bucket, jnp.log(jnp.maximum(safe, 1e-30)), shape=(max_iter,))
    return np.array(buckets), np.array(jax.random.gumbel(k_members, (max_iter, indices.shape[0])))


@pytest.mark.parametrize("variant,per_pair", [("mutual_yohoc", True), ("full_rd_rm_et_yohoo", False)])
def test_pair_batch_from_stacks_equals_jax(variables, variant, per_pair):
    """The JAX package's ``pair_batch_from_stacks`` and the port's on the
    same stacks and weights, with the JAX draws fed in: the per-(pair,
    side) sampling noise from its fold-ins of (p0, p1, side), and each
    pair's ``perm`` or ``buckets`` and ``gumbel`` from its key."""
    import jax
    import jax.numpy as jnp

    from roreg_tpu.dist.eval import batched_pair_stage as j_batched
    from roreg_tpu.dist.eval import pair_batch_from_stacks as j_from_stacks
    from roreg_tpu.pipeline.config import PipelineConfig as JConfig

    flags = VARIANTS[variant]
    cfg = PipelineConfig(**SMALL, **flags)
    jcfg = JConfig(**SMALL, **flags)
    rows = K if per_pair else KEYNUM
    clouds = _clouds(4, seed=11, rows=rows)
    all_bb, all_gf, all_kp = (np.stack([c[k] for c in clouds]) for k in range(3))
    ids = [(0, 1), (0, 2), (1, 3), (2, 3)]  # cloud ids, which the fold-ins use
    i0 = np.array([p[0] for p in ids], np.int32)
    i1 = np.array([p[1] for p in ids], np.int32)
    base_key = jax.random.PRNGKey(5)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(100, 100 + B))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = jax.tree_util.tree_map(np.asarray, j_from_stacks(
        jvars, jcfg, base_key, rngs, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(i0), jnp.asarray(i1),
        jnp.asarray(all_bb), jnp.asarray(all_gf), jnp.asarray(all_kp), per_pair_sample=per_pair))

    draws = {}
    sets = [(all_bb[i0], all_gf[i0], all_kp[i0]), (all_bb[i1], all_gf[i1], all_kp[i1])]
    if per_pair:
        def noise(pa, pb, side):
            r = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base_key, pa), pb), side)
            return np.array(jax.random.uniform(r, (K,)))

        draws["noise"] = np.stack([[noise(a, b, 0), noise(a, b, 1)] for a, b in ids])
        s = np.argsort(-draws["noise"], axis=-1, kind="stable")[..., :KEYNUM]
        sets = [tuple(x[np.arange(B)[:, None], s[:, side]] for x in sets[side]) for side in (0, 1)]
    if flags["estimator"] == "yohoo":
        draws["perm"] = np.stack([np.array(jax.random.permutation(rngs[b], KEYNUM)) for b in range(B)])
    else:
        (bb0, gf0, k0), (bb1, gf1, k1) = sets
        stage = j_batched(jvars, jcfg, rngs, *(jnp.asarray(a) for a in (bb0, bb1, gf0, gf1, k0, k1)))
        yd = [_jax_draws(rngs[b], stage["dr_index"][b], stage["est_valid"][b], cfg.max_iter) for b in range(B)]
        draws["buckets"] = np.stack([d[0] for d in yd])
        draws["gumbel"] = np.stack([d[1] for d in yd])

    pipe = RegistrationPipeline(cfg, variables, device="cpu")
    t = [torch.from_numpy(a) for a in (all_bb, all_gf, all_kp)]
    out = dist_eval.pair_batch_from_stacks(
        pipe, torch.from_numpy(i0), torch.from_numpy(i1), *t, per_pair_sample=per_pair,
        **{k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    out = {k: v.numpy() for k, v in out.items()}
    assert set(out) == set(ref)
    assert np.array_equal(out["est_valid"], ref["est_valid"])
    assert np.array_equal(out["keys_m0"], ref["keys_m0"]) and np.array_equal(out["keys_m1"], ref["keys_m1"])
    assert ref["est_valid"].sum(-1).min() >= 6
    assert np.abs(out["transform"] - ref["transform"]).max() <= T_TOL
    assert np.abs(out["overlap"] - ref["overlap"]).max() <= SCORE_TOL


def test_sharded_variants_name_a7(variables):
    """The sharded variants (ROADMAP item A7, now ported) on a mesh of one
    process: each equals its batched stage exactly, and a pair count that
    does not divide among the mesh's ranks is refused (a world of two runs
    in tests/test_torch_dist.py)."""
    from roreg_tpu_torch.dist.mesh import make_mesh

    mesh = make_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)
    cfg = PipelineConfig(**SMALL, **VARIANTS["full_rd_rm_et_yohoo"])
    pipe = RegistrationPipeline(cfg, variables, device="cpu")
    clouds = _clouds(4, seed=5)
    all_bb, all_gf, all_kp = (torch.from_numpy(np.stack([c[k] for c in clouds])) for k in range(3))
    i0, i1 = torch.tensor([0, 0, 1, 2]), torch.tensor([1, 2, 3, 3])
    draws = {k: torch.from_numpy(v) for k, v in _draws(cfg, np.random.default_rng(2), B).items()}
    ref = dist_eval.pair_batch_from_stacks(pipe, i0, i1, all_bb, all_gf, all_kp, **draws)
    out = dist_eval.pair_stacks_sharded(mesh, pipe, i0, i1, all_bb, all_gf, all_kp, **draws)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    sets = [t[i] for t in (all_bb, all_gf, all_kp) for i in (i0, i1)]  # bb0, bb1, gf0, gf1, k0, k1
    ref = dist_eval.batched_pair_stage(pipe, *sets, **draws)
    out = dist_eval.eval_pairs_sharded(mesh, pipe, *sets, **draws)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    bad = dataclasses.replace(mesh, size=3)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        dist_eval.eval_pairs_sharded(bad, pipe, *sets, **draws)


# ---------------------------------------------------------------------------
# the batched evaluator


class _StubPipeline:
    """Just what the evaluator and ``pair_batch_from_stacks`` read: the
    pair stage returns each set's rows in order, so the matched keypoints
    are the sampled ones."""

    device = torch.device("cpu")

    def __init__(self, cfg):
        self.cfg = cfg

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    def batched_pair_stage(self, bb0, bb1, gf0, gf1, k0, k1, **draws):
        b, m = k0.shape[:2]
        ids = torch.arange(m).expand(b, m)
        return {"transform": torch.eye(4).expand(b, 4, 4), "overlap": torch.zeros(b), "m0": ids, "m1": ids,
                "est_valid": torch.zeros((b, m), dtype=torch.bool)}


class _StubScene:
    name = "stub"
    pc_ids = ("0", "1", "2")
    pair_ids = (("0", "1"), ("0", "2"))  # both pairs share cloud 0

    def get_kps(self, pc_id):
        # the first coordinate is the keypoint's index: sampled ids show
        idx = np.arange(64, dtype=np.float32)[:, None]
        rest = np.random.default_rng(int(pc_id)).uniform(0, 1, size=(64, 2)).astype(np.float32)
        return np.concatenate([idx, rest], 1)

    def get_transform(self, id0, id1):
        return np.eye(4)


def _sampled_ids(monkeypatch, seed):
    """Cloud 0's sampled keypoint ids in pairs (0, 1) and (0, 2) without RD,
    as the evaluator hands them to FMR/IR."""
    import roreg_tpu_torch.eval.evaluator as ev_mod

    cfg = PipelineConfig(use_rd=False, use_rm=False, keynum=16, eval_pair_batch=2)
    ev = ev_mod.Evaluator(_StubPipeline(cfg))
    ev.describe_cloud = lambda ds, pc_id: (torch.zeros(64, 2, 4), torch.zeros(64, 2, 4), torch.zeros(64))
    captured = []

    def spy(km0, km1, est_valid, T_gt, t1, t2):
        captured.append(np.asarray(km0))
        return 0.0, 0.0

    monkeypatch.setattr(ev_mod, "fmr_ir", spy)
    ev.process_scene(_StubScene(), seed=seed)
    assert len(captured) == 2
    return [np.sort(c[:, 0].astype(int)) for c in captured]


def test_pairs_sharing_a_cloud_sample_independently(monkeypatch):
    """ROADMAP C15, the port of ``tests/test_evaluator_sampling.py``: with
    ``use_rd=False`` two pairs that share a cloud draw different subsets,
    the same ones again for the same seed, and others for another seed."""
    a01, a02 = _sampled_ids(monkeypatch, 3)
    assert len(set(a01)) == 16 and not np.array_equal(a01, a02)
    b01, b02 = _sampled_ids(monkeypatch, 3)
    assert np.array_equal(a01, b01) and np.array_equal(a02, b02)
    c01, _ = _sampled_ids(monkeypatch, 4)
    assert not np.array_equal(a01, c01)


def _scene_store(scene, keypoints=K):
    """(bb, gf) per cloud: unit rows of sines of the keypoints' positions in
    cloud 0's frame, so corresponding keypoints of two clouds look alike."""
    rng = np.random.default_rng(0)
    W = rng.normal(size=(2, 3, G * 32)) * 3.0
    bias = rng.uniform(0, 2 * np.pi, (2, G * 32))
    out = []
    for k, kp in enumerate(scene.keypoints):
        T = np.eye(4) if k == 0 else scene.gt[(0, k)]
        p = kp.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        out.append([torch.from_numpy(_unit(np.sin(p @ w + c).reshape(keypoints, G, 32)).astype(np.float32))
                    for w, c in zip(W, bias)])
    return out


def test_evaluator_results_do_not_depend_on_the_batch(variables):
    """A 4-cloud scene (6 pairs) at ``eval_pair_batch`` 1 and 4: the second
    pads its last batch with 2 duplicate rows, which must not reach the
    results. RD sampling and mutual matching are deterministic, and
    ``max_iter`` >= ``keynum`` scores every hypothesis, so the draws only
    order them."""
    from roreg_tpu_torch.eval.evaluator import Evaluator

    scene = synthetic_scene(np.random.default_rng(4), num_clouds=4, points_per_cloud=1500, num_keypoints=K,
                            overlap=0.7, max_angle_deg=50.0, surface_extent=1.2, name="scene")
    descs = _scene_store(scene)
    results = []
    for nb in (1, 4):
        cfg = PipelineConfig(**SMALL, use_rd=True, use_rm=False, estimator="yohoo", eval_pair_batch=nb)
        pipe = RegistrationPipeline(cfg, variables, device="cpu")
        ones = torch.ones(K, dtype=torch.bool)
        store = {("scene", str(k)): (bb, gf, pipe.detect(gf, ones)) for k, (bb, gf) in enumerate(descs)}
        ev = Evaluator(pipe, desc_store=store)
        results.append(ev.process_scene(scene, seed=2))
        assert ev.timer.counts["match_estimate"] == -(-6 // nb)
    one, four = results
    assert one["pairs"] == four["pairs"] == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for key in ("fmr", "ir", "rr"):
        assert one[key] == four[key], key
    assert np.abs(np.stack(one["transforms"]) - np.stack(four["transforms"])).max() <= T_TOL
    assert np.abs(np.array(one["overlaps"]) - np.array(four["overlaps"])).max() <= SCORE_TOL
    assert max(one["ir"]) > 0
