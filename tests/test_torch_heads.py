"""GF, RD and ET heads, the matcher and the estimator against the JAX package.

JAX init variables with perturbed batch-norm parameters and statistics are
converted into the port's modules; outputs agree within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.core.group import get_group as jax_group  # noqa: E402
from roreg_tpu.models.et import EquivariantTransformer as JET  # noqa: E402
from roreg_tpu.models.gf import GroupFeatNetwork as JGF  # noqa: E402
from roreg_tpu.models.rd import RotationDetector as JRD  # noqa: E402
from roreg_tpu.pipeline import estimator as jest  # noqa: E402
from roreg_tpu.pipeline import matcher as jmatch  # noqa: E402
from roreg_tpu.pipeline.config import PipelineConfig as JConfig  # noqa: E402
from roreg_tpu.pipeline.registration import et_apply as jet_apply  # noqa: E402
from roreg_tpu.pipeline.registration import gf_apply as jgf_apply  # noqa: E402
from roreg_tpu_torch.core.group import get_group  # noqa: E402
from roreg_tpu_torch.models.et import EquivariantTransformer  # noqa: E402
from roreg_tpu_torch.models.gf import GroupFeatNetwork  # noqa: E402
from roreg_tpu_torch.models.rd import RotationDetector  # noqa: E402
from roreg_tpu_torch.pipeline import estimator as est  # noqa: E402
from roreg_tpu_torch.pipeline import matcher  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import et_apply, gf_apply  # noqa: E402
from roreg_tpu_torch.weights import flatten_variables, load_variables, unflatten_variables  # noqa: E402

G = 12
TOL = 1e-4


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, variables))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return unflatten_variables(flat)


def _port(module, variables):
    load_variables(module, variables)
    return module.eval()


def _feats(rng, b):
    return rng.normal(size=(b, G, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def heads():
    jg = jax_group(G)
    f = jnp.zeros((2, G, 32))
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    v = {
        "gf": _perturbed(JGF(jg).init(ks[0], f, False), 1),
        "rd": _perturbed(JRD(jg).init(ks[1], f, False), 2),
        "et": _perturbed(JET(jg).init(ks[2], f, f, f, f, jnp.zeros((2,), jnp.int32), False), 3),
    }
    g = get_group(G)
    nets = {
        "gf": _port(GroupFeatNetwork(g), v["gf"]),
        "rd": _port(RotationDetector(g), v["rd"]),
        "et": _port(EquivariantTransformer(g), v["et"]),
    }
    return jg, v, nets


def test_gf_matches_jax(heads):
    jg, v, nets = heads
    x = _feats(np.random.default_rng(0), 40)
    ref = JGF(jg).apply(jax.tree_util.tree_map(jnp.asarray, v["gf"]), jnp.asarray(x), False)
    with torch.no_grad():
        out = nets["gf"](torch.from_numpy(x))
    for k in ("eqv", "inv"):
        assert np.abs(out[k].numpy() - np.asarray(ref[k])).max() <= TOL
    # the registration stage's bs_gf chunking
    cfg_j = JConfig(group_size=G, bs_gf=16)
    ref_c = np.asarray(jgf_apply(jax.tree_util.tree_map(jnp.asarray, v["gf"]), jnp.asarray(x), cfg_j))
    with torch.no_grad():
        out_c = gf_apply(nets["gf"], torch.from_numpy(x), PipelineConfig(group_size=G, bs_gf=16))
    assert np.abs(out_c.numpy() - ref_c).max() <= TOL


def test_rd_matches_jax(heads):
    jg, v, nets = heads
    x = _feats(np.random.default_rng(1), 40)
    ref = np.asarray(JRD(jg).apply(jax.tree_util.tree_map(jnp.asarray, v["rd"]), jnp.asarray(x), False))
    with torch.no_grad():
        out = nets["rd"](torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= TOL


def test_et_matches_jax(heads):
    jg, v, nets = heads
    rng = np.random.default_rng(2)
    b0, b1, a0, a1 = (_feats(rng, 40) for _ in range(4))
    idx = rng.integers(0, G, size=40).astype(np.int32)
    vj = jax.tree_util.tree_map(jnp.asarray, v["et"])
    ref = np.asarray(JET(jg).apply(vj, *(jnp.asarray(a) for a in (b0, b1, a0, a1, idx)), False, True))
    t = torch.from_numpy
    with torch.no_grad():
        out = nets["et"](t(b0), t(b1), t(a0), t(a1), t(idx).long()).numpy()
    assert np.abs(out - ref).max() <= TOL
    # the registration stage's side exchange and bs_et chunking
    ref_c = np.asarray(jet_apply(vj, *(jnp.asarray(a) for a in (b0, b1, a0, a1, idx)), JConfig(group_size=G, bs_et=16)))
    with torch.no_grad():
        out_c = et_apply(nets["et"], t(b0), t(b1), t(a0), t(a1), t(idx).long(), PipelineConfig(group_size=G, bs_et=16))
    assert np.abs(out_c.numpy() - ref_c).max() <= TOL


def test_matcher_matches_jax():
    rng = np.random.default_rng(3)
    keys = rng.uniform(0, 1, size=(300, 3)).astype(np.float32)
    scores = rng.normal(size=300).astype(np.float32)
    mask = rng.random(300) > 0.1
    rn_j = np.asarray(jmatch.rank_normalize(jnp.asarray(scores), jnp.asarray(mask)))
    rn = matcher.rank_normalize(torch.from_numpy(scores), torch.from_numpy(mask)).numpy()
    assert np.array_equal(rn, rn_j)
    s_j = np.asarray(jmatch.nms_sample(jnp.asarray(keys), jnp.asarray(rn_j), jnp.asarray(mask), 64, 5))
    s = matcher.nms_sample(torch.from_numpy(keys), torch.from_numpy(rn), torch.from_numpy(mask), 64, 5).numpy()
    assert set(s.tolist()) == set(s_j.tolist())
    f0, f1 = _feats(rng, 64), _feats(rng, 64)
    f1[:40] = f0[:40] + 0.05 * rng.normal(size=(40, G, 32))
    ones = np.ones(64, bool)
    nj, mj = jmatch.mutual_match(*(jnp.asarray(a) for a in (f0, f1, ones, ones)))
    n, m = matcher.mutual_match(*(torch.from_numpy(a) for a in (f0, f1, ones, ones)))
    assert np.array_equal(n.numpy(), np.asarray(nj)) and np.array_equal(m.numpy(), np.asarray(mj))


def test_estimator_matches_jax():
    rng = np.random.default_rng(4)
    g = get_group(G)
    M = 80
    e0, e1 = _feats(rng, M), _feats(rng, M)
    t = torch.from_numpy
    dr_j = np.asarray(jest.dr_index(jnp.asarray(e0), jnp.asarray(e1), jnp.asarray(g.cayley)))
    dr = est.dr_index(t(e0), t(e1), t(g.cayley).long()).numpy()
    assert np.array_equal(dr, dr_j)
    # a true motion plus outliers, so RANSAC has something to find
    R = g.rotations[5].astype(np.float32)
    k1 = rng.uniform(-1, 1, size=(M, 3)).astype(np.float32)
    k0 = k1 @ R.T + np.float32([0.3, -0.2, 0.1])
    k0[40:] = rng.uniform(-1, 1, size=(M - 40, 3))
    q = rng.normal(size=(M, 4)).astype(np.float32) * 0.05
    q[:, 0] = 1.0
    rots = g.rotations.astype(np.float32)
    Th_j = np.asarray(jest.local_transforms(*(jnp.asarray(a) for a in (q, dr_j, k0, k1, rots))))
    Th = est.local_transforms(t(q), t(dr).long(), t(k0), t(k1), t(rots)).numpy()
    assert np.abs(Th - Th_j).max() <= 1e-5
    scores = rng.uniform(0.5, 1, size=M).astype(np.float32)
    valid = rng.random(M) > 0.1
    ov_j = np.asarray(jest.score_hypotheses(*(jnp.asarray(a) for a in (Th_j, k0, k1, scores, valid)), 0.1))
    ov = est.score_hypotheses(t(Th), t(k0), t(k1), t(scores), t(valid), 0.1).numpy()
    assert np.abs(ov - ov_j).max() <= 1e-6
    key = jax.random.PRNGKey(7)
    T_j, o_j = jest.yohoo_ransac(key, *(jnp.asarray(a) for a in (Th_j, valid, k0, k1, scores, valid)), 0.1, 50)
    perm = np.array(jax.random.permutation(key, M))
    T, o, _ = est.yohoo_ransac(t(perm), t(Th), t(valid), t(k0), t(k1), t(scores), t(valid), 0.1, 50)
    assert np.abs(T.numpy() - np.asarray(T_j)).max() <= TOL
    assert abs(float(o) - float(o_j)) <= 1e-6


def test_so3_gather_matches_jax():
    from roreg_tpu.models.ops import so3_gather as jgather
    from roreg_tpu_torch.models.ops import GroupConv, so3_gather

    nei = get_group(G).nei13
    x = _feats(np.random.default_rng(5), 6)
    ref = np.asarray(jgather(jnp.asarray(x), jnp.asarray(nei)))
    out = so3_gather(torch.from_numpy(x), torch.from_numpy(nei).long())
    assert out.shape == ref.shape == (6, G, nei.shape[1], 32) and np.array_equal(out.numpy(), ref)
    # GroupConv gathers through it: its output is the linear map of the gathered rows
    conv = GroupConv(32, 8, nei)
    with torch.no_grad():
        want = out.reshape(6, G, -1) @ conv.weight.T + conv.bias
        assert torch.equal(conv(torch.from_numpy(x)), want)


def test_des_to_dr_index_matches_jax(heads):
    from roreg_tpu.models.gf import GFOutput as JGFOutput
    from roreg_tpu.models.gf import des_to_dr_index as jdes
    from roreg_tpu_torch.models.gf import GFOutput, des_to_dr_index

    assert GFOutput is JGFOutput is dict
    jg, v, nets = heads
    rng = np.random.default_rng(6)
    x0 = _feats(rng, 40)
    cay = get_group(G).cayley
    # cloud 1: cloud 0 permuted by known group elements, so each row has a true index
    a = rng.integers(0, G, size=40)
    x1 = np.stack([x0[i][cay[a[i]]] for i in range(40)]) + 0.01 * rng.normal(size=x0.shape).astype(np.float32)
    with torch.no_grad():
        out0, out1 = (nets["gf"](torch.from_numpy(x)) for x in (x0, x1))
    assert isinstance(out0, GFOutput)
    e0, e1 = out0["eqv"], out1["eqv"]
    ref = np.asarray(jdes(jnp.asarray(e0.numpy()), jnp.asarray(e1.numpy()), jnp.asarray(cay)))
    idx = des_to_dr_index(e0, e1, torch.from_numpy(cay).long()).numpy()
    assert np.array_equal(idx, ref)
    # ties: equal correlations take the first maximum, as jnp.argmax does
    flat = np.ones((3, G, 32), np.float32)
    tie_ref = np.asarray(jdes(jnp.asarray(flat), jnp.asarray(flat), jnp.asarray(cay)))
    tie = des_to_dr_index(torch.from_numpy(flat), torch.from_numpy(flat), torch.from_numpy(cay).long()).numpy()
    assert np.array_equal(tie, tie_ref) and (tie == 0).all()
