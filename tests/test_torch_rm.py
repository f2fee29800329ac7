"""The RM matcher and the RM chain's top-match selection against the JAX
package's, on JAX-initialised variables converted through ``weights``.

At G = 12, M = N = 64, ks (16, 8), f32: the log-coupling after 100
Sinkhorn iterations within 1e-4, the matches equal both ways, the matching
scores within 1e-4; blocked kNN rows give the unblocked indices; the
building blocks (masked instance norm, rotation indicator, Sinkhorn,
match extraction with tied maxima) and ``top_match_subset`` with tied
scores equal the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import roreg_tpu.models.rm as jrm  # noqa: E402
from roreg_tpu.core.group import get_group as jax_group  # noqa: E402
from roreg_tpu.pipeline.matcher import top_match_subset as jax_top_match_subset  # noqa: E402
from roreg_tpu_torch.core.group import get_group  # noqa: E402
from roreg_tpu_torch.models import rm  # noqa: E402
from roreg_tpu_torch.pipeline.matcher import top_match_subset  # noqa: E402
from roreg_tpu_torch.weights import load_variables  # noqa: E402

G, M, N = 12, 64, 64
TOL = 1e-4


def _inputs(seed, n_valid0=M, n_valid1=N):
    rng = np.random.default_rng(seed)
    feats0 = rng.normal(size=(1, M, G, 32)).astype(np.float32)
    feats1 = rng.normal(size=(1, N, G, 32)).astype(np.float32)
    keys0 = rng.uniform(0, 1.5, size=(1, M, 3)).astype(np.float32)
    keys1 = rng.uniform(0, 1.5, size=(1, N, 3)).astype(np.float32)
    mask0 = np.arange(M)[None] < n_valid0
    mask1 = np.arange(N)[None] < n_valid1
    return feats0, feats1, keys0, keys1, mask0, mask1


@pytest.fixture(scope="module")
def variables():
    net = jrm.RotationCoherenceMatcher(jax_group(G))
    args = [jnp.asarray(a) for a in _inputs(0)]
    v = net.init(jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, v)


def _port(variables, row_block=None):
    net = rm.RotationCoherenceMatcher(get_group(G), row_block=row_block)
    load_variables(net, variables)
    return net.eval()


def _run_both(variables, inputs):
    ref = jrm.RotationCoherenceMatcher(jax_group(G)).apply(variables, *map(jnp.asarray, inputs))
    with torch.inference_mode():
        out = _port(variables)(*map(torch.from_numpy, inputs))
    return {k: np.asarray(v) for k, v in ref.items() if v is not None}, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("valid", [(M, N), (M - 7, N - 12)], ids=["full", "masked"])
def test_rm_log_coupling_matches_jax(variables, valid):
    ref, out = _run_both(variables, _inputs(1, *valid))
    assert out["scores"].shape == ref["scores"].shape == (1, M + 1, N + 1)
    assert np.abs(out["scores"] - ref["scores"]).max() <= TOL
    for k in ("source_final", "target_final"):
        assert np.abs(out[k] - ref[k]).max() <= TOL


def test_rm_matches_equal_jax(variables):
    ref, out = _run_both(variables, _inputs(2))
    for k in ("matches0", "matches1"):
        assert np.array_equal(out[k], ref[k])
    assert (out["matches0"] >= 0).sum() >= 5
    for k in ("matching_scores0", "matching_scores1"):
        assert np.abs(out[k] - ref[k]).max() <= TOL


def test_rm_row_block_gives_the_unblocked_indices(variables):
    inputs = [torch.from_numpy(a) for a in _inputs(3)]
    q, t = inputs[0].mean(2), inputs[1].mean(2)
    idx, g = rm._topk_gather(q, t, t, 16, inputs[5], None)
    idx_b, g_b = rm._topk_gather(q, t, t, 16, inputs[5], 16)
    assert torch.equal(idx, idx_b) and torch.equal(g, g_b)
    with torch.inference_mode():
        a = _port(variables)(*inputs)
        b = _port(variables, row_block=16)(*inputs)
    assert torch.equal(a["matches0"], b["matches0"]) and torch.equal(a["matches1"], b["matches1"])


def test_topk_takes_lower_index_on_ties():
    """Tied scores: ``lax.top_k``'s order, lower index first."""
    q = torch.ones(1, 3, 4)
    t = torch.ones(1, 6, 4)
    t[0, 4] = 2.0
    mask = torch.tensor([[True, True, False, True, True, True]])
    idx, _ = rm._topk_gather(q, t, t, 3, mask)
    _, ref = jax.lax.top_k(jnp.einsum("bmf,bnf->bmn", q.numpy(), t.numpy())
                           + jnp.where(mask.numpy()[:, None], 0.0, -1e9), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ref))
    assert idx[0, 0].tolist() == [4, 0, 1]


@pytest.mark.parametrize("ndim", [3, 4])
def test_masked_instance_norm_matches_jax(ndim):
    rng = np.random.default_rng(ndim)
    shape = (2, 20, 16) if ndim == 3 else (2, 20, 8, 16)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    mask = rng.random((2, 20)) < 0.7
    ref = np.asarray(jrm._masked_instance_norm(jnp.asarray(x), jnp.asarray(mask)))
    out = rm._masked_instance_norm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.abs(out - ref).max() <= TOL


def test_rotation_indicator_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(1, 10, G, 32)).astype(np.float32)
    b = rng.normal(size=(1, 10, G, 32)).astype(np.float32)
    ref = np.asarray(jrm._rotation_indicator(jnp.asarray(a), jnp.asarray(b), jax_group(G).cayley))
    block = rm.CrossAttentionBlock(get_group(G), 16, True)
    from roreg_tpu_torch.models.ops import group_correlation

    out = group_correlation(torch.from_numpy(a), torch.from_numpy(b), block.cayley_t).numpy()
    assert out.shape == ref.shape == (1, 10, G)
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_sinkhorn_and_extract_match_jax():
    """Sinkhorn on masked scores, then match extraction on a coupling with
    tied maxima: the first maximum wins in both."""
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(2, 30, 25)).astype(np.float32) * 4
    mask_m = rng.random((2, 30)) < 0.8
    mask_n = rng.random((2, 25)) < 0.8
    ref = np.asarray(jrm.sinkhorn_log(jnp.asarray(scores), jnp.asarray(0.2, jnp.float32), 100,
                                      jnp.asarray(mask_m), jnp.asarray(mask_n)))
    out = rm.sinkhorn_log(torch.from_numpy(scores), torch.tensor(0.2), 100,
                          torch.from_numpy(mask_m), torch.from_numpy(mask_n)).numpy()
    assert out.dtype == np.float32 and np.abs(out - ref).max() <= TOL
    tied = np.round(ref, 1)
    tied[:, 3, 4] = tied[:, 3, 7] = tied[:, 3].max() + 1.0  # row 3's maximum twice
    args = (tied, mask_m, mask_n)
    m_ref, s_ref = jrm.extract_matches(*map(jnp.asarray, args))
    m_out, s_out = rm.extract_matches(*map(torch.from_numpy, args))
    assert np.array_equal(m_out.numpy(), np.asarray(m_ref))
    assert np.abs(s_out.numpy() - np.asarray(s_ref)).max() <= TOL


@pytest.mark.parametrize("match_n", [0.5, 0.999, 20])
def test_top_match_subset_matches_jax(match_n):
    rng = np.random.default_rng(6)
    scores = np.round(rng.random(100), 1).astype(np.float32)  # many ties
    valid = rng.random(100) < 0.6
    ref = np.asarray(jax_top_match_subset(jnp.asarray(scores), jnp.asarray(valid), match_n, 100))
    out = top_match_subset(torch.from_numpy(scores), torch.from_numpy(valid), match_n).numpy()
    assert np.array_equal(out, ref)
    want = {0.5: int(valid.sum() * 0.5), 0.999: int(valid.sum()), 20: 20}[match_n]
    assert out.sum() == want
