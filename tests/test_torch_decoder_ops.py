"""The plain versions of the block decoder's three kernels against the JAX
functions they replace, at small shapes: ``up_conv`` after the region
gather against ``conv_up``, ``cell_dense`` against flax ``nn.Dense`` (two
K-slices, bias, ReLU), ``skip_concat`` against ``jnp.concatenate`` and the
bf16 cast (bit-exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import roreg_tpu.sparse.block as jblock  # noqa: E402
from roreg_tpu.native.blockpyr import build_block_pyramid_host  # noqa: E402
from roreg_tpu_torch.kernels.block_gather import block_gather_plain  # noqa: E402
from roreg_tpu_torch.kernels.cell_dense import cell_dense_plain  # noqa: E402
from roreg_tpu_torch.kernels.skip_concat import skip_concat_plain  # noqa: E402
from roreg_tpu_torch.kernels.up_conv import up_conv_plain  # noqa: E402

TOL = 1e-4


def _cloud(n=1200, seed=0, extent=1.4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.mark.parametrize("level,cin,cout,dtype", [(0, 32, 32, None), (1, 64, 32, "bfloat16")])
def test_up_conv_plain_matches_jax_conv_up(level, cin, cout, dtype):
    """The region gather (block_gather) then up_conv equals JAX conv_up on
    the tables of a real block pyramid."""
    p = build_block_pyramid_host(_cloud(), 0.05, (256, 128, 64, 32))
    occ = [np.array(jblock.unpack_cell_occupancy(jnp.asarray(lv.occ_words))) for lv in p.levels]
    rng = np.random.default_rng(level)
    fc = rng.normal(size=(len(occ[level + 1]), 64, cin)).astype(np.float32) * occ[level + 1][..., None]
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    tbl, mask = p.up_tbl[level], occ[level]
    jd = None if dtype is None else jnp.dtype(dtype)
    ref = np.asarray(jblock.conv_up(jnp.asarray(fc), jnp.asarray(tbl), jnp.asarray(w), jnp.asarray(mask),
                                    compute_dtype=jd))
    fct, wt = torch.from_numpy(fc), torch.from_numpy(w)
    if dtype is not None:
        fct, wt = fct.bfloat16(), wt.bfloat16()
    reg = block_gather_plain(fct.reshape(-1, cin), torch.from_numpy(tbl))
    out = up_conv_plain(reg, wt, torch.from_numpy(mask)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == (len(mask), 64, cout)
    assert mask.sum() > 100
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("cb,bias,relu", [(32, False, True), (0, True, False)], ids=["conv1_tr", "final"])
def test_cell_dense_plain_matches_flax_dense(cb, bias, relu):
    rng = np.random.default_rng(cb)
    a = rng.normal(size=(6, 64, 64)).astype(np.float32)
    b = rng.normal(size=(6, 64, cb)).astype(np.float32)
    x = np.concatenate([a, b], -1)
    dense = nn.Dense(48, use_bias=bias)
    v = jax.tree_util.tree_map(np.asarray, dense.init(jax.random.PRNGKey(cb), jnp.asarray(x)))
    if bias:
        v["params"]["bias"] = rng.normal(size=48).astype(np.float32)
    ref = dense.apply(v, jnp.asarray(x))
    ref = np.asarray(nn.relu(ref) if relu else ref)
    weight = torch.from_numpy(v["params"]["kernel"].T.copy())
    out = cell_dense_plain(torch.from_numpy(a), torch.from_numpy(b) if cb else None, weight,
                           torch.from_numpy(v["params"]["bias"]) if bias else None, relu).numpy()
    assert out.dtype == np.float32 and np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("cb,n,bias,relu", [(32, 64, False, True), (0, 32, True, False)],
                         ids=["conv1_tr", "final"])
def test_masked_cell_dense_plain_matches_flax_dense_then_mask(cb, n, bias, relu):
    """With the level-0 cell mask, the plain version equals flax nn.Dense
    followed by jnp.where(mask): the JAX package's layer and its final mask
    (roreg_tpu/sparse/block.py:679-684), at the decoder's widths."""
    rng = np.random.default_rng(10 + cb)
    a = rng.normal(size=(7, 64, 64)).astype(np.float32)
    b = rng.normal(size=(7, 64, cb)).astype(np.float32)
    mask = rng.random((7, 64)) < 0.3
    mask[2] = False  # a padding block
    x = np.concatenate([a, b], -1)
    dense = nn.Dense(n, use_bias=bias)
    v = jax.tree_util.tree_map(np.asarray, dense.init(jax.random.PRNGKey(cb), jnp.asarray(x)))
    if bias:
        v["params"]["bias"] = rng.normal(size=n).astype(np.float32)
    ref = dense.apply(v, jnp.asarray(x))
    ref = nn.relu(ref) if relu else ref
    ref = np.asarray(jnp.where(jnp.asarray(mask)[..., None], ref, 0.0))
    weight = torch.from_numpy(v["params"]["kernel"].T.copy())
    out = cell_dense_plain(torch.from_numpy(a), torch.from_numpy(b) if cb else None, weight,
                           torch.from_numpy(v["params"]["bias"]) if bias else None, relu,
                           torch.from_numpy(mask)).numpy()
    assert out.dtype == np.float32 and out.shape == (7, 64, n)
    assert np.abs(out - ref).max() <= TOL
    assert not out[~mask].any()


def test_skip_concat_plain_matches_jax_concat_cast():
    rng = np.random.default_rng(7)
    a = (rng.normal(size=(9, 64, 32)) * 10).astype(np.float32)
    b = (rng.normal(size=(9, 64, 16)) * 1e-3).astype(np.float32)
    ref = np.asarray(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], -1).astype(jnp.bfloat16))
    out = skip_concat_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.view(torch.int16).numpy(), ref.view(np.int16))
