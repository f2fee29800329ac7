"""The block engine's ops against the JAX package's, on the tables of real
block pyramids: the gathers exactly, the convs in f32 within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import roreg_tpu.sparse.block as jblock  # noqa: E402
from roreg_tpu.native.blockpyr import build_block_pyramid_host  # noqa: E402
from roreg_tpu_torch.kernels.block_gather import block_gather_plain  # noqa: E402
from roreg_tpu_torch.kernels.halo_conv import halo_conv_plain, halo_maps  # noqa: E402
from roreg_tpu_torch.kernels.up_conv import UP_CELL_INV, UP_CLASSES  # noqa: E402
from roreg_tpu_torch.sparse import block as tblock  # noqa: E402

VS = 0.05
BCAPS = (256, 128, 64, 32)
TOL = 1e-4


def _cloud(n=1500, seed=0, extent=1.6):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.fixture(scope="module")
def pyr():
    """A host block pyramid (numpy) and its per-level cell masks."""
    p = build_block_pyramid_host(_cloud(), VS, BCAPS)
    occ = [np.asarray(jblock.unpack_cell_occupancy(jnp.asarray(l.occ_words))) for l in p.levels]
    assert occ[0].sum() > 500 and occ[3].sum() > 10
    return p, occ


def _feats(rng, n, c, occ=None):
    f = rng.normal(size=(n, 64, c)).astype(np.float32)
    return f if occ is None else f * occ[..., None]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_block_gather_equals_the_scripts_oracle():
    """gather_p's own oracle: ``jnp.take(feats.reshape(B, W), tbl.reshape(B, 27), axis=0)``
    on a table without -1 (scripts/experiment_pallas_gather.py:78)."""
    rng = np.random.default_rng(0)
    b, c = 40, 8
    feats = rng.standard_normal((b * 16, 64 * c // 16)).astype(np.float32)
    tbl = rng.integers(0, b, size=(b * 27,)).astype(np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(feats).reshape(b, 64 * c), jnp.asarray(tbl).reshape(b, 27), axis=0))
    out = block_gather_plain(_t(feats).reshape(b, 64 * c), _t(tbl).reshape(b, 27))
    assert np.array_equal(out.numpy(), ref)


def test_block_gather_equals_jax_conv_gathers(pyr):
    """The two gathers of the JAX block engine, with -1 entries: conv1's
    neighbour occupancy and conv_up's coarse region."""
    p, occ = pyr
    rng = np.random.default_rng(1)
    tbl = p.levels[0].same_tbl
    occ_f = occ[0].astype(np.float32)
    ref = jnp.take(jnp.asarray(occ_f), jnp.clip(jnp.asarray(tbl), 0).astype(jnp.int32), axis=0)
    ref = jnp.where((jnp.asarray(tbl) >= 0)[..., None], ref, 0)
    assert np.array_equal(block_gather_plain(_t(occ_f), _t(tbl)).numpy(), np.asarray(ref))

    up = p.up_tbl[1]
    fc = _feats(rng, BCAPS[2], 16, occ[2]).reshape(-1, 16)
    ref = jnp.take(jnp.asarray(fc), jnp.clip(jnp.asarray(up), 0).astype(jnp.int32), axis=0)
    ref = jnp.where((jnp.asarray(up) >= 0)[..., None], ref, 0)
    assert (up < 0).any() and (up >= 0).any()
    assert np.array_equal(block_gather_plain(_t(fc), _t(up)).numpy(), np.asarray(ref))


def test_halo_maps_equal_jax():
    for ks, scale in ((3, 1), (3, 2), (5, 1), (7, 1)):
        for a, b in zip(halo_maps(ks, scale), jblock._halo_maps(ks, scale)):
            assert np.array_equal(a, b)
    for (c, w, r), (jc, jw, jr) in zip(UP_CLASSES, jblock._UP_CLASSES):
        assert np.array_equal(c, jc) and np.array_equal(w, jw) and np.array_equal(r, jr)
    assert np.array_equal(UP_CELL_INV, jblock._UP_CELL_INV)
    assert np.array_equal(tblock._conv1_dense_map(3), jblock._conv1_dense_map(3))


@pytest.mark.parametrize("kind,level,cin,cout", [
    ("same", 0, 32, 32), ("same", 2, 16, 64), ("down", 0, 32, 64), ("down", 2, 32, 32),
])
def test_halo_conv_plain_matches_jax(pyr, kind, level, cin, cout):
    """halo_conv's plain version against JAX conv_same / conv_down, f32."""
    p, occ = pyr
    rng = np.random.default_rng(level + cin)
    if kind == "same":
        src_occ, tbl, mask = occ[level], p.levels[level].same_tbl, occ[level]
        fn, span, stride = jblock.conv_same, 6, 1
    else:
        src_occ, tbl, mask = occ[level], p.down_tbl[level], occ[level + 1]
        fn, span, stride = jblock.conv_down, 9, 2
    feats = _feats(rng, len(src_occ), cin, src_occ)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(fn(jnp.asarray(feats), jnp.asarray(tbl), jnp.asarray(w), jnp.asarray(mask)))
    out = halo_conv_plain(_t(feats), _t(tbl), _t(w), _t(mask), span, stride).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == (len(mask), 64, cout)
    assert np.abs(out - ref).max() <= TOL
    # the port's conv wrappers are the same function
    port = {"same": tblock.conv_same, "down": tblock.conv_down}[kind]
    assert np.array_equal(port(_t(feats), _t(tbl), _t(w), _t(mask)).numpy(), out)


def test_halo_conv_bf16_matches_jax(pyr):
    """bf16 operands, f32 accumulation, as the backbone runs them: bf16
    products are exact in f32, so only the summation order differs."""
    p, occ = pyr
    rng = np.random.default_rng(5)
    feats = _feats(rng, BCAPS[1], 32, occ[1])
    w = (rng.normal(size=(27, 32, 32)) * 0.1).astype(np.float32)
    args = (p.levels[1].same_tbl, w, occ[1])
    ref = np.asarray(jblock.conv_same(jnp.asarray(feats), *map(jnp.asarray, args), compute_dtype=jnp.bfloat16))
    out = tblock.conv_same(_t(feats), *map(_t, args), compute_dtype=torch.bfloat16).numpy()
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("ks,dtype", [(3, None), (7, None), (5, "bfloat16")])
def test_conv1_occupancy_matches_jax(pyr, ks, dtype):
    p, occ = pyr
    rng = np.random.default_rng(ks)
    w = rng.normal(size=(ks**3, 1, 32)).astype(np.float32)
    args = (occ[0], p.levels[0].same_tbl, w, occ[0])
    jd = None if dtype is None else jnp.dtype(dtype)
    td = None if dtype is None else getattr(torch, dtype)
    ref = np.asarray(jblock.conv1_occupancy(*map(jnp.asarray, args), kernel_size=ks, compute_dtype=jd))
    out = tblock.conv1_occupancy(*map(_t, args), kernel_size=ks, compute_dtype=td).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("level,cin,cout,dtype", [(0, 48, 32, None), (2, 32, 16, None), (1, 32, 32, "bfloat16")])
def test_conv_up_matches_jax(pyr, level, cin, cout, dtype):
    p, occ = pyr
    rng = np.random.default_rng(level + 10)
    fc = _feats(rng, len(occ[level + 1]), cin, occ[level + 1])
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    args = (fc, p.up_tbl[level], w, occ[level])
    jd = None if dtype is None else jnp.dtype(dtype)
    td = None if dtype is None else getattr(torch, dtype)
    ref = np.asarray(jblock.conv_up(*map(jnp.asarray, args), compute_dtype=jd))
    out = tblock.conv_up(*map(_t, args), compute_dtype=td).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL
