"""BlockResUNet under every batch-norm ResUNet but BN2C, against the JAX
package's.

As tests/test_torch_block_net.py (which holds ResUNetBN2C): one host block
pyramid of two synthetic clouds at block capacities (256, 128, 64, 32),
conv1 kernel 3, JAX variables initialised once per variant with their
batch-norm parameters and statistics perturbed; f32 within the JAX
engine-parity tolerance (atol 2e-4, rtol 1e-3), bf16 within 5e-2 largest
and 2e-3 mean gap. The variants run the block kernels' plain versions at
widths and levels ResUNetBN2C never reaches: conv1 and level 0 at 128
channels (BN2E), up convs of 192 and 256 input channels into 64 or 128,
skip concatenations of unequal widths, and cell-dense layers of 32 outputs
(BN2) or 256 inputs (BN2E). The two widest variants' cases are in
tests/test_torch_block_variants_wide.py, so xdist spreads the JAX
compiles over two workers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.native.blockpyr import alloc_block_buffers_packed_rows, block_tree_slice  # noqa: E402
from roreg_tpu.native.blockpyr import fill_block_pyramid_host  # noqa: E402
from roreg_tpu.sparse.block import BlockResUNet as JaxBlockResUNet  # noqa: E402
from roreg_tpu.sparse.block import unpack_block_payload as jax_unpack  # noqa: E402
from roreg_tpu_torch.sparse.block import BlockResUNet, flatten_block_batch, unpack_block_payload  # noqa: E402
from roreg_tpu_torch.sparse.resunet import ResUNet  # noqa: E402
from roreg_tpu_torch.weights import _leaves, load_variables, unflatten_variables  # noqa: E402
from roreg_tpu_torch.weights import flatten_variables  # noqa: E402

VS = 0.05
BCAPS = (256, 128, 64, 32)
CONV1_K = 3
ATOL, RTOL = 2e-4, 1e-3
# bf16 rounds every conv input to 8 mantissa bits; where the two frameworks'
# f32 sums differ in the last bit a rounding may flip, and flips propagate
# through 21 convs. Outputs are unit vectors.
BF16_MAX_TOL = 5e-2
BF16_MEAN_TOL = 2e-3
NARROW = ("ResUNetBN2", "ResUNetBN2B")


def _cloud(n, seed, extent=1.4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def payload():
    """A chunk payload of two clouds."""
    buf, trees = alloc_block_buffers_packed_rows(BCAPS, 2, 1)
    for i, (n, seed) in enumerate(((1500, 0), (1100, 1))):
        fill_block_pyramid_host(_cloud(n, seed), VS, block_tree_slice(trees[0], i))
    return buf


def _jax_pyramid(slot):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x[slot]), jax_unpack(jnp.asarray(payload()[0]), BCAPS, 2))


@functools.lru_cache(maxsize=None)
def variables(variant):
    """JAX variables of ``variant`` (flat), batch-norm entries perturbed."""
    init = JaxBlockResUNet(variant=variant, conv1_kernel_size=CONV1_K).init(
        jax.random.PRNGKey(0), _jax_pyramid(0), False)
    rng = np.random.default_rng(1)
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, init))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return flat


def _jax_forward(variant, slot, compute_dtype):
    net = JaxBlockResUNet(variant=variant, conv1_kernel_size=CONV1_K, compute_dtype=compute_dtype)
    v = jax.tree_util.tree_map(jnp.asarray, unflatten_variables(variables(variant)))
    return np.asarray(net.apply(v, _jax_pyramid(slot), False))


def _port_forward(variant, slot, compute_dtype):
    net = BlockResUNet(variant, 32, CONV1_K, True, compute_dtype)
    load_variables(net, unflatten_variables(variables(variant)))
    tree = unpack_block_payload(torch.from_numpy(payload()[0].copy()), BCAPS, 2)
    sel = lambda x: x[[slot]] if x.dim() > 1 else x  # noqa: E731
    tree = type(tree)(
        levels=tuple(type(l)(sel(l.occ_words), sel(l.same_tbl)) for l in tree.levels),
        down_tbl=tuple(map(sel, tree.down_tbl)), up_tbl=tuple(map(sel, tree.up_tbl)),
        l0_coords=sel(tree.l0_coords), origin=tree.origin,
    )
    with torch.no_grad():
        return net.eval()(flatten_block_batch(tree, BCAPS)).numpy()


def check_parameter_tree(variant):
    """One set of variables drives both engines: same JAX paths, same shapes."""
    a = {"/".join(p): tuple(t.shape) for t, p, _ in _leaves(BlockResUNet(variant, 32, 7))}
    b = {"/".join(p): tuple(t.shape) for t, p, _ in _leaves(ResUNet(variant, 32, 7))}
    assert a == b and len(a) > 100


def check_f32(variant):
    ref = _jax_forward(variant, 0, None)
    out = _port_forward(variant, 0, None)
    occupied = np.abs(ref).sum(-1) > 0
    assert out.shape == ref.shape == (BCAPS[0] * 64, 32) and occupied.sum() > 500
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert np.allclose(np.linalg.norm(out[occupied], axis=-1), 1.0, atol=1e-5)
    assert not out[~occupied].any()


def check_bf16(variant):
    ref = _jax_forward(variant, 1, "bfloat16")
    out = _port_forward(variant, 1, "bfloat16")
    d = np.abs(out - ref)
    assert d.max() <= BF16_MAX_TOL and d.mean() <= BF16_MEAN_TOL, (d.max(), d.mean())


@pytest.mark.parametrize("variant", ["ResUNetBN2", "ResUNetBN2B", "ResUNetBN2D", "ResUNetBN2E"])
def test_parameter_tree_is_the_gather_resunets(variant):
    check_parameter_tree(variant)


@pytest.mark.parametrize("variant", NARROW)
def test_block_resunet_f32_matches_jax(variant):
    check_f32(variant)


@pytest.mark.parametrize("variant", NARROW)
def test_block_resunet_bf16_matches_jax(variant):
    check_bf16(variant)
