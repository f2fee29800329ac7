"""BlockResUNet against the JAX package's, on converted JAX variables.

The JAX BlockResUNet is initialised once for the module; its batch-norm
parameters and statistics are perturbed so the mapping is exercised. Both
nets run one host block pyramid: f32 within the JAX engine-parity tolerance
(atol 2e-4, rtol 1e-3, tests/test_block.py), bf16 within the port
backbone test's tolerance.
"""

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
from roreg_tpu_torch.weights import _leaves, flatten_variables, load_variables, unflatten_variables  # noqa: E402

VS = 0.05
BCAPS = (256, 128, 64, 32)
ATOL, RTOL = 2e-4, 1e-3
# bf16 rounds every conv input to 8 mantissa bits; where the two frameworks'
# f32 sums differ in the last bit a rounding may flip, and flips propagate
# through 21 convs. Outputs are unit vectors.
BF16_MAX_TOL = 5e-2
BF16_MEAN_TOL = 2e-3


def _cloud(n, seed, extent=1.4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """A chunk payload of two clouds, and perturbed JAX variables."""
    payload, trees = alloc_block_buffers_packed_rows(BCAPS, 2, 1)
    for i, (n, seed) in enumerate(((1500, 0), (1100, 1))):
        fill_block_pyramid_host(_cloud(n, seed), VS, block_tree_slice(trees[0], i))
    one = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jax_unpack(jnp.asarray(payload[0]), BCAPS, 2))
    init = JaxBlockResUNet(conv1_kernel_size=3).init(jax.random.PRNGKey(0), one, False)
    rng = np.random.default_rng(1)
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, init))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return payload, flat


def _jax_forward(flat, payload, slot, compute_dtype):
    pyr = jax.tree_util.tree_map(lambda x: jnp.asarray(x[slot]), jax_unpack(jnp.asarray(payload[0]), BCAPS, 2))
    net = JaxBlockResUNet(conv1_kernel_size=3, compute_dtype=compute_dtype)
    v = jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))
    return np.asarray(net.apply(v, pyr, False))


def _port(flat, compute_dtype):
    net = BlockResUNet("ResUNetBN2C", 32, 3, True, compute_dtype)
    load_variables(net, unflatten_variables(flat))
    return net.eval()


def _pyramid(payload, slots):
    """The chunk payload's rotations ``slots`` as one batched pyramid."""
    tree = unpack_block_payload(torch.from_numpy(payload[0].copy()), BCAPS, 2)
    sel = lambda x: x[slots] if x.dim() > 1 else x  # noqa: E731
    tree = type(tree)(
        levels=tuple(type(l)(sel(l.occ_words), sel(l.same_tbl)) for l in tree.levels),
        down_tbl=tuple(map(sel, tree.down_tbl)), up_tbl=tuple(map(sel, tree.up_tbl)),
        l0_coords=sel(tree.l0_coords), origin=tree.origin,
    )
    return flatten_block_batch(tree, BCAPS)


def test_parameter_tree_is_the_gather_resunets():
    """One set of variables drives both engines: same JAX paths, same shapes."""
    a = {"/".join(p): tuple(t.shape) for t, p, _ in _leaves(BlockResUNet("ResUNetBN2C", 32, 7))}
    b = {"/".join(p): tuple(t.shape) for t, p, _ in _leaves(ResUNet("ResUNetBN2C", 32, 7))}
    assert a == b and len(a) > 100


def test_block_resunet_f32_matches_jax(setup):
    payload, flat = setup
    ref = _jax_forward(flat, payload, 0, None)
    with torch.no_grad():
        out = _port(flat, None)(_pyramid(payload, [0])).numpy()
    occupied = np.abs(ref).sum(-1) > 0
    assert out.shape == ref.shape == (BCAPS[0] * 64, 32) and occupied.sum() > 500
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert np.allclose(np.linalg.norm(out[occupied], axis=-1), 1.0, atol=1e-5)


def test_block_resunet_batched_equals_single(setup):
    """Two rotations stacked into one forward (the extractor's chunking)
    give each rotation's own features."""
    payload, flat = setup
    net = _port(flat, None)
    with torch.no_grad():
        both = net(_pyramid(payload, [0, 1])).numpy().reshape(2, BCAPS[0] * 64, 32)
        for b in range(2):
            assert np.abs(both[b] - net(_pyramid(payload, [b])).numpy()).max() <= 1e-5


def test_block_resunet_bf16_matches_jax(setup):
    payload, flat = setup
    ref = _jax_forward(flat, payload, 1, "bfloat16")
    with torch.no_grad():
        out = _port(flat, "bfloat16")(_pyramid(payload, [1])).numpy()
    d = np.abs(out - ref)
    assert d.max() <= BF16_MAX_TOL and d.mean() <= BF16_MEAN_TOL, (d.max(), d.mean())
