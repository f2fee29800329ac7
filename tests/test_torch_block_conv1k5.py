"""BlockResUNet with the quality weights' conv1 kernel size 5 against the
JAX package's, on converted JAX variables.

The quality configs (``quality_full_config``) run conv1 with kernel 5
through the block engine (its occupancy over a 5^3 neighbourhood,
``sparse/block.py`` ``conv1_occupancy``); tests/test_torch_block_net.py
covers kernel 3. Same set-up and tolerances as that file: f32 within the
JAX engine-parity tolerance, bf16 within the port backbone test's.
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
from roreg_tpu_torch.weights import flatten_variables, load_variables, unflatten_variables  # noqa: E402

VS = 0.05
BCAPS = (256, 128, 64, 32)
K = 5
ATOL, RTOL = 2e-4, 1e-3  # f32, as tests/test_block.py and tests/test_torch_block_net.py
BF16_MAX_TOL, BF16_MEAN_TOL = 5e-2, 2e-3  # bf16, as tests/test_torch_block_net.py


@pytest.fixture(scope="module")
def setup():
    """One cloud's block pyramid, and JAX variables of a kernel-5 net with
    perturbed batch norms."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 1.4, size=(1500, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=1500)
    payload, trees = alloc_block_buffers_packed_rows(BCAPS, 1, 1)
    fill_block_pyramid_host(np.column_stack([xy, z]).astype(np.float32), VS, block_tree_slice(trees[0], 0))
    one = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jax_unpack(jnp.asarray(payload[0]), BCAPS, 1))
    init = JaxBlockResUNet(conv1_kernel_size=K).init(jax.random.PRNGKey(0), one, False)
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, init))
    assert flat["params/conv1/kernel"].shape[0] == K ** 3
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return payload, one, flat


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_block_resunet_conv1_k5_matches_jax(setup, compute_dtype):
    payload, one, flat = setup
    net = JaxBlockResUNet(conv1_kernel_size=K, compute_dtype=compute_dtype)
    ref = np.asarray(net.apply(jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat)), one, False))
    port = BlockResUNet("ResUNetBN2C", 32, K, True, compute_dtype)
    load_variables(port, unflatten_variables(flat))
    pyr = flatten_block_batch(unpack_block_payload(torch.from_numpy(payload[0].copy()), BCAPS, 1), BCAPS)
    with torch.no_grad():
        out = port.eval()(pyr).numpy()
    occupied = np.abs(ref).sum(-1) > 0
    assert out.shape == ref.shape == (BCAPS[0] * 64, 32) and occupied.sum() > 500
    if compute_dtype is None:
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    else:
        d = np.abs(out - ref)
        assert d.max() <= BF16_MAX_TOL and d.mean() <= BF16_MEAN_TOL, (d.max(), d.mean())
