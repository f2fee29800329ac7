"""Weights conversion and the ResUNet backbone against the JAX package.

JAX init variables (with their batch-norm parameters and statistics
perturbed, so the mapping is exercised) are converted into the port's
ResUNet; both run on one host pyramid. f32 (``compute_dtype=None``) within
1e-4; bf16 within a looser stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.native.pyramid import build_pyramid_host  # noqa: E402
from roreg_tpu.sparse.resunet import ResUNet as JaxResUNet  # noqa: E402
from roreg_tpu_torch.sparse.resunet import ResUNet, flatten_batch  # noqa: E402
from roreg_tpu_torch.weights import export_variables, flatten_variables, load_variables  # noqa: E402

CAPS = (2048, 1024, 512, 256)
VS = 0.05
F32_TOL = 1e-4
# bf16 rounds every conv input to 8 mantissa bits; where the two frameworks'
# f32 sums differ in the last bit a rounding may flip, and flips propagate
# through 20 convs. Outputs are unit vectors.
BF16_MAX_TOL = 5e-2
BF16_MEAN_TOL = 2e-3


def _cloud(seed, n=1500, extent=1.4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def _perturb(variables, seed):
    """Random batch-norm scales, biases and statistics (init has 1/0)."""
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, variables))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return flat


def _unflatten(flat):
    from roreg_tpu_torch.weights import unflatten_variables

    return unflatten_variables(flat)


def _torch_pyramid(pyrs):
    """Stack host pyramids (numpy) into one batched DevicePyramid."""
    st = lambda f: torch.from_numpy(np.stack([f(p) for p in pyrs]))  # noqa: E731
    return flatten_batch(
        [st(lambda p, l=l: p.levels[l].mask) for l in range(4)],
        st(lambda p: p.conv1_occ.view(np.int32)),
        [st(lambda p, l=l: p.same[l]) for l in range(4)],
        [st(lambda p, l=l: p.down[l]) for l in range(3)],
        [st(lambda p, l=l: p.up[l]) for l in range(3)],
    )


@pytest.fixture(scope="module")
def setup():
    pyrs = [build_pyramid_host(_cloud(s), VS, CAPS, conv1_kernel_size=3) for s in (0, 1)]
    net = JaxResUNet(variant="ResUNetBN2C", conv1_kernel_size=3)
    jpyr = jax.tree_util.tree_map(jnp.asarray, pyrs[0])
    init = net.init(jax.random.PRNGKey(0), jnp.ones((CAPS[0], 1)), jpyr, False)
    return pyrs, _perturb(init, 1)


def _jax_forward(flat, pyr, compute_dtype):
    net = JaxResUNet(variant="ResUNetBN2C", conv1_kernel_size=3, compute_dtype=compute_dtype)
    v = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    return np.asarray(net.apply(v, jnp.ones((CAPS[0], 1)), jax.tree_util.tree_map(jnp.asarray, pyr), False))


def _port(flat, compute_dtype):
    net = ResUNet("ResUNetBN2C", 32, 3, True, compute_dtype)
    load_variables(net, _unflatten(flat))
    return net.eval()


def test_weights_round_trip(setup):
    _, flat = setup
    net = _port(flat, None)
    back = flatten_variables(export_variables(net))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype and np.array_equal(back[k], flat[k]), k
    # flax Dense (in, out) -> Linear.weight (out, in); sparse kernels as they are
    assert torch.equal(net.final.weight, torch.from_numpy(np.array(flat["params/final/kernel"].T)))
    assert tuple(net.block1.conv1.kernel.shape) == (27, 32, 32)


def test_resunet_f32_matches_jax(setup):
    pyrs, flat = setup
    ref = _jax_forward(flat, pyrs[0], None)
    with torch.no_grad():
        out = _port(flat, None)(_torch_pyramid(pyrs[:1])).numpy()
    mask = pyrs[0].levels[0].mask
    assert mask.sum() > 200
    assert np.abs(out - ref).max() <= F32_TOL
    assert np.allclose(np.linalg.norm(out[mask], axis=-1), 1.0, atol=1e-5)


def test_resunet_batched_equals_single(setup):
    """Two rotations stacked into one forward (the extractor's chunking)
    give each rotation's own features."""
    pyrs, flat = setup
    net = _port(flat, None)
    with torch.no_grad():
        both = net(_torch_pyramid(pyrs)).numpy().reshape(2, CAPS[0], 32)
        for b in range(2):
            one = net(_torch_pyramid(pyrs[b:b + 1])).numpy()
            assert np.abs(both[b] - one).max() <= 1e-5


def test_resunet_bf16_matches_jax(setup):
    pyrs, flat = setup
    ref = _jax_forward(flat, pyrs[1], "bfloat16")
    with torch.no_grad():
        out = _port(flat, "bfloat16")(_torch_pyramid(pyrs[1:])).numpy()
    d = np.abs(out - ref)
    assert d.max() <= BF16_MAX_TOL and d.mean() <= BF16_MEAN_TOL, (d.max(), d.mean())
