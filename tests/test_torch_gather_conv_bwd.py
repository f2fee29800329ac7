"""The gather conv's backward kernels on the CPU: where dgrad's packed
weights sit, the widths each launch runs at, the arguments the wrappers
refuse, and a plain-PyTorch model of the kernels' arithmetic against the
JAX package's f32 gradient.

The kernels (``csrc/gather_conv_bwd.cu``) multiply on the tensor cores,
which take bf16 operands, while dY is f32: each dY value is split into
three bf16 terms (``split_bf16x3`` below, a copy of ``csrc/hopper.cuh``'s)
whose products with the bf16 X or W are summed in f32. The model here computes exactly that at phase 3d's
magnitudes (bf16 X and dY of unit scale, about 7000 valid rows an offset,
dW entries of tens to hundreds) but a small size, and shows why three terms: one
bf16 term of dY misses ``BWD_ATOL``. The kernels themselves run in
``tests/test_torch_cuda_kernels.py`` on the card and in ``chip_smoke.py``
phase 3d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.sparse.conv import gather_conv as jax_gather_conv  # noqa: E402
from roreg_tpu_torch.kernels.gather_conv import (  # noqa: E402
    DGRAD_CI_TILE,
    DGRAD_CINS,
    bwd_kernel_widths,
    gather_conv_dgrad_kernel,
    gather_conv_wgrad_kernel,
    pack_dgrad_weights,
)

# chip_smoke.py phase 3d's tolerance: f32 sums in another order, outputs up
# to about 100
BWD_ATOL = 1e-2


def split_bf16x3(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 entries' split of dY into three bf16 terms (``csrc/hopper.cuh``
    ``split_bf16x3``): ``hi = bf16(t)``, ``mid = bf16(t - hi)``, ``lo =
    bf16(t - hi - mid)``, each difference exact in f32, so ``hi + mid +
    lo`` is within ``2**-24 * |t|`` of ``t`` and the three products with a
    bf16 operand, summed in f32, keep f32's precision."""
    t = t.float()
    hi = t.bfloat16()
    r = t - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def _stage_element(k, n):
    """Element offset of (k, n) inside a packed 16-row stage: byte
    (n/8)*256 + (k/8)*128 + (n%8)*16 + (k%8)*2, wgmma's K-major layout that
    csrc/hopper.cuh b_desc names."""
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


@pytest.mark.parametrize("cin,cout,kvol", [(32, 32, 27), (64, 128, 27), (256, 256, 3), (48, 24, 5),
                                           (16, 16, 40)])
def test_dgrad_weights_sit_where_the_kernel_reads_them(cin, cout, kvol):
    """dgrad's producer warp, for channel tile t of T = min(Cin_p, 128)
    channels, reads slot c (output channels 32c .. 32c + 31) of offset k at
    ((k * Cin_p/T + t) * Cout_p/16 + 2c) * 16 * T elements of the packed
    w^T, its second 16 rows 16 * T elements on; element (k', n) of a 16-row
    stage s is w[k, T t + n, 16 s + k'] (B = w[k]^T: K = Cout, N = the
    channel tile), zero in the padding."""
    w = torch.arange(1, kvol * cin * cout + 1, dtype=torch.int32).view(kvol, cin, cout)
    cin_p = next(c for c in DGRAD_CINS if c >= cin)
    cout_p = -(-cout // 32) * 32
    tile = min(cin_p, DGRAD_CI_TILE)
    flat = pack_dgrad_weights(w).reshape(-1)
    assert flat.numel() == kvol * cin_p * cout_p
    k, t, s, kk, n = np.meshgrid(np.arange(kvol), np.arange(cin_p // tile), np.arange(cout_p // 16),
                                 np.arange(16), np.arange(tile), indexing="ij")
    where = ((k * (cin_p // tile) + t) * (cout_p // 16) + s) * 16 * tile + _stage_element(kk, n)
    where = torch.from_numpy(where.reshape(-1))
    co, ci, k = (torch.from_numpy(a.reshape(-1)) for a in (16 * s + kk, tile * t + n, k))
    inside = (co < cout) & (ci < cin)
    got = flat[where]
    assert torch.equal(got[inside], w[k[inside], ci[inside], co[inside]])
    assert not bool(got[~inside].any())


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 1e4])
def test_split_bf16x3_reconstructs_f32(scale):
    """hi + mid + lo is within 2^-24 of each f32 value (relative), exactly
    for zeros, and hi is the bf16 rounding of the value."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy((rng.normal(size=20000) * scale).astype(np.float32))
    t[:10] = 0.0
    hi, mid, lo = split_bf16x3(t)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, t.bfloat16())
    back = hi.double() + mid.double() + lo.double()
    assert bool(((back - t.double()).abs() <= 2.0 ** -24 * t.double().abs()).all())
    assert not bool(back[:10].any())


def _phase_3d_inputs(seed: int = 0):
    """A table, bf16 X and W and f32 dY at phase 3d's magnitudes: unit-scale
    X and dY, He-scaled W, 12000 rows with 60 % of the entries valid."""
    rng = np.random.default_rng(seed)
    n, m, kvol, cin, cout = 12000, 12000, 27, 32, 32
    nbr = rng.integers(0, n, size=(m, kvol))
    nbr[rng.random((m, kvol)) < 0.4] = -1
    x = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(kvol, cin, cout)) * (2 / (kvol * cin)) ** 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(m, cout)).astype(np.float32))
    return torch.from_numpy(nbr.astype(np.int32)), x, w.bfloat16(), dy


def _kernel_model(x, nbr, w, terms):
    """The kernels' arithmetic in plain PyTorch: each bf16 term of dY
    multiplied by the bf16 W (dgrad, scattered to the rows the table names)
    or the gathered bf16 X (wgrad), every product summed in f32."""
    idx = nbr.long()
    valid = (idx >= 0).float()
    g = x.float()[idx.clamp_min(0)] * valid[..., None]  # (M, K, Cin)
    dx = torch.zeros(x.shape, dtype=torch.float32)
    dw = torch.zeros(w.shape, dtype=torch.float32)
    for t in terms:
        t = t.float()
        dw += torch.einsum("mkc,mo->kco", g, t)
        prod = torch.einsum("mo,kco->mkc", t, w.float()) * valid[..., None]
        dx.index_add_(0, idx.clamp_min(0).reshape(-1), prod.reshape(-1, x.shape[1]))
    return dx, dw


def _jax_gradients(x, nbr, w, dy):
    """dX and dW of the JAX package's gather_conv in f32 (XLA's transpose
    of the gather and of the dot)."""
    def f(xj, wj):
        return jnp.sum(jax_gather_conv(xj, jnp.asarray(nbr.numpy()), wj) * jnp.asarray(dy.numpy()))
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x.float().numpy()), jnp.asarray(w.float().numpy()))
    return torch.from_numpy(np.array(gx)), torch.from_numpy(np.array(gw))


def test_three_bf16_terms_hold_the_tolerance_where_one_does_not():
    """At phase 3d's magnitudes the three-term contraction is within
    BWD_ATOL of the JAX package's f32 gradients (dX and dW), and dY
    rounded once to bf16 is not: its dW misses by tens of times the
    tolerance. This is why the kernels carry three terms."""
    nbr, x, w, dy = _phase_3d_inputs()
    want_dx, want_dw = _jax_gradients(x, nbr, w, dy)
    assert float(want_dw.abs().max()) > 50.0  # the magnitudes of phase 3d's level-0 wgrad
    dx, dw = _kernel_model(x, nbr, w, split_bf16x3(dy))
    assert float((dx - want_dx).abs().max()) <= BWD_ATOL
    assert float((dw - want_dw).abs().max()) <= BWD_ATOL
    _, dw_one = _kernel_model(x, nbr, w, [dy.bfloat16()])
    assert float((dw_one - want_dw).abs().max()) > 10 * BWD_ATOL


@pytest.mark.parametrize("which,cin,cout,want", [
    ("dgrad", 32, 32, (32, 32)), ("dgrad", 256, 256, (256, 256)), ("dgrad", 16, 16, (32, 16)),
    ("dgrad", 48, 24, (64, 24)), ("dgrad", 100, 7, (128, 8)),
    ("wgrad", 32, 32, (32, 32)), ("wgrad", 48, 24, (48, 24)), ("wgrad", 3, 7, (8, 7)),
])
def test_bwd_kernel_widths(which, cin, cout, want):
    """dgrad runs at Cin of DGRAD_CINS and Cout a multiple of 4; wgrad at
    Cin a multiple of 8 and any Cout; the phase 3d shapes run unpadded."""
    assert bwd_kernel_widths(which, cin, cout) == want


@pytest.mark.parametrize("kernel", [gather_conv_dgrad_kernel, gather_conv_wgrad_kernel])
def test_bwd_kernels_refuse_bad_arguments_before_touching_a_device(kernel):
    """The wrappers check types, shapes and widths before they build,
    load or launch anything, and refuse tensors off the card."""
    feats = torch.zeros(10, 32, dtype=torch.bfloat16)
    nbr = torch.zeros(8, 27, dtype=torch.int32)
    w = torch.zeros(27, 32, 64, dtype=torch.bfloat16)
    dy = torch.zeros(8, 64)
    with pytest.raises(TypeError, match="f32 gradient"):
        kernel(feats, nbr, w, dy.bfloat16())
    with pytest.raises(ValueError, match="shape mismatch"):
        kernel(feats, nbr, w[:9], dy)
    wide = torch.zeros(10, 300, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 <= Cin, Cout <= 256"):
        kernel(wide, nbr, torch.zeros(27, 300, 64, dtype=torch.bfloat16), dy)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernel(feats, nbr, w, dy)
    assert kernel.launches == 0
