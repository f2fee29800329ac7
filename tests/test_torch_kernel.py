"""The gather-conv kernel's contract, held against the JAX package.

The port's plain version (what the wrapper runs for CPU tensors, and what
the CUDA kernel is compared with on the card) must compute what the JAX
``gather_conv`` and the Pallas ``window_gather_conv`` (interpret mode)
compute, on the tables of tests/test_sparse.py: a local table, a source
smaller than the window, and a batch of tables. f32 within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.sparse.conv import gather_conv as jax_gather_conv  # noqa: E402
from roreg_tpu.sparse.window_conv import window_gather_conv  # noqa: E402
from roreg_tpu_torch.kernels.gather_conv import (  # noqa: E402
    conv_work,
    gather_conv,
    gather_conv_kernel,
    gather_conv_plain,
)
from roreg_tpu_torch.sparse.resunet import offset_table  # noqa: E402

TOL = 1e-5


def _local_random_table(rng, n, m, K, band):
    """As tests/test_sparse.py: rows within +-band of a monotone base."""
    base = np.linspace(0, n - 1, m).astype(np.int64)
    nbr = base[:, None] + rng.integers(-band, band, size=(m, K))
    keep = (nbr >= 0) & (nbr < n) & (rng.random((m, K)) > 0.2)
    return np.where(keep, nbr, -1).astype(np.int32)


@pytest.mark.parametrize(
    "n,m,c,cout,band,window",
    [(3000, 2560, 32, 64, 300, 1024), (200, 256, 8, 16, 50, 1024)],
    ids=["local", "n_lt_window"],
)
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int16])
def test_plain_matches_jax(n, m, c, cout, band, window, idx_dtype):
    rng = np.random.default_rng(0)
    K = 27
    feats = rng.normal(size=(n, c)).astype(np.float32)
    nbr = _local_random_table(rng, n, m, K, band)
    w = (rng.normal(size=(K, c, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_gather_conv(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w)))
    ref_win = np.asarray(window_gather_conv(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w),
        window=window, compute_dtype=None, interpret=True,
    ))
    out = gather_conv_plain(
        torch.from_numpy(feats), torch.from_numpy(nbr.astype(idx_dtype)), torch.from_numpy(w)
    ).numpy()
    assert out.dtype == np.float32 and out.shape == (m, cout)
    assert np.abs(out - ref).max() <= TOL
    assert np.abs(out - ref_win).max() <= TOL


def test_plain_matches_jax_batched():
    """The extractor's batching: B tables offset by b*N into one stacked
    source, one call; equals the JAX kernel vmapped over the batch."""
    rng = np.random.default_rng(1)
    B, n, m, K, c, cout = 3, 800, 640, 27, 16, 16
    feats = rng.normal(size=(B, n, c)).astype(np.float32)
    nbr = np.stack([_local_random_table(rng, n, m, K, 100) for _ in range(B)])
    w = (rng.normal(size=(K, c, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(jax.vmap(
        lambda f, t: window_gather_conv(
            f, t, jnp.asarray(w), window=512, compute_dtype=None, interpret=True)
    )(jnp.asarray(feats), jnp.asarray(nbr)))
    table = offset_table(torch.from_numpy(nbr.astype(np.int16)), n)
    assert table.dtype == torch.int32 and table.shape == (B * m, K)
    assert bool(((table >= 0) == torch.from_numpy(nbr.reshape(-1, K) >= 0)).all())
    out = gather_conv_plain(torch.from_numpy(feats.reshape(B * n, c)), table, torch.from_numpy(w))
    assert np.abs(out.numpy().reshape(B, m, cout) - ref).max() <= TOL


def test_plain_matches_jax_bf16():
    """bf16 operands, f32 accumulation, as the backbone runs them."""
    rng = np.random.default_rng(2)
    n, m, K, c, cout = 1000, 768, 27, 32, 32
    feats = rng.normal(size=(n, c)).astype(np.float32)
    nbr = _local_random_table(rng, n, m, K, 200)
    w = (rng.normal(size=(K, c, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_gather_conv(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w), compute_dtype=jnp.bfloat16))
    out = gather_conv_plain(
        torch.from_numpy(feats).bfloat16(), torch.from_numpy(nbr), torch.from_numpy(w).bfloat16()
    )
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= TOL


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing; the kernel's
    own wrapper refuses them."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.normal(size=(50, 32)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(-1, 50, size=(40, 27)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27, 32, 32)).astype(np.float32))
    before = gather_conv_kernel.launches
    assert torch.equal(gather_conv(feats, nbr, w), gather_conv_plain(feats, nbr, w))
    assert gather_conv_kernel.launches == before
    with pytest.raises(ValueError):
        gather_conv_kernel(feats.bfloat16(), nbr, w.bfloat16())


@pytest.mark.parametrize("idx", [torch.int16, torch.int32])
def test_conv_work_counts_what_the_table_uses(idx):
    """Operations count valid entries only; bytes count each referenced
    source row once, the whole table, the weights and the f32 output."""
    nbr = torch.tensor([[0, 2, -1], [2, -1, -1], [-1, -1, -1], [5, 0, 2]], dtype=idx)
    cin, cout = 32, 64
    ops, nbytes = conv_work(nbr, cin, cout)
    assert ops == 2 * 6 * cin * cout
    rows_read = 3  # rows 0, 2 and 5
    table = 4 * 3 * nbr.element_size()
    assert nbytes == rows_read * cin * 2 + table + 3 * cin * cout * 2 + 4 * cout * 4
