"""The port's block-pyramid payloads (its own voxelhash build) against the
JAX package's native and numpy builders, byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.native import blockpyr as jbp  # noqa: E402
from roreg_tpu.sparse import block as jblock  # noqa: E402
from roreg_tpu_torch.native import blockpyr as tbp  # noqa: E402
from roreg_tpu_torch.sparse.block import unpack_block_payload, unpack_cell_occupancy  # noqa: E402

VS = 0.05
BCAPS = (256, 128, 64, 32)


def _cloud(n=800, seed=0, extent=1.2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.column_stack([xy, z]).astype(np.float32)


def _fill_both(clouds, caps, jax_fill):
    """One chunk payload (batch = len(clouds)) from the port and from the
    JAX package (``jax_fill``: its native dispatcher or its numpy builder);
    -> (port payload, JAX payload, port key rows, JAX key rows, dropped)."""
    b = len(clouds)
    tp, ttrees = tbp.alloc_block_buffers_packed_rows(caps, b, 1)
    jp, jtrees = jbp.alloc_block_buffers_packed_rows(caps, b, 1)
    nk = min(len(c) for c in clouds) // 20
    kt = np.full((b, nk), -2, np.int32)
    kj = np.full((b, nk), -2, np.int32)
    dropped = []
    for i, pts in enumerate(clouds):
        keys = pts[::20][:nk]
        dt = tbp.fill_block_pyramid_host(
            pts, VS, tbp.block_tree_slice(ttrees[0], i), warn_overflow=False, keys=keys, key_rows=kt[i]
        )
        dj = jax_fill(pts, VS, jbp.block_tree_slice(jtrees[0], i), warn_overflow=False, keys=keys, key_rows=kj[i])
        dropped.append((dt, dj))
    return tp, jp, kt, kj, dropped


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_payload_byte_equal(builder):
    """Two rotations in one chunk row: the packed payload is the same bytes,
    field layout and padding included; key rows equal the native builder's
    and agree with the numpy builder's brute force up to distance ties."""
    jax_fill = {"native": jbp.fill_block_pyramid_host, "numpy": jbp.fill_block_pyramid_numpy}[builder]
    clouds = [_cloud(800, 0), _cloud(2500, 3, 2.0)]
    tp, jp, kt, kj, dropped = _fill_both(clouds, BCAPS, jax_fill)
    assert tp.dtype == np.uint8 and tp.shape == jp.shape
    assert tp.tobytes() == jp.tobytes()
    assert all(dt == dj == 0 for dt, dj in dropped)
    assert (kt >= 0).all()
    if builder == "native":
        assert np.array_equal(kt, kj)
    else:
        assert (kt == kj).mean() > 0.97


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_overflow_payload_and_dropped_count(builder, capsys):
    jax_fill = {"native": jbp.fill_block_pyramid_host, "numpy": jbp.fill_block_pyramid_numpy}[builder]
    caps = (16, 8, 8, 8)
    tp, jp, _, _, dropped = _fill_both([_cloud(3000, 1, 3.0)], caps, jax_fill)
    (dt, dj), = dropped
    assert dt == dj and dt > 0
    assert tp.tobytes() == jp.tobytes()
    # the loud message of the port's fill
    tb, trees = tbp.alloc_block_buffers_packed_rows(caps, None, 1)
    assert tbp.fill_block_pyramid_host(_cloud(3000, 1, 3.0), VS, trees[0]) == dt
    assert "exceed level capacities" in capsys.readouterr().err


def test_extent_overflow_is_loud(capfd):
    near = _cloud(300, seed=3)
    pts = np.concatenate([near, near + np.float32(80.0)])
    _, trees = tbp.alloc_block_buffers_packed_rows((512, 256, 128, 64), None, 1)
    assert tbp.fill_block_pyramid_host(pts, VS, trees[0]) > 0
    assert "extent" in capfd.readouterr().err


def test_refill_and_empty_cloud_byte_equal():
    """Buffers refilled with other clouds (the extractor reuses none, but a
    slot must not keep stale state), and an empty cloud."""
    tp, ttrees = tbp.alloc_block_buffers_packed_rows(BCAPS, 2, 1)
    jp, jtrees = jbp.alloc_block_buffers_packed_rows(BCAPS, 2, 1)
    for clouds in ([_cloud(1500, 4), _cloud(900, 5)], [_cloud(400, 6), np.zeros((0, 3), np.float32)]):
        for i, pts in enumerate(clouds):
            tbp.fill_block_pyramid_host(pts, VS, tbp.block_tree_slice(ttrees[0], i))
            jbp.fill_block_pyramid_host(pts, VS, jbp.block_tree_slice(jtrees[0], i))
        assert tp.tobytes() == jp.tobytes()
    assert not ttrees[0].levels[0].occ_words[1].any()


def test_unpack_payload_matches_jax():
    """The device-side unpack gives every field of the JAX unpack (uint32
    occupancy words carried as int32 bits), and the cell occupancy of every
    block, bit 31 included."""
    tp, jp, _, _, _ = _fill_both([_cloud(1200, 7), _cloud(700, 8)], BCAPS, jbp.fill_block_pyramid_host)
    ours = unpack_block_payload(torch.from_numpy(tp[0]), BCAPS, 2)
    ref = jblock.unpack_block_payload(jnp.asarray(jp[0]), BCAPS, batch=2)
    leaves = lambda t: jax.tree_util.tree_leaves(t, is_leaf=lambda x: isinstance(x, torch.Tensor))  # noqa: E731
    for a, b in zip(leaves(ours), leaves(ref)):
        b = np.asarray(b)
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert a.dtype == torch.from_numpy(b.copy()).dtype and np.array_equal(a.numpy(), b)
    words = ours.levels[0].occ_words.reshape(-1, 2)
    assert bool((words < 0).any())  # some block has cell 31 or 63 occupied
    occ = unpack_cell_occupancy(words).numpy()
    ref_occ = np.asarray(jblock.unpack_cell_occupancy(jnp.asarray(np.asarray(ref.levels[0].occ_words).reshape(-1, 2))))
    assert np.array_equal(occ, ref_occ)


def test_cell_occupancy_bit_31():
    words = np.array([[1 << 31, 0], [0, 1 << 31], [0xFFFFFFFF, 1]], np.uint32)
    occ = unpack_cell_occupancy(torch.from_numpy(words.view(np.int32))).numpy()
    ref = np.asarray(jblock.unpack_cell_occupancy(jnp.asarray(words)))
    assert np.array_equal(occ, ref)
    assert occ[0].nonzero()[0].tolist() == [31] and occ[1].nonzero()[0].tolist() == [63]
    assert occ[2].sum() == 33
