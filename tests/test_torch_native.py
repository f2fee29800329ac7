"""The port's host pyramid (its own voxelhash build) against the JAX package's."""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.native import pyramid as jpyr  # noqa: E402
from roreg_tpu_torch.build import BUILD_DIR  # noqa: E402
from roreg_tpu_torch.native import pyramid as tpyr  # noqa: E402

CAPS = (2048, 1024, 512, 256)


def _cloud(rng, n=1500, extent=1.2):
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def _assert_same_bytes(port, ref):
    a = tpyr.pyramid_leaves(port)
    b = jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("k1", [3, 5])
def test_fill_pyramid_host_byte_equal(k1):
    rng = np.random.default_rng(k1)
    pts = _cloud(rng)
    port = tpyr.alloc_pyramid_buffers(CAPS, k1)
    ref = jpyr.alloc_pyramid_buffers(CAPS, k1)
    tpyr.fill_pyramid_host(pts, 0.05, port, conv1_kernel_size=k1)
    jpyr.fill_pyramid_host(pts, 0.05, ref, conv1_kernel_size=k1)
    _assert_same_bytes(port, ref)
    assert port.same[0].dtype == np.int16
    assert int(port.levels[0].num) > 100


def test_batched_slots_and_refill_byte_equal():
    """Batched buffers filled slot by slot, then refilled with other clouds
    (the extractor's double buffering), match the reference's."""
    rng = np.random.default_rng(7)
    port = tpyr.alloc_pyramid_buffers(CAPS, 3, batch=2)
    ref = jpyr.alloc_pyramid_buffers(CAPS, 3, batch=2)
    for _ in range(2):
        for b in range(2):
            pts = _cloud(rng, n=int(rng.integers(500, 2000)))
            tpyr.fill_pyramid_host(pts, 0.05, tpyr.tree_slice(port, b), conv1_kernel_size=3)
            jpyr.fill_pyramid_host(pts, 0.05, jpyr.tree_slice(ref, b), conv1_kernel_size=3)
        _assert_same_bytes(port, ref)


def test_library_built_in_port_build_dir():
    assert os.path.exists(os.path.join(BUILD_DIR, "libvoxelhash.so"))
    assert os.path.dirname(BUILD_DIR).endswith("roreg_tpu_torch")
