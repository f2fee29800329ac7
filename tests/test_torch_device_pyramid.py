"""Device-built pyramids (``host_maps=False``) against the JAX package.

The port's ``voxelize`` and ``build_pyramid`` (tensors) against the JAX
package's, every leaf bit-equal on the same points: a capacity overflow,
points outside the 1024-voxel extent, an empty mask, and bit 31 of the
first conv's occupancy words; the device build against the port's own
host build (the port's copy of ``tests/test_native_pyramid.py``); then
``extract_group_features`` and ``register_pair`` with ``host_maps=False``
against the JAX package's, both in f32 with the same converted variables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.pipeline.config import PipelineConfig as JConfig  # noqa: E402
from roreg_tpu.pipeline.registration import RegistrationPipeline as JPipe  # noqa: E402
from roreg_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid  # noqa: E402
from roreg_tpu.sparse.voxelize import voxelize as jax_voxelize  # noqa: E402
from roreg_tpu_torch.core.group import get_group  # noqa: E402
from roreg_tpu_torch.data.synthetic import synthetic_pair  # noqa: E402
from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host, host_to_voxel  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.pipeline.registration import RegistrationPipeline  # noqa: E402
from roreg_tpu_torch.sparse.kernel_map import build_pyramid  # noqa: E402
from roreg_tpu_torch.sparse.voxelize import voxelize  # noqa: E402

SMALL = dict(
    voxel_size=0.05, group_size=12, capacities=(2048, 1024, 512, 256), conv1_kernel_size=3,
    group_chunk=4, num_keypoints=128, keynum=64, max_iter=48, bs_gf=48, bs_et=48, engine="gather",
    host_maps=False, use_rm=False, backbone_compute_dtype=None, ransac_ird=0.5,
)
# f32 describes of the same pyramids: the two frameworks' f32 sums differ
# in order only (convs of <= 27 x 256 terms, unit-norm outputs)
FEAT_TOL = 1e-4
# the pair stage on those descriptors, as tests/test_torch_slice.py holds it
T_TOL = 1e-4


def _leaves(tree) -> list[np.ndarray]:
    """A pyramid's or grid's leaves in the reference's order, as numpy
    (the reference's uint32 occupancy words as int32 bits)."""
    out = []
    for x in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out.append(a.view(np.int32) if a.dtype == np.uint32 else a)
    return out


def _assert_bit_equal(port, ref):
    a, b = _leaves(port), _leaves(ref)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype, y.dtype, x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), f"leaf {i} differs"


def _surface(rng, n, extent=1.6):
    xy = rng.uniform(0, extent, size=(n, 2))
    z = 0.3 * np.sin(xy[:, 0] * 4) * np.cos(xy[:, 1] * 3) + 0.02 * rng.normal(size=n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def _face_points(rng, n, vs):
    """Points on voxel faces ``k * vs`` (f32, k != 0: the neighbours of 0
    are denormals, which XLA on the CPU flushes to zero) and one ulp to
    either side of them, in every axis: some quantize to another voxel
    under ``p * (1 / vs)`` than under the reference's ``p / vs``."""
    k = rng.integers(1, 200, size=(n, 3)) * rng.choice([-1, 1], size=(n, 3))
    faces = k.astype(np.float32) * np.float32(vs)
    side = rng.integers(-1, 2, size=(n, 3))
    pts = np.where(side < 0, np.nextafter(faces, np.float32(-np.inf)),
                   np.where(side > 0, np.nextafter(faces, np.float32(np.inf)), faces))
    return pts.astype(np.float32)


def _voxel_cases():
    rng = np.random.default_rng(0)
    faces = _face_points(rng, 3000, 0.05)
    inv = np.float32(1) / np.float32(0.05)
    assert (np.floor(faces / np.float32(0.05)) != np.floor(faces * inv)).any()
    pts = _surface(rng, 3000)
    mask = rng.random(3000) < 0.9
    far = pts.copy()
    far[::97] += np.float32(60.0)  # past 1024 voxels of 0.05 from the masked minimum
    return {
        "headroom": (pts, mask, 4096),
        "overflow": (pts, mask, 700),  # more voxels than rows: the largest keys are dropped
        "outside_extent": (far, mask, 4096),
        "empty_mask": (pts, np.zeros(3000, bool), 256),
        "one_ulp_from_faces": (faces, np.ones(3000, bool), 8192),
    }


@pytest.mark.parametrize("case", list(_voxel_cases()))
def test_voxelize_bit_equal_to_jax(case):
    pts, mask, cap = _voxel_cases()[case]
    ref = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), 0.05, cap)
    port = voxelize(torch.from_numpy(pts), torch.from_numpy(mask), 0.05, cap)
    _assert_bit_equal(port, ref)
    if case == "overflow":
        assert int(port.num_voxels) == cap and bool((port.to_voxel == -1).any())
    if case == "outside_extent":
        assert int(port.num_dropped) > 0
    if case == "empty_mask":
        assert int(port.num_voxels) == 0 and port.origin.tolist() == [0, 0, 0]


@pytest.mark.parametrize("caps,k1", [((4096, 2048, 1024, 512), 3), ((600, 200, 64, 16), 3),
                                     ((4096, 2048, 1024, 512), 7)])
def test_build_pyramid_bit_equal_to_jax(caps, k1):
    """Every leaf, at full headroom, with every level overflowing, and with
    a 7^3 first conv whose occupancy words use bit 31."""
    rng = np.random.default_rng(k1 + caps[0])
    pts = _surface(rng, 3000)
    mask = rng.random(3000) < 0.95
    ref = jax_build_pyramid(jnp.asarray(pts), jnp.asarray(mask), 0.05, caps, conv1_kernel_size=k1)
    port = build_pyramid(torch.from_numpy(pts), torch.from_numpy(mask), 0.05, caps, conv1_kernel_size=k1)
    _assert_bit_equal(port, ref)
    assert all(t.dtype == torch.int32 for t in (*port.same, *port.down, *port.up, port.conv1_occ))
    if k1 == 7:  # the sign bit of a word carries offset 31 (C7)
        assert bool((port.conv1_occ < 0).any())
        bit31 = ((port.conv1_occ[:, 0] >> 31) & 1).bool()
        ref_bit = (np.asarray(ref.conv1_occ)[:, 0] >> 31).astype(bool)
        assert np.array_equal(bit31.numpy(), ref_bit)


def test_device_build_equals_host_build():
    """The port's copy of tests/test_native_pyramid.py: with headroom at
    every level, the device build and the host (C++) build give the same
    rows in the same (key) order, the same tables, occupancy words,
    representative points and each point's voxel row. The host quantizes
    with ``p * (1 / voxel_size)``, the device (as the reference) with ``p
    / voxel_size``; the two floors differ where one rounding lands on an
    integer, and on this cloud they agree everywhere (asserted first)."""
    rng = np.random.default_rng(3)
    pts = _surface(rng, 3000)
    vs, caps, k1 = 0.05, (4096, 4096, 4096, 4096), 3
    inv = np.float32(1.0) / np.float32(vs)
    assert np.array_equal(np.floor(pts / np.float32(vs)), np.floor(pts * inv))
    dev = build_pyramid(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool), vs, caps,
                        conv1_kernel_size=k1)
    host = alloc_pyramid_buffers(caps, k1)
    fill_pyramid_host(pts, vs, host, conv1_kernel_size=k1)
    for l in range(4):
        n = int(host.levels[l].num)
        for name in ("keys", "mask", "num"):
            assert np.array_equal(getattr(dev.levels[l], name).numpy(), getattr(host.levels[l], name)), (l, name)
        # pad rows: the reference decodes SENTINEL keys, the host leaves zeros
        assert np.array_equal(dev.levels[l].coords.numpy()[:n], host.levels[l].coords[:n])
        assert np.array_equal(dev.same[l].numpy(), host.same[l].astype(np.int32))
    for l in range(3):
        assert np.array_equal(dev.down[l].numpy(), host.down[l].astype(np.int32))
        assert np.array_equal(dev.up[l].numpy(), host.up[l].astype(np.int32))
    assert np.array_equal(dev.conv1_occ.numpy(), host.conv1_occ.view(np.int32))
    assert np.array_equal(dev.grid.rep_point.numpy(), host.grid.rep_point)
    assert np.array_equal(dev.grid.origin.numpy(), host.grid.origin)
    assert np.array_equal(dev.grid.to_voxel.numpy(), host_to_voxel(pts, vs, caps[0]))


@pytest.fixture(scope="module")
def run():
    """``register_pair`` at ``SMALL`` (host_maps=False) in the JAX package
    and in the port on the same variables and draws, and the JAX
    package's describe of cloud 0."""
    jpipe = JPipe(JConfig(**SMALL), {})
    jvars = jpipe.init_variables(jax.random.PRNGKey(0))
    pair = synthetic_pair(3, points_per_cloud=1500, num_keypoints=128, surface_extent=1.2)
    ones = np.ones(1500, bool)
    args = (pair["points0"], ones, pair["keys0"], pair["points1"], ones, pair["keys1"])
    rng = jax.random.PRNGKey(5)
    ref = jax.tree_util.tree_map(np.asarray, jpipe.register_pair(rng, *args))
    ref_bb0 = np.asarray(jpipe.describe(*args[:3])[0])
    _, _, r_ransac = jax.random.split(rng, 3)
    perm = np.array(jax.random.permutation(r_ransac, SMALL["keynum"]))
    variables = jax.tree_util.tree_map(np.asarray, {k: jvars[k] for k in ("backbone", "gf", "rd", "et")})
    pipe = RegistrationPipeline(PipelineConfig(**SMALL), variables, device="cpu")
    out = {k: v.numpy() for k, v in pipe.register_pair(
        pair["points0"], None, pair["keys0"], pair["points1"], None, pair["keys1"], perm=perm).items()}
    return pair, ref, ref_bb0, out


def test_extract_group_features_matches_jax(run, monkeypatch):
    """The device-built describe of one cloud (``register_pair``'s ``bb0``,
    through ``extract_group_features``): the port rotates the cloud as the
    reference does (``points @ R.T`` in f32), builds each chunk's pyramids
    and runs one batched forward a chunk. Its rotated clouds quantize to
    the reference's voxels (asserted: a one-ulp difference of a rotated
    point at a voxel boundary would move a voxel), so the features agree to
    the order of f32 sums."""
    import roreg_tpu_torch.pipeline.extractor as X

    pair, _, ref_bb0, out = run
    pts = torch.from_numpy(pair["points0"])
    for R in get_group(12).rotations.astype(np.float32):
        jr = np.asarray(jnp.asarray(pair["points0"]) @ jnp.asarray(R).T)
        tr = (pts @ torch.from_numpy(R).T).numpy()
        assert np.array_equal(np.floor(jr / np.float32(0.05)), np.floor(tr / np.float32(0.05)))
    assert out["bb0"].shape == (128, 12, 32)
    assert np.abs(out["bb0"] - ref_bb0).max() <= FEAT_TOL
    # the dispatch: the gather engine with host_maps=False takes the device path
    called = []
    monkeypatch.setattr(X, "extract_group_features", lambda *a: called.append(a[4].host_maps) or "dev")
    assert X.extract(None, pair["points0"], None, pair["keys0"], PipelineConfig(**SMALL), "cpu") == "dev"
    assert called == [False]


def test_register_pair_with_device_pyramids_matches_jax(run):
    """``register_pair`` under ``host_maps=False`` on both frameworks: the
    same matches and group indices, the transform within ``T_TOL``."""
    _, ref, _, out = run
    assert np.array_equal(out["matches"], ref["matches"])
    assert np.array_equal(out["match_valid"], ref["match_valid"]) and out["match_valid"].sum() >= 5
    assert np.array_equal(out["dr_index"], ref["dr_index"])
    assert np.abs(out["transform"] - ref["transform"]).max() <= T_TOL


def test_block_engine_ignores_host_maps(monkeypatch):
    """As in the reference, the block engine builds host payloads whatever
    ``host_maps`` says."""
    import roreg_tpu_torch.pipeline.extractor as X

    calls = []
    monkeypatch.setattr(X, "extract_group_features_blocks", lambda *a: calls.append(a[1].shape) or ("feats", 0))
    monkeypatch.setattr(X, "extract_group_features", lambda *a: pytest.fail("device path on the block engine"))
    cfg = PipelineConfig(**{**SMALL, "engine": "block"})
    pts = np.zeros((10, 3), np.float32)
    dropped = []
    assert X.extract(None, pts, np.arange(10) < 6, pts[:2], cfg, "cpu", None, dropped) == "feats"
    assert calls == [(6, 3)] and dropped == [0]
