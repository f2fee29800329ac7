"""The backbone zoo and the rest of the gather engine against the JAX
package: every ``RESUNET_VARIANTS`` and ``SIMPLENET_VARIANTS`` entry's
forward (eval, and training mode for each family), the weight conversion
both ways, the instance norm, the hypercross and custom kernel regions,
pooling, pruning, trilinear interpolation, ``RotationDetectorFormer``, and
the combinations the JAX package cannot run, which the port refuses.

Small size: capacities (512, 256, 128, 64), voxel 0.08, conv1 kernel 3,
f32 (``backbone_compute_dtype=None``). Both packages run the same
variables (the port's seeded initialiser with perturbed norms, fed to the
JAX modules as they are) on the same host pyramid. Forward outputs agree
within 1e-4 (unit vectors after 20 f32 convs summed in another order, as
tests/test_torch_backbone.py holds), everything else within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.native.pyramid import build_pyramid_host  # noqa: E402
from roreg_tpu.sparse import resunet as JR  # noqa: E402
from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig, check_supported  # noqa: E402
from roreg_tpu_torch.pipeline.extractor import make_backbone, upload_pyramid  # noqa: E402
from roreg_tpu_torch.sparse import kernel_map as KM  # noqa: E402
from roreg_tpu_torch.sparse.resunet import RESUNET_VARIANTS, SIMPLENET_VARIANTS, flatten_batch  # noqa: E402
from roreg_tpu_torch.weights import (  # noqa: E402
    export_variables,
    flatten_variables,
    init_module_variables,
    load_variables,
    unflatten_variables,
)

CAPS = (512, 256, 128, 64)
VS = 0.08
FWD_TOL = 1e-4
TOL = 1e-5
VARIANTS = sorted(RESUNET_VARIANTS) + sorted(SIMPLENET_VARIANTS)
# one of each family for the training-mode forward
TRAIN_VARIANTS = ["ResUNetIN2C", "SimpleNetBN2", "SimpleNetINE"]


def _cfg(name, **kw):
    return PipelineConfig(voxel_size=VS, capacities=CAPS, conv1_kernel_size=3, backbone_variant=name,
                          backbone_compute_dtype=None, engine="gather", **kw)


def _cloud(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1.2, size=(500, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pyramids():
    """(port host pyramid, JAX pyramid) of one cloud, and of a second one."""
    out = []
    for seed in (0, 1):
        pts = _cloud(seed)
        host = alloc_pyramid_buffers(CAPS, 3)
        fill_pyramid_host(pts, VS, host, conv1_kernel_size=3)
        out.append((host, jax.tree_util.tree_map(jnp.asarray, build_pyramid_host(pts, VS, CAPS, 3))))
    return out


def _variables(net, seed):
    """The port's initial variables with random norm scales, biases and
    statistics (the initialiser gives 1 and 0)."""
    flat = flatten_variables(init_module_variables(net, seed))
    rng = np.random.default_rng(seed + 100)
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return unflatten_variables(flat)


def _jax_apply(name, variables, pyr, train):
    """The JAX module's forward (jitted: one compile is cheaper than the
    eager forward's many small ones)."""
    net = (JR.SimpleNet if name in SIMPLENET_VARIANTS else JR.ResUNet)(variant=name, conv1_kernel_size=3)
    fin = jnp.ones((CAPS[0], 1))
    if train:
        return jax.jit(lambda v, p: net.apply(v, fin, p, True, mutable=["batch_stats"]))(variables, pyr)
    return jax.jit(lambda v, p: net.apply(v, fin, p, False))(variables, pyr)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_forward_matches_jax(name, pyramids):
    """Each variant builds through ``make_backbone``, takes variables in the
    JAX layout and gives them back unchanged, and its eval forward equals
    the JAX module's: finite, unit rows, zero pad rows. One of each family
    (IN ResUNet, BN SimpleNet, IN SimpleNet) also runs in training mode:
    outputs and the updated running statistics."""
    host, jpyr = pyramids[0]
    net = make_backbone(_cfg(name))
    variables = _variables(net, 0)
    load_variables(net, variables)
    got = flatten_variables(export_variables(net))
    assert got.keys() == flatten_variables(variables).keys()
    assert all(np.array_equal(v, flatten_variables(variables)[k]) for k, v in got.items())
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = np.asarray(_jax_apply(name, jv, jpyr, False))
    pyr = upload_pyramid(host, torch.device("cpu"))
    out = net.eval()(pyr).detach().numpy()
    mask = host.levels[0].mask
    np.testing.assert_allclose(out, ref, atol=FWD_TOL)
    assert np.isfinite(out).all() and not out[~mask].any()
    np.testing.assert_allclose(np.linalg.norm(out[mask], axis=-1), 1.0, atol=1e-3)
    if name in TRAIN_VARIANTS:
        ref, upd = _jax_apply(name, jv, jpyr, True)
        out = net.train()(pyr).detach().numpy()
        np.testing.assert_allclose(out, np.asarray(ref), atol=FWD_TOL)
        stats = {k: v for k, v in flatten_variables(export_variables(net)).items() if k.startswith("batch_stats")}
        want = flatten_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, upd.get("batch_stats", {}))})
        assert stats.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(stats[k], v, rtol=TOL, atol=TOL * float(np.abs(v).max()), err_msg=k)


def test_instance_norm_keeps_each_stacked_cloud_apart(pyramids):
    """A batched pyramid of two clouds (the gather describe's chunk) gives
    each cloud the output it has alone: the instance norms take each
    cloud's own statistics."""
    net = make_backbone(_cfg("ResUNetIN2B"))
    load_variables(net, _variables(net, 1))
    net.eval()
    singles = [net(upload_pyramid(h, torch.device("cpu"))).detach() for h, _ in pyramids]
    st = lambda f: torch.from_numpy(np.stack([f(h) for h, _ in pyramids]))  # noqa: E731
    hosts = [h for h, _ in pyramids]
    batched = flatten_batch(
        [st(lambda h, l=l: h.levels[l].mask) for l in range(4)],
        st(lambda h: h.conv1_occ.view(np.int32)),
        [st(lambda h, l=l: h.same[l]) for l in range(4)],
        [st(lambda h, l=l: h.down[l]) for l in range(3)],
        [st(lambda h, l=l: h.up[l]) for l in range(3)],
    )
    assert batched.batch == len(hosts)
    out = net(batched).detach()
    np.testing.assert_allclose(out.numpy(), torch.cat(singles).numpy(), atol=TOL)


def test_masked_instance_norm_matches_jax():
    from roreg_tpu.sparse.conv import MaskedInstanceNorm as JaxIN
    from roreg_tpu_torch.sparse.conv import MaskedInstanceNorm

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 8)) * 3 + 1).astype(np.float32)
    mask = np.arange(64) < 40
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    ref = np.asarray(JaxIN().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), jnp.asarray(mask)))
    m = MaskedInstanceNorm(8)
    load_variables(m, {"params": {"scale": scale, "bias": bias}})
    for mode in (m.eval(), m.train()):  # no statistics: train and eval alike
        out = mode(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        assert not out[40:].any()
    plain = MaskedInstanceNorm(8)(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert abs(plain[:40].mean()) < 1e-5 and abs(plain[:40].var() - 1.0) < 1e-2


# ---------------------------------------------------------------------------
# refusals where the JAX package cannot run either


def test_block_engine_refuses_what_the_reference_cannot_run(pyramids):
    """The block engine runs batch-norm ResUNet blocks only: an IN ResUNet's
    variables do not apply to the JAX package's BlockResUNet (no batch
    statistics for its block norms), a SimpleNet is no ResUNet variant
    there, and the host-map gather describe builds a ResUNet, which has no
    SimpleNet variant. The port refuses all three when the pipeline is
    configured."""
    from roreg_tpu.native.blockpyr import alloc_block_buffers, fill_block_pyramid_host
    from roreg_tpu.sparse.block import BlockResUNet as JaxBlock

    _, jpyr = pyramids[0]
    jv = jax.tree_util.tree_map(jnp.asarray, _variables(make_backbone(_cfg("ResUNetIN2C")), 0))
    bpyr = alloc_block_buffers((64, 32, 16, 8))
    fill_block_pyramid_host(_cloud(0), VS, bpyr)
    bpyr = jax.tree_util.tree_map(jnp.asarray, bpyr)
    with pytest.raises(Exception, match="batch_stats|mean"):
        jax.eval_shape(lambda: JaxBlock(variant="ResUNetIN2C", conv1_kernel_size=3).apply(jv, bpyr, False))
    with pytest.raises(KeyError):
        JaxBlock(variant="SimpleNetBN", conv1_kernel_size=3).init(jax.random.PRNGKey(0), bpyr, False)
    with pytest.raises(KeyError):
        JR.ResUNet(variant="SimpleNetBN", conv1_kernel_size=3).init(
            jax.random.PRNGKey(0), jnp.ones((CAPS[0], 1)), jpyr, False)
    for name, engine in (("ResUNetIN2C", "block"), ("SimpleNetBN", "block"), ("SimpleNetBN", "gather")):
        with pytest.raises(ValueError, match="reference"):
            check_supported(dataclasses.replace(_cfg(name), engine=engine))
    check_supported(_cfg("ResUNetIN2C"))
    with pytest.raises(ValueError, match="unknown backbone"):
        check_supported(_cfg("ResUNetXX"))


# ---------------------------------------------------------------------------
# kernel regions


def test_kernel_regions_match_jax(pyramids):
    """Hypercross (7 and 13 offsets) and custom (40) regions; a table for
    each over level 0 and level 1 equals the JAX package's
    ``neighbor_table``, and the gather conv over the custom one equals its
    ``gather_conv``; the hypercube region is the UNet's own."""
    from roreg_tpu.sparse import conv as JC
    from roreg_tpu.sparse import kernel_map as JK
    from roreg_tpu_torch.kernels.gather_conv import gather_conv

    custom = np.random.default_rng(4).integers(-3, 4, size=(40, 3)).astype(np.int32)
    for ks, region in ((3, "hypercross"), (5, "hypercross"), (0, "custom")):
        off = KM.kernel_offsets(ks, region, custom if region == "custom" else None)
        assert np.array_equal(off, JK.kernel_offsets(ks, region, custom if region == "custom" else None))
        assert len(off) == {"hypercross": 1 + 3 * (ks - 1), "custom": 40}[region]
        host, jpyr = pyramids[0]
        for lvl, step in ((0, 1), (1, 2)):
            tbl = KM.neighbor_table(host.levels[lvl], off, step)
            ref = np.asarray(JK.neighbor_table(jpyr.levels[lvl], off, step))
            assert tbl.dtype == torch.int32 and np.array_equal(tbl.numpy(), ref), (region, lvl)
    # a conv over the custom region's 40 offsets (more than one launch of
    # the card's kernel takes)
    rng = np.random.default_rng(ks)
    feats = rng.normal(size=(CAPS[0], 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(len(off), 16, 8))).astype(np.float32)
    tbl = KM.neighbor_table(host.levels[0], off, 1)
    out = gather_conv(torch.from_numpy(feats), tbl, torch.from_numpy(w)).numpy()
    want = np.asarray(JC.gather_conv(jnp.asarray(feats), jnp.asarray(tbl.numpy()), jnp.asarray(w)))
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    assert np.array_equal(KM.kernel_offsets(3), JK.hypercube_offsets(3))
    with pytest.raises(ValueError):
        KM.hypercross_offsets(4)
    with pytest.raises(ValueError):
        KM.kernel_offsets(3, "custom")


def test_pack_keys_and_lookup_match_jax():
    from roreg_tpu.sparse import kernel_map as JK
    from roreg_tpu.sparse.voxelize import pack_keys as jax_pack

    rng = np.random.default_rng(5)
    coords = rng.integers(0, 1024, size=(200, 3)).astype(np.int32)
    keys = np.sort(np.unique(np.asarray(jax_pack(jnp.asarray(coords)))))
    assert np.array_equal(KM.pack_keys(torch.from_numpy(coords)).numpy(), np.asarray(jax_pack(jnp.asarray(coords))))
    padded = np.concatenate([keys, np.full(8, KM.SENTINEL, np.int32)]).astype(np.int32)
    q = np.concatenate([keys[::3], rng.integers(0, 2**30, 50), [KM.SENTINEL]]).astype(np.int32)
    got = KM.lookup(torch.from_numpy(padded), torch.from_numpy(q)).numpy()
    assert np.array_equal(got, np.asarray(JK.lookup(jnp.asarray(padded), jnp.asarray(q))))


# ---------------------------------------------------------------------------
# pooling, pruning, interpolation


def test_pooling_and_prune_match_jax():
    """tests/test_pool.py's cases, each against the JAX function."""
    from roreg_tpu.sparse import pool as JP
    from roreg_tpu.sparse.kernel_map import SparseLevel as JLevel
    from roreg_tpu_torch.sparse import pool as P

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(10, 4)).astype(np.float32)
    nbr = np.array([[0, 1, -1], [2, -1, -1], [-1, -1, -1], [3, 4, 5]], np.int32)
    mask = np.array([True, True, True, False])
    for mode in ("max", "avg"):
        out = P.local_pool(torch.from_numpy(feats), torch.from_numpy(nbr), torch.from_numpy(mask), mode).numpy()
        ref = np.asarray(JP.local_pool(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(mask), mode))
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert np.allclose(out[0], (feats[0] + feats[1]) / 2) and not out[2:].any()
    feats = rng.normal(size=(8, 3)).astype(np.float32)
    mask = np.array([True] * 5 + [False] * 3)
    for mode in ("avg", "max", "sum"):
        g = P.global_pool(torch.from_numpy(feats), torch.from_numpy(mask), mode).numpy()
        np.testing.assert_allclose(g, np.asarray(JP.global_pool(jnp.asarray(feats), jnp.asarray(mask), mode)),
                                   rtol=TOL, atol=TOL)
    assert not P.global_pool(torch.from_numpy(feats), torch.zeros(8, dtype=torch.bool), "max").any()
    for op in ("add", "mul"):
        out = P.global_broadcast(torch.from_numpy(feats), torch.from_numpy(g), torch.from_numpy(mask), op).numpy()
        ref = JP.global_broadcast(jnp.asarray(feats), jnp.asarray(g), jnp.asarray(mask), op)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)
    keys = np.arange(16, dtype=np.int32)
    lvl_mask = np.arange(16) < 11
    keep = np.arange(16) % 2 == 0
    pruned = P.prune(KM.SparseLevel(keys, np.zeros((16, 3), np.int32), lvl_mask, np.int32(11)), keep)
    ref = JP.prune(JLevel(jnp.asarray(keys), jnp.zeros((16, 3), jnp.int32), jnp.asarray(lvl_mask), 11),
                   jnp.asarray(keep))
    assert np.array_equal(pruned.mask, np.asarray(ref.mask)) and int(pruned.num) == int(ref.num) == 6
    assert np.array_equal(pruned.keys, keys)


def test_interpolate_matches_the_oracle_and_jax():
    """tests/test_backbone_zoo.py's oracle (a linear field is interpolated
    exactly; all corners absent gives zero), and random queries against
    the JAX function."""
    from roreg_tpu.sparse.interpolate import interpolate as jax_interp
    from roreg_tpu_torch.sparse.interpolate import interpolate

    g = np.stack(np.meshgrid(*([np.arange(6)] * 3), indexing="ij"), -1)
    coords = g.reshape(-1, 3).astype(np.int32)
    keys = KM.pack_keys(torch.from_numpy(coords)).numpy()
    order = np.argsort(keys)
    keys = keys[order]
    feats = (coords[order] @ np.array([[1.0], [2.0], [3.0]])).astype(np.float32)
    vs = 0.1
    origin = torch.zeros(3, dtype=torch.int32)
    q = np.array([[0.25, 0.31, 0.47], [0.1, 0.1, 0.1], [0.49, 0.01, 0.33]], np.float32)
    out = interpolate(torch.from_numpy(keys), torch.from_numpy(feats), origin, torch.from_numpy(q), vs).numpy()
    np.testing.assert_allclose(out[:, 0], (q / vs) @ np.array([1.0, 2.0, 3.0]), rtol=1e-5)
    far = interpolate(torch.from_numpy(keys), torch.from_numpy(feats), origin,
                      torch.tensor([[5.0, 5.0, 5.0]]), vs)
    assert float(far[0, 0]) == 0.0
    rng = np.random.default_rng(6)
    sparse = rng.random(len(keys)) < 0.7  # absent corners add zero
    k2 = np.where(sparse, keys, KM.SENTINEL).astype(np.int32)
    order = np.argsort(k2)
    k2, f2 = k2[order], rng.normal(size=(len(keys), 5)).astype(np.float32)[order]
    q = rng.uniform(-0.05, 0.6, size=(100, 3)).astype(np.float32)
    origin = np.array([0, 0, 0], np.int32)
    got = interpolate(torch.from_numpy(k2), torch.from_numpy(f2), torch.from_numpy(origin), torch.from_numpy(q), vs)
    want = jax_interp(jnp.asarray(k2), jnp.asarray(f2), jnp.asarray(origin), jnp.asarray(q), vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# RD former


def test_rotation_detector_former_matches_jax():
    """Eval and training mode (flax batch norm, momentum 0.9) against the
    JAX module at G = 12, from the JAX module's initial variables."""
    from roreg_tpu.core.group import get_group as jax_group
    from roreg_tpu.models.rd import RotationDetectorFormer as JaxFormer
    from roreg_tpu_torch.core.group import get_group
    from roreg_tpu_torch.models.rd import RotationDetectorFormer

    rng = np.random.default_rng(7)
    x = rng.normal(size=(20, 12, 32)).astype(np.float32)
    jnet = JaxFormer(jax_group(12))
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    variables = jax.tree_util.tree_map(np.asarray, v)
    net = RotationDetectorFormer(get_group(12))
    load_variables(net, variables)
    out = net.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.apply(v, jnp.asarray(x), False)), rtol=TOL, atol=TOL)
    ref, upd = jnet.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    out = net.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)
    stats = flatten_variables(export_variables(net))
    for k, val in flatten_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}).items():
        np.testing.assert_allclose(stats[k], val, rtol=TOL, atol=TOL, err_msg=k)
    assert np.all((out > 0) & (out < 1))
