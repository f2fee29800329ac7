"""FCGF backbone training against the JAX package: the masked batch norm
in training mode, the hardest-contrastive loss, the pair batches, one SGD
step and one Adam step of the train step, the gather conv's gradient
(``GatherConvFn``), an overfit run, the refusal of f32 convs on the card,
and ``cli.train --component backbone``.

Small size: capacities (512, 256, 128, 64), voxel 0.08, conv1 kernel 3,
at most 128 pairs. Both packages start from the same variables, the
port's seeded initialiser at the JAX package's scales.

Tolerances. At ``backbone_compute_dtype=None`` both run in f32: the loss,
every parameter and both running statistics of every batch norm after a
step agree within 1e-5 relative to each tensor's largest value, except
elements whose gradient is rounding noise (the reference's gradient,
read from its SGD step, below ``NOISE_GRAD`` 1e-5 of the network's largest
gradient: a gradient that small is a cancellation of larger f32 sums taken
in another order; for Adam also every gradient below ``ADAM_SMALL_GRAD``
1e-5 in absolute value, where its step's sensitivity to the gradient,
1e-8 / |g|, turns the sums' noise into more than 1e-5 of the step), which
one Adam step moves by up to the learning rate in either framework
(ROADMAP C19). Such elements are 0.125 % of the parameters for SGD and
1.1 % for Adam at this size; ``NOISE_SHARE`` caps them at 0.5 % and 3 %. At bf16 the JAX package's
gradient is itself rounded: its cotangents of the bf16 features and
weights are bf16 and the gather's transpose scatter-adds in bf16 (one conv
alone: 0.86 % of the largest dX against 0.20 % for one rounding), where
the port sums in f32 and rounds once; and the two frameworks' forwards
round different conv inputs to bf16 where their f32 sums differ in the
last bit. Measured at this size: the loss within 3.9e-4 relative
(``BF16_LOSS_RTOL`` 2e-3); the SGD step's gradients within 16 % of each
tensor's norm (``BF16_GRAD_RTOL`` 0.25; the JAX package against itself
with the gather's offsets chunked by 27 instead of 9 differs by up to
16.8 %, so this is JAX's own bf16 noise); the running statistics within
0.56 % of each tensor's largest value (``BF16_STATS_RTOL`` 2 %); Adam's
first step, about lr * sign(g), moved 4.4 % of the elements the other
way (``BF16_ADAM_FLIPS`` 10 %), every element within 2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu.data.synthetic import make_synthetic_scene as jax_scene  # noqa: E402
from roreg_tpu.pipeline.config import PipelineConfig as JaxConfig  # noqa: E402
from roreg_tpu.train import backbone as JB  # noqa: E402
from roreg_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from roreg_tpu_torch.kernels import gather_conv as GC  # noqa: E402
from roreg_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from roreg_tpu_torch.sparse.conv import MaskedBatchNorm  # noqa: E402
from roreg_tpu_torch.train import backbone as B  # noqa: E402
from roreg_tpu_torch.weights import _leaves, flatten_variables  # noqa: E402

SMALL = dict(voxel_size=0.08, capacities=(512, 256, 128, 64), conv1_kernel_size=3)
SCENE = dict(num_clouds=2, points_per_cloud=3000, num_keypoints=64, overlap=0.85, max_angle_deg=20.0)
MAX_PAIRS = 128
LR = {"sgd": 1e-1, "adam": 1e-3}
RTOL = 1e-5
NOISE_GRAD = 1e-5
ADAM_SMALL_GRAD = 1e-5
LOSS_TOL = 1e-6
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_RTOL = 0.25
BF16_ADAM_FLIPS = 0.1
BF16_STATS_RTOL = 0.02
NOISE_SHARE = {"sgd": 0.005, "adam": 0.03}


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same scene written by both packages (byte-equal, as
    tests/test_torch_eval_data.py holds)."""
    root = tmp_path_factory.mktemp("bb")
    return (make_synthetic_scene(str(root / "port"), np.random.default_rng(3), **SCENE),
            jax_scene(str(root / "jax"), np.random.default_rng(3), **SCENE))


@pytest.fixture(scope="module")
def batches(scenes):
    port = B.backbone_pair_batches([scenes[0]], PipelineConfig(**SMALL), np.random.default_rng(5),
                                   max_pairs=MAX_PAIRS)
    ref = JB.backbone_pair_batches([scenes[1]], JaxConfig(**SMALL), np.random.default_rng(5),
                                   max_pairs=MAX_PAIRS)
    return [(next(port), next(ref)) for _ in range(2)]


# ---------------------------------------------------------------------------
# masked batch norm (repair)


@pytest.mark.parametrize("shape", [(40,), (6, 64)], ids=["gather-rows", "block-cells"])
def test_masked_batch_norm_training_matches_jax(shape):
    """Training mode on padded rows: statistics over the valid rows only,
    the two-pass variance, ``(1 - m) old + m batch`` with m = 0.05; the
    outputs and both running statistics equal the JAX module's. The
    block engine's (blocks, 64, C) cells with a cell mask use the same
    class."""
    from roreg_tpu.sparse.conv import MaskedBatchNorm as JaxMBN

    rng = np.random.default_rng(7)
    c = 8
    x = (rng.normal(size=shape + (c,)) * 2 + 0.5).astype(np.float32)
    mask = rng.random(shape) < 0.6
    x[~mask] = 50.0  # pad rows must not reach the statistics
    ra_mean = rng.normal(size=c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2, size=c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": ra_mean, "var": ra_var}}
    ref, upd = JaxMBN(momentum=0.05).apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                           use_running_average=False, mutable=["batch_stats"])
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, ra_mean), (bn.running_var, ra_var)):
            t.copy_(torch.from_numpy(a))
    out = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not out[torch.from_numpy(~mask)].any()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    # eval mode reads the running statistics, as before
    ev = bn.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    ref_ev = JaxMBN(momentum=0.05).apply(
        {"params": variables["params"], "batch_stats": _np(upd["batch_stats"])}, jnp.asarray(x),
        jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(ref_ev), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# loss


def test_hardest_contrastive_properties():
    """tests/test_backbone_train.py's properties, on the port."""
    rng = np.random.default_rng(0)
    p, c = 64, 16
    f = torch.from_numpy(rng.normal(size=(p, c)).astype(np.float32))
    f = f / f.norm(dim=-1, keepdim=True)
    mask = torch.ones(p, dtype=torch.bool)
    loss_same, aux = B.hardest_contrastive_loss(f, f, mask)
    assert float(aux["pos_loss"]) < 1e-10
    loss_bad, _ = B.hardest_contrastive_loss(f, f[torch.roll(torch.arange(p), 1)], mask)
    assert float(loss_bad) > float(loss_same)
    half = torch.arange(p) < p // 2
    l1, _ = B.hardest_contrastive_loss(f, f, half)
    f2 = f.clone()
    f2[p // 2:] = 999.0
    l2, _ = B.hardest_contrastive_loss(f2, f2, half)
    assert abs(float(l1) - float(l2)) < 1e-5


def test_hardest_contrastive_matches_jax():
    """Loss, the four auxiliary values and the gradients against JAX at
    1e-6, with pad rows, the safe-radius exclusion and tied distances
    (duplicated rows); then with every candidate within the safe radius,
    where the hardest distance is 1e9 and no negative term remains."""
    rng = np.random.default_rng(1)
    p, c = 48, 16
    f0 = rng.normal(size=(p, c)).astype(np.float32)
    f1 = f0 + 0.3 * rng.normal(size=(p, c)).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    f1[5] = f1[6]  # a tie for every anchor that sees both
    mask = np.arange(p) < 40
    pos0 = rng.uniform(0, 1, size=(p, 3)).astype(np.float32)
    pos1 = pos0 + 0.01 * rng.normal(size=(p, 3)).astype(np.float32)
    r = 0.3
    excluded = np.sum((pos0[:, None] - pos1[None]) ** 2, -1) <= r * r
    assert 0.05 < excluded.mean() < 0.5

    for q0, q1 in ((pos0, pos1), (np.zeros_like(pos0), np.zeros_like(pos1))):
        def jax_fn(a, b):
            return JB.hardest_contrastive_loss(a, b, jnp.asarray(mask), pos0=jnp.asarray(q0),
                                               pos1=jnp.asarray(q1), safe_radius=r)

        (ref, raux), (g0, g1) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(f0), jnp.asarray(f1))
        t0, t1 = torch.from_numpy(f0).requires_grad_(), torch.from_numpy(f1).requires_grad_()
        loss, aux = B.hardest_contrastive_loss(t0, t1, torch.from_numpy(mask), pos0=torch.from_numpy(q0),
                                               pos1=torch.from_numpy(q1), safe_radius=r)
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(ref), rel=LOSS_TOL)
        for k in raux:
            assert float(aux[k]) == pytest.approx(float(raux[k]), rel=LOSS_TOL), k
        np.testing.assert_allclose(t0.grad.numpy(), np.asarray(g0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), rtol=1e-6, atol=1e-6)
    assert float(aux["neg_dist"]) == 1e9 and float(aux["neg_loss"]) == 0.0


# ---------------------------------------------------------------------------
# batches


def test_pair_batches_equal_jax_bit_for_bit(batches):
    """The same seed gives the JAX package's pairs, mask, positions and
    pyramids, bit for bit, batch after batch (the < 32-pairs retry and the
    draws keep their order)."""
    for port, ref in batches:
        for k in ("pairs", "pair_mask", "pos0", "pos1"):
            assert np.array_equal(port[k], np.asarray(ref[k])), k
        for side in ("pyr0", "pyr1"):
            p, r = port[side], ref[side]
            assert int(p.grid.num_voxels) == int(r.grid.num_voxels)
            assert np.array_equal(p.grid.rep_point, np.asarray(r.grid.rep_point))
            assert np.array_equal(p.conv1_occ, np.asarray(r.conv1_occ))
            for kind in ("same", "down", "up"):
                for a, b in zip(getattr(p, kind), getattr(r, kind)):
                    assert np.array_equal(a, np.asarray(b)), (side, kind)
        assert 32 <= int(port["pair_mask"].sum()) <= MAX_PAIRS


# ---------------------------------------------------------------------------
# one train step


def _jax_step(cfg, optimizer, batch, variables):
    """One step of the JAX package's backbone train step from
    ``variables``. Its state is the one ``init_fn`` returns (structure
    traced, not run) with optax's initial optimizer state, zeros, and the
    given parameters and statistics in place of its random init."""
    init_fn, step_fn = JB.make_backbone_train_step(cfg, lr=LR[optimizer], optimizer=optimizer)
    jb = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in batch.items()}
    state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   jax.eval_shape(init_fn, jax.random.PRNGKey(0), jb))
    state["params"] = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    new, metrics = step_fn(state, jb)
    after = _np({"params": new["params"], "batch_stats": new["batch_stats"]})
    return {k: float(v) for k, v in metrics.items()}, after


@pytest.fixture(scope="module")
def jax_steps(batches):
    """``(optimizer, dtype) -> (before, metrics, after)``: one JAX step from
    the port's seeded variables on the first batch, each run once."""
    from roreg_tpu_torch.pipeline.extractor import make_backbone
    from roreg_tpu_torch.weights import init_module_variables

    done = {}

    def run(optimizer, dtype):
        if (optimizer, dtype) not in done:
            small = {**SMALL, "backbone_compute_dtype": dtype}
            before = init_module_variables(make_backbone(PipelineConfig(**small)), 0)
            done[optimizer, dtype] = (before,) + _jax_step(JaxConfig(**small), optimizer, batches[0][1], before)
        return done[optimizer, dtype]

    return run


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_one_train_step_matches_jax(batches, jax_steps, optimizer, dtype):
    """One step from the same variables (the port's seeded initialiser, at
    the JAX package's scales) on the same batch: loss, aux, every parameter
    and both running statistics of every batch norm (moved twice, after
    cloud 0 and after cloud 1). The reference's gradient is read from its
    SGD step, whose first update is ``-lr * g``."""
    port_batch = batches[0][0]
    before, ref_m, after = jax_steps(optimizer, dtype)
    sgd_before, _, sgd_after = jax_steps("sgd", dtype)
    init_fn, step_fn = B.make_backbone_train_step(
        PipelineConfig(**SMALL, backbone_compute_dtype=dtype), lr=LR[optimizer],
        optimizer=optimizer, device="cpu")
    state = init_fn(before)
    m = step_fn(state, port_batch)
    assert state.step == 1
    loss_tol = LOSS_TOL * 10 if dtype is None else BF16_LOSS_RTOL
    for k, v in ref_m.items():
        assert float(m[k]) == pytest.approx(v, rel=loss_tol), k
    grads = {"/".join(p): t.grad for t, p, _ in _leaves(state.net) if p[0] == "params"}
    got, ref = flatten_variables(state.variables()), flatten_variables(after)
    assert got.keys() == ref.keys()
    assert any(k.startswith("batch_stats/block1/norm1") for k in ref)
    lr = LR[optimizer]
    g_refs = {k: (v - flatten_variables(sgd_after)[k]) / LR["sgd"]
              for k, v in flatten_variables(sgd_before).items() if k.startswith("params")}
    gmax = max(float(np.abs(g).max()) for g in g_refs.values())
    noisy = flips = 0
    for k, want in ref.items():
        have = got[k]
        if k.startswith("batch_stats"):
            tol = RTOL if dtype is None else BF16_STATS_RTOL
            scale = tol * max(float(np.abs(want).max()), 1e-12)
            assert np.allclose(have, want, rtol=tol, atol=scale), (k, float(np.abs(have - want).max()))
            continue
        g, g_ref = grads[k].numpy(), g_refs[k]
        g = g.T if g.shape != want.shape else g
        if dtype is None:
            noise = np.abs(g_ref) < NOISE_GRAD * gmax
            if optimizer == "adam":
                # Adam's first step lr * g / (|g| + 1e-8) turns a relative
                # error r of g into lr * r * 1e-8 / |g|: at |g| <
                # ADAM_SMALL_GRAD the f32 sums' own noise moves it by more
                # than 1e-5 lr
                noise |= np.abs(g_ref) < ADAM_SMALL_GRAD
            noisy += int(noise.sum())
            assert (np.abs(have - want)[noise] <= 2 * lr * 1.001).all(), k
            scale = RTOL * max(float(np.abs(want).max()), 1e-12)
            assert np.allclose(have[~noise], want[~noise], rtol=RTOL, atol=scale), (
                k, float(np.abs(have - want)[~noise].max()))
        elif optimizer == "sgd":
            gap = float(np.linalg.norm(g - g_ref) / max(float(np.linalg.norm(g_ref)), 1e-12))
            assert gap <= BF16_GRAD_RTOL, (k, gap)
        else:
            # Adam's first step moves each element by about lr * sign(g)
            moved = np.abs(have - want)
            assert float(moved.max()) <= 2 * lr * 1.001, k
            flips += int((moved > 0.5 * lr).sum())
    n_params = sum(v.size for k, v in ref.items() if k.startswith("params"))
    print(f"{optimizer} {dtype}: noise share {noisy / n_params:.5f}, flip share {flips / n_params:.5f}")
    assert noisy <= NOISE_SHARE[optimizer] * n_params, noisy / n_params
    assert flips <= BF16_ADAM_FLIPS * n_params, flips / n_params


# ---------------------------------------------------------------------------
# the gather conv's gradient


def _conv_inputs(rng, n=70, m=60, k=27, cin=16, cout=24):
    nbr = rng.integers(-1, n, size=(m, k)).astype(np.int32)
    nbr[rng.random((m, k)) < 0.4] = -1
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    w = rng.normal(size=(k, cin, cout)).astype(np.float32) * 0.2
    dy = rng.normal(size=(m, cout)).astype(np.float32)
    return torch.from_numpy(feats), torch.from_numpy(nbr), torch.from_numpy(w), torch.from_numpy(dy)


def test_gather_conv_fn_gradient_equals_autograd_of_the_plain_version():
    """On the CPU ``gather_conv`` with a gradient goes through
    ``GatherConvFn``, which saves its three inputs and not the gathered
    (M, K, Cin) rows, and whose dX and dW equal autograd through
    ``gather_conv_plain`` (f32 exactly, bf16 once rounded)."""
    feats, nbr, w, dy = _conv_inputs(np.random.default_rng(0))
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(dtype).clone().requires_grad_()
        wt = w.to(dtype).clone().requires_grad_()
        out = GC.gather_conv(f, nbr, wt)
        assert type(out.grad_fn).__name__ == "GatherConvFnBackward"
        saved = out.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [tuple(f.shape), tuple(nbr.shape), tuple(wt.shape)]
        out.backward(dy)
        f2 = feats.to(dtype).float().clone().requires_grad_()
        w2 = w.to(dtype).float().clone().requires_grad_()
        GC.gather_conv_plain(f2, nbr, w2).backward(dy)
        assert f.grad.dtype == dtype and wt.grad.dtype == dtype
        assert torch.equal(f.grad, f2.grad.to(dtype))
        assert torch.equal(wt.grad, w2.grad.to(dtype))
    # the plain versions of the two kernels
    assert torch.allclose(GC.gather_conv_dgrad(feats, nbr, w, dy), GC.gather_conv_dgrad_plain(feats, nbr, w, dy))
    dx = torch.zeros_like(feats)
    for mi in range(nbr.shape[0]):
        for ki in range(nbr.shape[1]):
            if nbr[mi, ki] >= 0:
                dx[nbr[mi, ki]] += dy[mi] @ w[ki].T
    assert torch.allclose(GC.gather_conv_dgrad_plain(feats, nbr, w, dy), dx, atol=1e-5)
    dw = torch.zeros_like(w)
    for ki in range(nbr.shape[1]):
        ok = nbr[:, ki] >= 0
        dw[ki] = feats[nbr[ok, ki].long()].T @ dy[ok]
    assert torch.allclose(GC.gather_conv_wgrad_plain(feats, nbr, w, dy), dw, atol=1e-5)


def test_gather_conv_with_a_gradient_off_the_cpu_runs_the_kernels(monkeypatch):
    """A tensor off the CPU that needs a gradient goes through
    ``GatherConvFn`` to the forward kernel and the dgrad and wgrad kernels,
    never to a plain version (the kernels are stubbed here, on the meta
    device: the card test in tests/test_torch_cuda_kernels.py launches
    them)."""
    calls = []

    def fwd(feats, nbr, weights):
        calls.append(("fwd", tuple(feats.shape), tuple(weights.shape)))
        return torch.empty((nbr.shape[0], weights.shape[2]), device=feats.device)

    def bwd(which):
        def run(feats, nbr, weights, dy):
            calls.append((which,))
            shape = tuple(feats.shape) if which == "dgrad" else tuple(weights.shape)
            return torch.empty(shape, device=feats.device)
        return run

    def plain(*a, **k):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    monkeypatch.setattr(GC, "gather_conv_kernel", fwd)
    monkeypatch.setattr(GC, "gather_conv_dgrad_kernel", bwd("dgrad"))
    monkeypatch.setattr(GC, "gather_conv_wgrad_kernel", bwd("wgrad"))
    for name in ("gather_conv_plain", "gather_conv_dgrad_plain", "gather_conv_wgrad_plain"):
        monkeypatch.setattr(GC, name, plain)
    feats = torch.empty((50, 64), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((27, 64, 32), dtype=torch.bfloat16, device="meta", requires_grad=True)
    nbr = torch.empty((40, 27), dtype=torch.int32, device="meta")
    out = GC.gather_conv(feats, nbr, w)
    assert type(out.grad_fn).__name__ == "GatherConvFnBackward"
    out.sum().backward()
    assert calls == [("fwd", (50, 64), (27, 64, 32)), ("dgrad",), ("wgrad",)]
    assert feats.grad.shape == feats.shape and w.grad.shape == w.shape


def test_kernel_forward_pads_narrow_widths_and_splits_many_offsets(monkeypatch):
    """The forward kernel takes Cin in multiples of 32, Cout of
    ``GATHER_COUTS`` and at most 32 offsets: narrower widths are zero-padded
    (SimpleNetBNE's 16 channels) and a custom region of 40 offsets runs as
    launches of 32 and 8 whose sum equals the plain version."""
    launched = []

    def kernel(feats, nbr, weights):
        GC._check_widths(feats.shape[1], weights.shape[2], nbr.shape[1])
        launched.append((feats.shape[1], weights.shape[2], nbr.shape[1]))
        return GC.gather_conv_plain(feats, nbr, weights)

    monkeypatch.setattr(GC, "gather_conv_kernel", kernel)
    rng = np.random.default_rng(2)
    for k, cin, cout in ((27, 16, 16), (40, 32, 64), (7, 48, 24)):
        feats, nbr, w, _ = _conv_inputs(rng, k=k, cin=cin, cout=cout)
        out = GC._padded_forward(feats, nbr, w)
        assert out.shape == (nbr.shape[0], cout)
        assert torch.allclose(out, GC.gather_conv_plain(feats, nbr, w), atol=1e-5)
    assert launched == [(32, 32, 27), (32, 64, 32), (32, 64, 8), (64, 32, 7)]


# ---------------------------------------------------------------------------
# training


def test_overfit_lowers_the_loss(batches):
    """tests/test_backbone_train.py's overfit at the small size: 12 steps on
    one batch, every loss finite, the last three below the first three, the
    positive distance below 1."""
    port_batch, _ = batches[0]
    init_fn, step_fn = B.make_backbone_train_step(
        PipelineConfig(**SMALL, backbone_compute_dtype=None), lr=3e-2, device="cpu")
    state = init_fn(seed=0)
    losses = []
    for _ in range(12):
        m = step_fn(state, port_batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert float(m["pos_dist"]) < 1.0


def test_f32_convs_are_refused_on_the_card(monkeypatch):
    """``backbone_compute_dtype=None`` runs on the card now (the name is
    the old premise's): an f32 backbone step off the CPU sends f32
    operands to the forward kernel's wrapper and to dgrad and wgrad, each
    of which takes them as two bf16 terms (``kernels/split.py``; the
    kernels are stubbed on the meta device here, and the ``cuda`` tests and
    smoke phases 3e and 11c launch them), and the train step builds for
    the card with that config."""
    cfg = PipelineConfig(**SMALL, backbone_compute_dtype=None, engine="gather", group_size=12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(B, "resolve_device", lambda d=None: torch.device("meta"))
    init_fn, step_fn = B.make_backbone_train_step(cfg, device="cuda")
    state = init_fn(seed=0)
    assert all(p.device.type == "meta" and p.dtype == torch.float32 for p in state.net.parameters())
    seen = []

    def stub(name, shape_of):
        def run(*a):
            seen.append((name, a[0].dtype, a[2].dtype))
            return torch.empty(shape_of(*a), device="meta")
        return run

    monkeypatch.setattr(GC, "gather_conv_kernel", stub("fwd", lambda f, n, w: (n.shape[0], w.shape[2])))
    monkeypatch.setattr(GC, "gather_conv_dgrad_kernel", stub("dgrad", lambda f, n, w, d: f.shape))
    monkeypatch.setattr(GC, "gather_conv_wgrad_kernel", stub("wgrad", lambda f, n, w, d: w.shape))
    conv = state.net.conv2
    x = torch.empty((50, conv.kernel.shape[1]), device="meta", requires_grad=True)
    out = conv(x, torch.empty((40, 27), dtype=torch.int32, device="meta"),
               torch.ones(40, dtype=torch.bool, device="meta"))
    out.sum().backward()
    f32 = torch.float32
    assert seen == [("fwd", f32, f32), ("dgrad", f32, f32), ("wgrad", f32, f32)]
    assert conv.kernel.grad.dtype == f32 and x.grad.dtype == f32


def test_backbones_without_batch_statistics_are_refused_as_in_jax(batches):
    """The all-instance-norm SimpleNets have no batch statistics; the JAX
    package's backbone train step reads them at init and fails, and the
    port refuses them."""
    cfg = {**SMALL, "backbone_variant": "SimpleNetINE", "backbone_compute_dtype": None}
    init_fn, _ = JB.make_backbone_train_step(JaxConfig(**cfg))
    jb = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in batches[0][1].items()}
    with pytest.raises(KeyError):
        jax.eval_shape(init_fn, jax.random.PRNGKey(0), jb)
    init_fn, _ = B.make_backbone_train_step(PipelineConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="no batch statistics"):
        init_fn()


def test_cli_backbone_writes_a_checkpoint_both_engines_load(monkeypatch, tmp_path):
    """``--component backbone --steps 2 --device cpu`` at the small size:
    finite losses, and ``backbone_variables/backbone.npz`` in the JAX
    layout, which ``load_pipeline_variables`` loads into the gather and the
    block engine's pipeline variables."""
    from roreg_tpu_torch.cli import train as cli_train
    from roreg_tpu_torch.pipeline.extractor import make_backbone
    from roreg_tpu_torch.train.checkpoints import load_pipeline_variables
    from roreg_tpu_torch.weights import init_variables, load_variables

    small = lambda **kw: PipelineConfig(**{**kw, **SMALL})  # noqa: E731
    monkeypatch.setattr(cli_train, "PipelineConfig", small)
    monkeypatch.setattr(cli_train, "SCENE", {**SCENE, "num_clouds": 3})
    real = B.backbone_pair_batches
    monkeypatch.setattr(cli_train, "backbone_pair_batches",
                        lambda *a, **k: real(*a, **{**k, "max_pairs": MAX_PAIRS}))
    ckpt = tmp_path / "ckpt"
    res = cli_train.main(["--component", "backbone", "--steps", "2", "--device", "cpu",
                          "--synthetic_scenes", "1", "--group_size", "12", "--data_root", str(tmp_path / "data"),
                          "--checkpoint_dir", str(ckpt)])
    assert res["final_step"] == 2 and len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert (ckpt / "backbone_variables" / "backbone.npz").exists()
    for engine in ("gather", "block"):
        cfg = small(engine=engine, group_size=12)
        variables = init_variables(cfg, 1)
        assert load_pipeline_variables(str(ckpt), variables, cfg) == ["backbone"]
        load_variables(make_backbone(cfg, engine), variables["backbone"])
        with np.load(ckpt / "backbone_variables" / "backbone.npz") as z:
            flat = flatten_variables(variables["backbone"])
            assert all(np.array_equal(flat[k], z[k]) for k in z.files)
