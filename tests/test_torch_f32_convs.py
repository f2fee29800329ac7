"""f32 conv operands on the card (``backbone_compute_dtype=None``): the
two-term bf16 split's CPU model against the JAX package's f32 convs and
gradients, and the wrappers' routing of f32 operands to the kernels.

The kernels multiply bf16 on the tensor cores with f32 sums. An f32
operand runs as ``hi + lo`` (``kernels/split.py``): the f32 entries of
``gather_conv``, ``halo_conv`` and ``up_conv`` split each f32 feature or
region row on chip and run the three products ``Xh Wh + Xh Wl + Xl Wh``
against the ``[Wh ; Wl]`` weight slots of each module's
``pack_split_weights`` (``up_conv`` takes ``halo_conv``'s); the f32
entries of dgrad and wgrad run ``dYh Wh + dYh Wl + dYm
Wh`` and ``dYh Xh + dYh Xl + dYm Xh`` (dY's first two terms), W packed by
``pack_dgrad_split_weights`` and X split on chip. Here each of those is
modelled with the plain versions on the bf16 terms (exact products, f32
sums), at the magnitudes of the card smoke's phase 3b (features of unit
variance, He-scaled weights), and held to ``F32_RTOL`` of the output's
largest magnitude against the JAX package at f32; one bf16 rounding of
the operands misses that by far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_reference_native import reference_native  # noqa: E402,F401 (autouse: the JAX host library, built whole)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import roreg_tpu.sparse.block as jblock  # noqa: E402
from roreg_tpu.native.blockpyr import build_block_pyramid_host  # noqa: E402
from roreg_tpu.sparse.conv import gather_conv as jax_gather_conv  # noqa: E402
from roreg_tpu_torch.kernels import gather_conv as GC  # noqa: E402
from roreg_tpu_torch.kernels.block_gather import block_gather_plain  # noqa: E402
from roreg_tpu_torch.kernels.halo_conv import (  # noqa: E402
    F32_K_ORDER,
    HaloConvKernel,
    halo_conv_plain,
    pack_split_weights,
    pack_weights,
)
from roreg_tpu_torch.kernels.split import split_bf16x2  # noqa: E402
from roreg_tpu_torch.kernels.up_conv import UpConvKernel, up_conv_plain  # noqa: E402

# the kernels' f32 tolerance: 1e-4 of the output's largest magnitude (the
# split leaves about 3 * 2^-18 of each product)
F32_RTOL = 1e-4
VS = 0.05
BCAPS = (256, 128, 64, 32)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _he(rng, k, cin, cout, fan):
    return (rng.normal(size=(k, cin, cout)) * (2.0 / (fan * cin)) ** 0.5).astype(np.float32)


def test_split_leaves_two_to_the_minus_17():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32)) * 37.0
    hi, lo = split_bf16x2(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float(((hi.float() + lo.float()) - x).abs().max() / x.abs().max()) <= 2.0**-17
    # the f32 entries' weight slots: both terms, bf16, as many elements as w twice
    for slots in (pack_split_weights(torch.ones(27, 32, 64)),
                  GC.pack_split_weights(torch.ones(27, 32, 64))):
        assert slots.dtype == torch.bfloat16 and slots.numel() == 2 * 27 * 32 * 64 and slots.is_contiguous()


def _three_products(plain, x, w, *args):
    """What the f32 entries compute: ``Xh Wh + Xh Wl + Xl Wh`` with exact
    bf16 products and f32 sums (Xl Wl dropped)."""
    (xh, xl), (wh, wl) = split_bf16x2(x), split_bf16x2(w)
    return plain(xh, *args[:1], wh, *args[1:]) + plain(xh, *args[:1], wl, *args[1:]) \
        + plain(xl, *args[:1], wh, *args[1:])


def _gather_inputs(rng, n, m, k, cin, cout):
    nbr = rng.integers(0, n, size=(m, k))
    nbr[rng.random((m, k)) < 0.4] = -1
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    return feats, nbr.astype(np.int32), _he(rng, k, cin, cout, k)


@pytest.mark.parametrize("cin,cout", [(32, 64), (256, 128)])
def test_three_product_gather_conv_model_matches_jax_f32(cin, cout):
    """The three products ``Xh Wh + Xh Wl + Xl Wh`` (what the kernel's f32
    entry computes) against the JAX package's f32 gather conv."""
    rng = np.random.default_rng(cin)
    feats, nbr, w = _gather_inputs(rng, 900, 700, 27, cin, cout)
    ref = np.asarray(jax_gather_conv(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w)))
    model = _three_products(GC.gather_conv_plain, _t(feats), _t(w), _t(nbr))
    assert _rel(model.numpy(), ref) <= F32_RTOL
    one_term = GC.gather_conv_plain(_t(feats).bfloat16(), _t(nbr), _t(w).bfloat16())
    assert _rel(one_term.numpy(), ref) > 10 * F32_RTOL


@pytest.fixture(scope="module")
def pyr():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 1.6, size=(1500, 2))
    z = 0.25 * np.sin(xy[:, 0] * 5) * np.cos(xy[:, 1] * 4) + 0.02 * rng.normal(size=1500)
    p = build_block_pyramid_host(np.column_stack([xy, z]).astype(np.float32), VS, BCAPS)
    occ = [np.asarray(jblock.unpack_cell_occupancy(jnp.asarray(l.occ_words))) for l in p.levels]
    return p, occ


@pytest.mark.parametrize("kind,level,cin,cout", [("same", 0, 32, 32), ("same", 2, 128, 128),
                                                 ("down", 0, 32, 64), ("down", 2, 128, 256)])
def test_three_product_halo_conv_model_matches_jax_f32(pyr, kind, level, cin, cout):
    """halo_conv's three products (its f32 entry's arithmetic; the entry's
    K order changes only the order of f32 sums) against JAX ``conv_same`` /
    ``conv_down`` at f32."""
    p, occ = pyr
    rng = np.random.default_rng(level + cin)
    if kind == "same":
        tbl, mask, fn, span, stride = p.levels[level].same_tbl, occ[level], jblock.conv_same, 6, 1
    else:
        tbl, mask, fn, span, stride = p.down_tbl[level], occ[level + 1], jblock.conv_down, 9, 2
    feats = (rng.normal(size=(len(occ[level]), 64, cin)) * occ[level][..., None]).astype(np.float32)
    w = _he(rng, 27, cin, cout, 27)
    ref = np.asarray(fn(jnp.asarray(feats), jnp.asarray(tbl), jnp.asarray(w), jnp.asarray(mask)))
    model = _three_products(halo_conv_plain, _t(feats), _t(w), _t(tbl), _t(mask), span, stride)
    assert _rel(model.numpy(), ref) <= F32_RTOL
    one_term = halo_conv_plain(_t(feats).bfloat16(), _t(tbl), _t(w).bfloat16(), _t(mask), span, stride)
    assert _rel(one_term.numpy(), ref) > 10 * F32_RTOL


@pytest.mark.parametrize("level,cin,cout", [(0, 128, 64), (1, 256, 64), (2, 256, 128)])
def test_term_loop_up_conv_model_matches_jax_f32(pyr, level, cin, cout):
    """up_conv's f32 entry in one pass, in the kernel's order: for each
    16-channel chunk of a region part (128 channels; the second part's
    sums added to the first's as they are stored), the three products
    ``Xh Wh + Xh Wl + Xl Wh`` of the split region rows and weights added
    into the f32 sums; against JAX ``conv_up`` at f32, at the decoder's
    widths (Cin 256, two parts, included)."""
    p, occ = pyr
    rng = np.random.default_rng(level + 20)
    fc = (rng.normal(size=(len(occ[level + 1]), 64, cin)) * occ[level + 1][..., None]).astype(np.float32)
    w = _he(rng, 27, cin, cout, 8)
    tbl, mask = p.up_tbl[level], occ[level]
    ref = np.asarray(jblock.conv_up(jnp.asarray(fc), jnp.asarray(tbl), jnp.asarray(w), jnp.asarray(mask)))
    reg = block_gather_plain(_t(fc).reshape(-1, cin), _t(tbl))
    (rh, rl), (wh, wl) = split_bf16x2(reg), split_bf16x2(_t(w))
    m = _t(mask)
    model = torch.zeros(reg.shape[0], 64, cout)
    for part in range(0, cin, 128):
        sums = torch.zeros_like(model)
        for c in range(part, min(cin, part + 128), 16):
            ch = slice(c, c + 16)
            for x, wt in ((rh, wh), (rh, wl), (rl, wh)):
                sums += up_conv_plain(x[..., ch].contiguous(), wt[:, ch].contiguous(), m)
        model = model + sums
    assert _rel(model.numpy(), ref) <= F32_RTOL
    assert _rel(up_conv_plain(reg.bfloat16(), _t(w).bfloat16(), m).numpy(), ref) > 10 * F32_RTOL


@pytest.mark.parametrize("cin,cout", [(32, 32), (128, 256)])
def test_bwd_term_models_match_jax_f32_gradients(cin, cout):
    """dgrad over Wh and Wl, wgrad over Xh and Xl, with dY as f32 (as the
    bf16 entries' three-term split keeps it, to 2^-24), each pair summed,
    against JAX's f32 gradients of its gather conv: the two-term split of
    W or X alone keeps ``F32_RTOL``."""
    rng = np.random.default_rng(cin + 1)
    feats, nbr, w = _gather_inputs(rng, 900, 700, 27, cin, cout)
    dy = rng.normal(size=(700, cout)).astype(np.float32)

    def loss(x, wt):
        return jnp.sum(jax_gather_conv(x, jnp.asarray(nbr), wt) * jnp.asarray(dy))

    rdx, rdw = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w)))
    x, wt, tb, d = _t(feats), _t(w), _t(nbr), _t(dy)
    dx = sum(GC.gather_conv_dgrad_plain(x, tb, term.float(), d) for term in split_bf16x2(wt))
    dw = sum(GC.gather_conv_wgrad_plain(term.float(), tb, wt, d) for term in split_bf16x2(x))
    assert _rel(dx.numpy(), rdx) <= F32_RTOL and _rel(dw.numpy(), rdw) <= F32_RTOL
    assert _rel(GC.gather_conv_dgrad_plain(x, tb, wt.bfloat16().float(), d).numpy(), rdx) > 10 * F32_RTOL
    assert _rel(GC.gather_conv_wgrad_plain(x.bfloat16().float(), tb, wt, d).numpy(), rdw) > 10 * F32_RTOL


@pytest.mark.parametrize("cin,cout", [(32, 32), (128, 256)])
def test_kept_bwd_products_match_jax_f32_gradients(cin, cout):
    """The products the f32 entries of dgrad and wgrad keep, ``dYh Wh + dYh
    Wl + dYm Wh`` and ``dYh Xh + dYh Xl + dYm Xh`` (``dYh, dYm`` the first
    two of the bf16 entries' three dY terms, which are ``split_bf16x2``'s),
    against JAX's f32 gradients of its gather conv; the products they drop
    (dY's third term with Wh or Xh, ``dYm`` with Wl or Xl, the third term
    with Wl or Xl) sum to under a tenth of ``F32_RTOL``, and the first
    product alone misses it."""
    rng = np.random.default_rng(cin + 2)
    feats, nbr, w = _gather_inputs(rng, 900, 700, 27, cin, cout)
    dy = rng.normal(size=(700, cout)).astype(np.float32)

    def loss(x, wt):
        return jnp.sum(jax_gather_conv(x, jnp.asarray(nbr), wt) * jnp.asarray(dy))

    rdx, rdw = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w)))
    x, wt, tb, d = _t(feats), _t(w), _t(nbr), _t(dy)
    (dh, dm), (wh, wl), (xh, xl) = split_bf16x2(d), split_bf16x2(wt), split_bf16x2(x)
    dl = (d - dh.float() - dm.float()).bfloat16()

    def dgrad(wterm, dterm):
        return GC.gather_conv_dgrad_plain(x, tb, wterm.float(), dterm.float())

    def wgrad(xterm, dterm):
        return GC.gather_conv_wgrad_plain(xterm.float(), tb, wt, dterm.float())

    dx = dgrad(wh, dh) + dgrad(wl, dh) + dgrad(wh, dm)
    dw = wgrad(xh, dh) + wgrad(xl, dh) + wgrad(xh, dm)
    assert _rel(dx.numpy(), rdx) <= F32_RTOL and _rel(dw.numpy(), rdw) <= F32_RTOL
    dropped_dx = dgrad(wh, dl) + dgrad(wl, dm) + dgrad(wl, dl)
    dropped_dw = wgrad(xh, dl) + wgrad(xl, dm) + wgrad(xl, dl)
    assert float(dropped_dx.abs().max()) / np.abs(rdx).max() < F32_RTOL / 10
    assert float(dropped_dw.abs().max()) / np.abs(rdw).max() < F32_RTOL / 10
    assert _rel(dgrad(wh, dh).numpy(), rdx) > 10 * F32_RTOL
    assert _rel(wgrad(xh, dh).numpy(), rdw) > 10 * F32_RTOL


# (Cin, Cout) of the backbone training path's gather convs (chip_smoke.py
# CONV_SHAPES), and one that dgrad pads
TRAIN_WIDTHS = [(32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
                (256, 128), (256, 64), (128, 64), (48, 24)]


@pytest.mark.parametrize("cin,cout", TRAIN_WIDTHS)
def test_dgrad_split_weights_hold_both_terms_of_each_slot(cin, cout):
    """``pack_dgrad_split_weights``: each (offset, channel tile, 32-row Cout
    slot) of the f32 entry's ring holds that slot of
    ``pack_dgrad_weights(Wh)`` (where dgrad's bf16 entry reads it), then the
    same slot of ``pack_dgrad_weights(Wl)``, ``(Wh, Wl) =
    split_bf16x2(w)``, in one bf16 tensor with the padding zero."""
    w = torch.from_numpy(np.random.default_rng(cin + cout).normal(size=(27, cin, cout)).astype(np.float32))
    tile = min(next(c for c in GC.DGRAD_CINS if c >= cin), GC.DGRAD_CI_TILE)
    packed = GC.pack_dgrad_split_weights(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    slots = packed.view(-1, 2, 32 * tile)
    for term, half in zip(split_bf16x2(w), (0, 1)):
        assert torch.equal(slots[:, half], GC.pack_dgrad_weights(term).view(-1, 32 * tile))


@pytest.mark.parametrize("which", ["dgrad", "wgrad"])
def test_bwd_f32_operands_go_to_the_f32_entries_unsplit(which):
    """The backward wrappers' operand step: f32 operands go to the f32
    entry, dgrad's with ``pack_dgrad_split_weights``, wgrad's with the
    features themselves (nothing made of them: here they lie on the meta
    device, with no data); bf16 operands to the bf16 entry, dgrad's with
    ``pack_dgrad_weights``; no launch."""
    kernel = GC.GatherConvBwdKernel(which)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(27, 64, 32)).astype(np.float32))
    for dtype, pack in ((torch.float32, GC.pack_dgrad_split_weights), (torch.bfloat16, GC.pack_dgrad_weights)):
        feats, dy = torch.empty(100, 64, device="meta", dtype=dtype), torch.empty(40, 32, device="meta")
        name, a, b = kernel.operands(feats, w.to(dtype), dy)
        assert name == f"gather_conv_{which}" + ("_f32" if dtype == torch.float32 else "")
        if which == "dgrad":
            assert a is dy and torch.equal(b, pack(w.to(dtype)))
        else:
            assert a is feats and b is dy
    assert kernel.launches == 0


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_wrappers_route_f32_to_the_kernels(monkeypatch):
    """Off the CPU, f32 operands reach each kernel's wrapper as f32 (its f32
    entry), never a plain version or a bf16 cast: the gather conv with its
    gradient, the block engine's same, down and up convs, and the f32 skip
    concatenation is ``torch.cat`` (the kernels are stubbed on the meta
    device; the ``cuda`` tests launch them)."""
    import roreg_tpu_torch.kernels.block_gather as KB
    import roreg_tpu_torch.kernels.halo_conv as KH
    import roreg_tpu_torch.kernels.skip_concat as KS
    import roreg_tpu_torch.kernels.up_conv as KU
    from roreg_tpu_torch.sparse import block as tblock

    calls = []

    def stub(name, shape_of):
        def run(*a):
            calls.append((name, tuple(t.dtype for t in a if isinstance(t, torch.Tensor) and t.is_floating_point())))
            return torch.empty(shape_of(*a), device="meta")
        return run

    monkeypatch.setattr(GC, "gather_conv_kernel", stub("fwd", lambda f, n, w: (n.shape[0], w.shape[2])))
    monkeypatch.setattr(GC, "gather_conv_dgrad_kernel", stub("dgrad", lambda f, n, w, d: f.shape))
    monkeypatch.setattr(GC, "gather_conv_wgrad_kernel", stub("wgrad", lambda f, n, w, d: w.shape))
    monkeypatch.setattr(KH, "halo_conv_kernel", stub("halo", lambda f, t, w, m, s, st: (t.shape[0], 64, w.shape[2])))
    monkeypatch.setattr(KB, "block_gather_kernel", stub("block_gather", lambda s, t: (t.shape[0], 27, s.shape[1])))
    monkeypatch.setattr(KU, "up_conv_kernel", stub("up", lambda r, w, m: (r.shape[0], 64, w.shape[2])))
    monkeypatch.setattr(KS, "skip_concat_kernel", lambda *a: pytest.fail("skip_concat at f32"))
    for name in ("gather_conv_plain", "gather_conv_dgrad_plain", "gather_conv_wgrad_plain"):
        monkeypatch.setattr(GC, name, lambda *a: pytest.fail("a plain version off the CPU"))

    f32 = (torch.float32, torch.float32)
    out = GC.gather_conv(_meta(50, 64, grad=True), _meta(40, 27, dtype=torch.int32), _meta(27, 64, 32, grad=True))
    out.sum().backward()
    assert calls == [("fwd", f32), ("dgrad", f32 + (torch.float32,)), ("wgrad", f32 + (torch.float32,))]
    calls.clear()
    tbl, mask = _meta(6, 27, dtype=torch.int32), _meta(6, 64, dtype=torch.bool)
    tblock.conv_same(_meta(8, 64, 32), tbl, _meta(27, 32, 64), mask)
    tblock.conv_down(_meta(8, 64, 32), tbl, _meta(27, 32, 64), mask)
    tblock.conv_up(_meta(8, 64, 32), tbl, _meta(27, 32, 64), mask)
    assert calls == [("halo", f32), ("halo", f32), ("block_gather", (torch.float32,)), ("up", f32)]
    conv = tblock._BlockConv(32, 64, "up", None)
    assert conv.cat_input(_meta(6, 64, 32), _meta(6, 64, 16)).shape == (6, 64, 48)


@pytest.mark.parametrize("cin,cout", [(16, 32), (64, 128), (256, 256)])
def test_split_weight_slots_hold_the_terms_of_each_step(cin, cout):
    """Each kernel module's ``pack_split_weights`` against ``pack_weights``
    of the two terms of ``split_bf16x2(w)``: halo_conv's slot (chunk c, tap) is [Wh stage ; Wl
    stage] with the 16 input rows of both in ``F32_K_ORDER``;
    gather_conv's slot (offset k, 32-channel step c) the two Wh stages of
    the step, then its two Wl stages."""
    w = torch.from_numpy(np.random.default_rng(cin).normal(size=(27, cin, cout)).astype(np.float32))
    wh, wl = split_bf16x2(w)
    order = torch.tensor(F32_K_ORDER)
    perm = (torch.arange(cin).view(-1, 16)[:, order]).reshape(-1)
    halo = pack_split_weights(w)
    ph, pl = pack_weights(wh[:, perm]), pack_weights(wl[:, perm])
    for c in range(cin // 16):
        for tap in (0, 13, 26):
            assert torch.equal(halo[c, tap, 0], ph[c, tap]) and torch.equal(halo[c, tap, 1], pl[c, tap])
    if cin % 32:
        return
    gather = GC.pack_split_weights(w)
    gh, gl = pack_weights(wh, tap_major=True), pack_weights(wl, tap_major=True)
    for k in (0, 26):
        for c in range(cin // 32):
            assert torch.equal(gather[k, c, 0], gh[k, 2 * c:2 * c + 2])
            assert torch.equal(gather[k, c, 1], gl[k, 2 * c:2 * c + 2])


@pytest.mark.parametrize("kernel,entry,pack", [(HaloConvKernel, "halo_conv", pack_split_weights),
                                               (GC.GatherConvKernel, "gather_conv", GC.pack_split_weights),
                                               (UpConvKernel, "up_conv", pack_split_weights)])
def test_f32_operands_go_to_the_f32_entry_unsplit(kernel, entry, pack):
    """The wrappers' operand step: f32 operands go to the f32 entry with
    the split weight slots and nothing made of the features or the region
    (the step reads only their type: here they lie on the meta device,
    with no data); bf16 operands to the bf16 entry with ``pack_weights``."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(27, 64, 32)).astype(np.float32))
    name, wp = kernel.operands(torch.empty(100, 64, device="meta"), w)
    want = pack(w)
    assert name == f"{entry}_f32" and torch.equal(wp, want)
    name, wp = kernel.operands(torch.empty(100, 64, device="meta", dtype=torch.bfloat16), w.bfloat16())
    assert name == f"{entry}_bf16" and torch.equal(wp, pack_weights(w.bfloat16(), tap_major=entry == "gather_conv"))
