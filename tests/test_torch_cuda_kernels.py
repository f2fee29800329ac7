"""The block decoder's three kernels (skip_concat, cell_dense, up_conv) and
the gather engine's gather_conv: their wrappers on the CPU (dispatch,
argument checks, static maps, the work counts behind the card's bounds)
and, on a CUDA card, each kernel against its plain version at the smoke's
shapes scaled down, with absent (-1) entries and empty blocks.

This file imports no JAX, so its ``cuda`` tests run on the card box:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.kernels.block_gather import block_gather  # noqa: E402
from roreg_tpu_torch.kernels.cell_dense import (  # noqa: E402
    cell_dense,
    cell_dense_kernel,
    cell_dense_plain,
    dense_work,
)
from roreg_tpu_torch.kernels.gather_conv import (  # noqa: E402
    gather_conv,
    gather_conv_kernel,
    gather_conv_plain,
    pack_split_weights,
)
from roreg_tpu_torch.kernels.halo_conv import pack_weights  # noqa: E402
from roreg_tpu_torch.kernels.split import split_bf16x2  # noqa: E402
from roreg_tpu_torch.kernels.skip_concat import (  # noqa: E402
    concat_work,
    skip_concat,
    skip_concat_kernel,
    skip_concat_plain,
)
from roreg_tpu_torch.kernels.up_conv import (  # noqa: E402
    UP_CELL_INV,
    UP_CLASSES,
    up_class_split,
    up_class_table,
    up_conv,
    up_conv_kernel,
    up_conv_plain,
    up_work,
)

# bf16 products are exact in f32; kernel and plain version differ only by
# the order of the f32 sums (at most 8 taps x Cin terms)
UP_ATOL = 1e-3
# f32 FFMA against F.linear's f32 sums: the order of <= 96 terms differs
DENSE_RTOL = 1e-5
# gather_conv: bf16 products are exact in f32; only the order of the f32
# sums (at most K x Cin terms) differs
GATHER_ATOL = 1e-3

# (Cin, Cout) of the block decoder's three up convs
UP_WIDTHS = [(256, 128), (256, 64), (128, 64)]
# (Cin, Cout) of the gather engine's 11 conv shapes (ResUNetBN2C)
GATHER_WIDTHS = [(32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
                 (256, 128), (256, 64), (128, 64), (64, 64)]


def _stage_element(k, n):
    """Element offset of (k, n) inside a packed 16-row weight stage: byte
    (n/8)*256 + (k/8)*128 + (n%8)*16 + (k%8)*2, wgmma's K-major layout that
    csrc/hopper.cuh b_desc names."""
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def _region_inputs(rng, b, nsrc, cin, device="cpu"):
    """A (b, 27) up table into nsrc coarse cells with absent entries and
    whole padding blocks (all -1, no occupied cell), the coarse features,
    and a (b, 64) fine cell mask."""
    tbl = rng.integers(0, nsrc, size=(b, 27))
    tbl[rng.random((b, 27)) < 0.3] = -1
    mask = rng.random((b, 64)) < 0.4
    pad = rng.random(b) < 0.25
    mask[pad] = False
    tbl[pad] = -1
    feats = rng.normal(size=(nsrc, cin)).astype(np.float32)
    return (torch.from_numpy(tbl.astype(np.int32)).to(device), torch.from_numpy(feats).to(device),
            torch.from_numpy(mask).to(device))


def test_up_class_table_encodes_the_classes():
    """The kernel's constant maps hold each class's cells, tap count,
    weight rows and region rows, as the plain version reads them."""
    table = up_class_table()
    assert table.shape == (8, 81) and table.dtype == np.int32
    assert sorted(table[:, :8].reshape(-1).tolist()) == list(range(64))
    assert table[:, 8].sum() == 27
    for row, (cells, wrows, ridx) in zip(table, UP_CLASSES):
        k = len(wrows)
        assert np.array_equal(row[:8], cells) and row[8] == k
        assert np.array_equal(row[9: 9 + k], wrows)
        assert np.array_equal(row[17:].reshape(8, 8)[:, :k], ridx)
    assert np.array_equal(np.concatenate([c for c, _, _ in UP_CLASSES])[UP_CELL_INV], np.arange(64))


def test_up_class_split_covers_every_class_tap_once():
    """The two warpgroups run 4 classes each, 13 and 14 taps, and between
    them every (class, tap) pair, so every weight row, exactly once."""
    split = up_class_split()
    assert split.dtype == np.int32 and sorted(split.tolist()) == list(range(8))
    pairs = [(int(c), int(w)) for c in split for w in UP_CLASSES[c][1]]
    assert len(pairs) == len(set(pairs)) == 27
    assert sorted(w for _, w in pairs) == list(range(27))
    loads = sorted(sum(len(UP_CLASSES[c][1]) for c in half) for half in (split[:4], split[4:]))
    assert loads == [13, 14]


@pytest.mark.parametrize("cin,cout", UP_WIDTHS)
def test_up_conv_weights_sit_where_the_kernel_reads_them(cin, cout):
    """The producer warp reads stage (chunk c, tap) at (c * 27 + tap) *
    16 * Cout elements of the packed weights (csrc/up_conv.cu), and element
    (k, n) of it is w[tap, 16c + k, n]."""
    w = torch.arange(27 * cin * cout, dtype=torch.int32).view(27, cin, cout)
    flat = pack_weights(w).reshape(-1)
    c, tap, k, n = np.meshgrid(np.arange(cin // 16), np.arange(27), np.arange(16), np.arange(cout),
                               indexing="ij")
    where = (c * 27 + tap) * 16 * cout + _stage_element(k, n)
    assert torch.equal(flat[torch.from_numpy(where.reshape(-1))],
                       w[torch.from_numpy(tap.reshape(-1)), torch.from_numpy((16 * c + k).reshape(-1)),
                         torch.from_numpy(n.reshape(-1))])


@pytest.mark.parametrize("cin,cout,kvol", sorted(set((ci, co, 27) for ci, co in GATHER_WIDTHS))
                         + [(64, 32, 1), (32, 128, 8), (96, 64, 32)])
def test_gather_conv_weights_sit_where_the_kernel_reads_them(cin, cout, kvol):
    """The producer warp reads the weight stage of step (offset k,
    32-channel chunk c) at (k * Cin/16 + 2c) * 16 * Cout elements of the
    tap-major packed weights, its second 16 rows 16 * Cout elements on
    (csrc/gather_conv.cu); element (k', n) of half h is w[k, 32c + 16h + k', n]."""
    w = torch.arange(kvol * cin * cout, dtype=torch.int32).view(kvol, cin, cout)
    flat = pack_weights(w, tap_major=True).reshape(-1)
    assert flat.numel() == w.numel()
    k, c, h, kk, n = np.meshgrid(np.arange(kvol), np.arange(cin // 32), np.arange(2), np.arange(16),
                                 np.arange(cout), indexing="ij")
    where = ((k * (cin // 16) + 2 * c) * 16 + h * 16) * cout + _stage_element(kk, n)
    assert torch.equal(flat[torch.from_numpy(where.reshape(-1))],
                       w[torch.from_numpy(k.reshape(-1)), torch.from_numpy((32 * c + 16 * h + kk).reshape(-1)),
                         torch.from_numpy(n.reshape(-1))])


@pytest.mark.parametrize("cin,cout", sorted(set(GATHER_WIDTHS)))
def test_gather_conv_split_weights_sit_where_the_f32_entry_reads_them(cin, cout):
    """The f32 entry's producer copies the weights of step (offset k,
    32-channel chunk c) from (k * Cin/32 + c) * 64 * Cout elements of the
    packed weights: Wh's two 16-row stages, then Wl's, 16 * Cout elements
    each; element (k', n) of half h of term t is term t of w[k, 32c + 16h
    + k', n] (csrc/gather_conv.cu)."""
    kvol = 27
    w = torch.from_numpy(np.random.default_rng(cin).normal(size=(kvol, cin, cout)).astype(np.float32))
    flat = pack_split_weights(w).reshape(-1)
    assert flat.numel() == 2 * w.numel()
    k, c, t, h, kk, n = np.meshgrid(np.arange(kvol), np.arange(cin // 32), np.arange(2), np.arange(2),
                                    np.arange(16), np.arange(cout), indexing="ij")
    where = ((k * (cin // 32) + c) * 4 + t * 2 + h) * 16 * cout + _stage_element(kk, n)
    want = torch.stack(split_bf16x2(w))[torch.from_numpy(t.reshape(-1)), torch.from_numpy(k.reshape(-1)),
                                        torch.from_numpy((32 * c + 16 * h + kk).reshape(-1)),
                                        torch.from_numpy(n.reshape(-1))]
    assert torch.equal(flat[torch.from_numpy(where.reshape(-1))], want)


@pytest.mark.parametrize("cin,cout", [(48, 64), (512, 64), (128, 256), (128, 96), (16, 32)])
def test_up_conv_kernel_refuses_widths_it_does_not_take(cin, cout):
    """Cin a multiple of 32 up to 256 (the region stays in shared memory),
    Cout 32, 64 or 128; refused before any device is touched."""
    reg = torch.zeros(3, 27, cin, dtype=torch.bfloat16)
    w = torch.zeros(27, cin, cout, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up_conv kernel takes"):
        up_conv_kernel(reg, w, torch.zeros(3, 64, dtype=torch.bool))


@pytest.mark.parametrize("cin,cout,kvol", [(48, 64, 27), (64, 96, 27), (64, 512, 27), (32, 64, 33),
                                           (32, 64, 0)])
def test_gather_conv_kernel_refuses_widths_it_does_not_take(cin, cout, kvol):
    """Cin a multiple of 32, Cout 32, 64, 128 or 256, 1 <= K <= 32; refused
    before any device is touched."""
    feats = torch.zeros(10, cin, dtype=torch.bfloat16)
    nbr = torch.full((70, kvol), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="gather_conv kernel takes"):
        gather_conv_kernel(feats, nbr, torch.zeros(kvol, cin, cout, dtype=torch.bfloat16))


def test_up_conv_plain_is_the_transposed_conv():
    """Per output cell, the sum over its parity's taps of the region row at
    (u + d) / 2 times w[d], written out directly."""
    rng = np.random.default_rng(0)
    reg = torch.from_numpy(rng.normal(size=(3, 27, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(27, 8, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 64)) < 0.7)
    out = up_conv_plain(reg, w, mask)
    ref = torch.zeros(3, 64, 16)
    for u in range(64):
        ux, uy, uz = u // 16, (u // 4) % 4, u % 4
        for d in range(27):
            dx, dy, dz = d // 9 - 1, (d // 3) % 3 - 1, d % 3 - 1
            if (ux + dx) % 2 or (uy + dy) % 2 or (uz + dz) % 2:
                continue
            row = ((ux + dx) // 2) * 9 + ((uy + dy) // 2) * 3 + (uz + dz) // 2
            ref[:, u] += reg[:, row] @ w[d]
    ref = torch.where(mask[..., None], ref, torch.zeros(()))
    assert float((out - ref).abs().max()) <= 1e-4


def test_decoder_wrappers_dispatch_on_cpu():
    """CPU tensors take the plain versions and launch nothing; the kernels'
    own wrappers refuse them."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(5, 64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5, 64, 16)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    tbl, feats, mask = _region_inputs(rng, 6, 40, 16)
    reg = block_gather(feats, tbl)
    w = torch.from_numpy(rng.normal(size=(27, 16, 32)).astype(np.float32))
    kernels = (skip_concat_kernel, cell_dense_kernel, up_conv_kernel)
    before = [k.launches for k in kernels]
    assert torch.equal(skip_concat(a, b), skip_concat_plain(a, b))
    assert skip_concat(a, b).dtype == torch.bfloat16
    assert torch.equal(cell_dense(a, b, weight, bias, True), cell_dense_plain(a, b, weight, bias, True))
    assert torch.equal(up_conv(reg, w, mask), up_conv_plain(reg, w, mask))
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError):
        skip_concat_kernel(a, b)
    with pytest.raises(ValueError):
        cell_dense_kernel(a, b, weight, bias, True)
    with pytest.raises(ValueError):
        up_conv_kernel(reg.bfloat16(), w.bfloat16(), mask)


def test_cell_dense_plain_is_relu_of_the_two_slice_product():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40, 32)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    ref = torch.relu(a @ weight[:, :64].T + b @ weight[:, 64:].T)
    assert float((cell_dense_plain(a, b, weight, relu=True) - ref).abs().max()) <= 1e-4
    assert torch.equal(cell_dense_plain(a, None, weight[:, :64]), a @ weight[:, :64].T)


def test_decoder_work_counts():
    """Bytes count each input once and the output once; up_conv's
    operations count the taps of occupied cells into existing coarse
    cells only, its bytes the region rows those taps read."""
    a, b = torch.zeros(10, 64, 128), torch.zeros(10, 64, 128)
    assert concat_work(a, b) == (0, 2 * 10 * 64 * 128 * 6)
    weight, bias = torch.zeros(64, 96), torch.zeros(64)
    ops, nbytes = dense_work(torch.zeros(7, 64), torch.zeros(7, 32), weight, bias)
    assert ops == 2 * 7 * 96 * 64 and nbytes == 4 * (7 * 96 + 64 * 96 + 64 + 7 * 64)

    tbl = torch.full((2, 27), -1, dtype=torch.int32)
    tbl[0, 0] = 3  # region row 0: coarse cell (0, 0, 0)
    mask = torch.zeros(2, 64, dtype=torch.bool)
    mask[0, 0] = True  # cell (0, 0, 0): one tap (d = 0), region row 0
    mask[0, 21] = True  # cell (1, 1, 1): 8 taps, only d = (-1, -1, -1) reads row 0
    mask[1, 0] = True  # every region row of block 1 is absent
    cin, cout = 16, 32
    ops, nbytes = up_work(tbl, mask, cin, cout)
    assert ops == 2 * cin * cout * 2
    assert nbytes == 1 * cin * 2 + 2 * 64 + 27 * cin * cout * 2 + 2 * 64 * cout * 4


def test_dense_work_with_a_mask_counts_kept_rows():
    """With a row mask, reads and operations count the kept rows only; the
    f32 output of every row is written, and the mask is read once."""
    weight, bias = torch.zeros(64, 96), torch.zeros(64)
    mask = torch.zeros(5, 64, dtype=torch.bool)
    mask[0, :10] = True
    mask[3, 5] = True
    a, b = torch.zeros(5, 64, 64), torch.zeros(5, 64, 32)
    ops, nbytes = dense_work(a, b, weight, bias, mask)
    assert ops == 2 * 11 * 96 * 64
    assert nbytes == 4 * (11 * 96 + 64 * 96 + 64 + 5 * 64 * 64) + 5 * 64
    assert dense_work(a, b, weight, bias, torch.ones(5, 64, dtype=torch.bool)) == (
        dense_work(a, b, weight, bias)[0], dense_work(a, b, weight, bias)[1] + 5 * 64)


@pytest.mark.parametrize("bad,error,match", [
    (lambda m: m.to(torch.uint8), TypeError, "bool row_mask"),
    (lambda m: m[:, :32], ValueError, "rows' shape"),
    (lambda m: m.reshape(-1), ValueError, "rows' shape"),
    (lambda m: m.t().contiguous().t(), ValueError, "contiguous"),
    (lambda m: torch.empty(m.shape, dtype=torch.bool, device="meta"), ValueError, "inputs' device"),
], ids=["dtype", "shape", "flat", "strided", "device"])
def test_cell_dense_kernel_refuses_a_bad_mask(bad, error, match):
    a = torch.zeros(4, 64, 64)
    weight = torch.zeros(32, 64)
    mask = torch.ones(4, 64, dtype=torch.bool)
    with pytest.raises(error, match=match):
        cell_dense_kernel(a, None, weight, row_mask=bad(mask))


def test_masked_cell_dense_zeroes_unkept_rows_on_cpu():
    """The masked layer is the unmasked one with unkept rows set to zero,
    bias and ReLU included."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(3, 64, 64)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 64)) < 0.5)
    full = cell_dense(a, None, weight, bias, True)
    out = cell_dense(a, None, weight, bias, True, mask)
    assert torch.equal(out[mask], full[mask])
    assert not out[~mask].any()


def test_gather_conv_plain_refuses_out_of_range_entries():
    """An entry >= N is an error, not an absent row (the kernel traps)."""
    nbr = torch.full((2, 27), -1, dtype=torch.int32)
    nbr[0, 13] = 5
    with pytest.raises(IndexError):
        gather_conv(torch.ones(5, 32), nbr, torch.ones(27, 32, 32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 128), (256, 64)])
def test_kernel_matches_plain_on_gpu(cuda_device, cin, cout):
    """The gather-conv kernel against its plain version (run on the card)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, m = 3000, 2000 + 37  # a ragged last tile
    feats = torch.randn(n, cin, generator=g, device=cuda_device).bfloat16()
    nbr = torch.randint(-1, n, (m, 27), generator=g, device=cuda_device).to(torch.int32)
    w = (torch.randn(27, cin, cout, generator=g, device=cuda_device) * (2 / (27 * cin)) ** 0.5).bfloat16()
    before = gather_conv_kernel.launches
    out = gather_conv(feats, nbr, w)
    assert gather_conv_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert float((out - gather_conv_plain(feats, nbr, w)).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,ca,cb", [
    (517, 128, 128), (1031, 64, 64), (33, 64, 32),
    (1031, 64, 128),  # ResUNetBN2B, level 1
    (2053, 128, 64),  # ResUNetBN2D, level 0
    (2053, 128, 128),  # ResUNetBN2E, level 0
])
def test_skip_concat_kernel_matches_plain_on_gpu(cuda_device, blocks, ca, cb):
    """Bit-exact: the kernel copies and rounds to nearest even."""
    g = torch.Generator(device=cuda_device).manual_seed(blocks)
    a = torch.randn(blocks, 64, ca, generator=g, device=cuda_device)
    b = torch.randn(blocks, 64, cb, generator=g, device=cuda_device) * 1e3
    before = skip_concat_kernel.launches
    out = skip_concat(a, b)
    assert skip_concat_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (blocks, 64, ca + cb)
    assert torch.equal(out, skip_concat_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,ca,cb,n,bias,relu", [
    (301, 64, 32, 64, False, True),  # conv1_tr
    (301, 64, 0, 32, True, False),  # final
    (301, 64, 32, 32, False, True),  # ResUNetBN2's conv1_tr
    (301, 32, 0, 32, True, False),  # ResUNetBN2's final
    (301, 128, 128, 64, False, True),  # ResUNetBN2E's conv1_tr
])
def test_cell_dense_kernel_matches_plain_on_gpu(cuda_device, blocks, ca, cb, n, bias, relu):
    g = torch.Generator(device=cuda_device).manual_seed(ca + cb + n)
    rows = blocks * 64 + 5  # a ragged last tile
    a = torch.relu(torch.randn(rows, ca, generator=g, device=cuda_device))
    b = torch.relu(torch.randn(rows, cb, generator=g, device=cuda_device)) if cb else None
    weight = torch.randn(n, ca + cb, generator=g, device=cuda_device) / (ca + cb) ** 0.5
    bias_t = torch.randn(n, generator=g, device=cuda_device) if bias else None
    before = cell_dense_kernel.launches
    out = cell_dense(a, b, weight, bias_t, relu)
    assert cell_dense_kernel.launches == before + 1
    torch.cuda.synchronize()
    ref = cell_dense_plain(a, b, weight, bias_t, relu)
    assert out.shape == (rows, n) and out.dtype == torch.float32
    assert float(((out - ref).abs() / (ref.abs() + 1)).max()) <= DENSE_RTOL


def _dense_mask(blocks, pattern, device):
    """A (blocks, 64) row mask: "dead" keeps nothing, "mixed" keeps some rows
    of every third block and nothing in runs of padding blocks (a run of
    live blocks then a run of dead ones, as the host builder packs them)."""
    if pattern == "dead":
        return torch.zeros(blocks, 64, dtype=torch.bool, device=device)
    rng = np.random.default_rng(blocks)
    mask = rng.random((blocks, 64)) < 0.15
    mask[1::3] = False
    mask[blocks // 2: blocks // 2 + 9] = False
    mask[-3:] = False
    return torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["dead", "mixed"])
@pytest.mark.parametrize("blocks,ca,cb,n,bias,relu", [
    (301, 64, 32, 64, False, True),  # conv1_tr
    (301, 64, 0, 32, True, False),  # final
    (301, 64, 32, 32, False, True),  # ResUNetBN2's conv1_tr
    (301, 32, 0, 32, True, False),  # ResUNetBN2's final
    (301, 128, 128, 64, False, True),  # ResUNetBN2E's conv1_tr
])
def test_masked_cell_dense_kernel_matches_plain_on_gpu(cuda_device, pattern, blocks, ca, cb, n, bias,
                                                       relu):
    """All-dead tiles, and tiles mixing kept and masked rows with runs of
    dead tiles between; rows are whole blocks here, the ragged last tile is
    tested without a mask above and with one below."""
    g = torch.Generator(device=cuda_device).manual_seed(ca + cb + n + len(pattern))
    a = torch.relu(torch.randn(blocks, 64, ca, generator=g, device=cuda_device))
    b = torch.relu(torch.randn(blocks, 64, cb, generator=g, device=cuda_device)) if cb else None
    weight = torch.randn(n, ca + cb, generator=g, device=cuda_device) / (ca + cb) ** 0.5
    bias_t = torch.randn(n, generator=g, device=cuda_device) if bias else None
    mask = _dense_mask(blocks, pattern, cuda_device)
    before = cell_dense_kernel.launches
    out = cell_dense(a, b, weight, bias_t, relu, mask)
    assert cell_dense_kernel.launches == before + 1
    torch.cuda.synchronize()
    ref = cell_dense_plain(a, b, weight, bias_t, relu, mask)
    assert out.shape == (blocks, 64, n) and out.dtype == torch.float32
    assert float(((out - ref).abs() / (ref.abs() + 1)).max()) <= DENSE_RTOL
    assert not bool(out[~mask].any())


@pytest.mark.cuda
def test_masked_cell_dense_kernel_ragged_last_tile_on_gpu(cuda_device):
    """Rows that end mid-tile (not whole blocks), with a row mask."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    rows = 300 * 64 + 37
    a = torch.randn(rows, 64, generator=g, device=cuda_device)
    b = torch.randn(rows, 32, generator=g, device=cuda_device)
    weight = torch.randn(64, 96, generator=g, device=cuda_device) / 96 ** 0.5
    mask = torch.rand(rows, generator=g, device=cuda_device) < 0.3
    mask[-20:] = True
    out = cell_dense(a, b, weight, None, True, mask)
    torch.cuda.synchronize()
    ref = cell_dense_plain(a, b, weight, None, True, mask)
    assert float(((out - ref).abs() / (ref.abs() + 1)).max()) <= DENSE_RTOL
    assert not bool(out[~mask].any())


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,cin,cout", [
    (203, 256, 128), (405, 256, 64), (1213, 128, 64),
    (611, 192, 64),  # ResUNetBN2B's conv3_tr, ResUNetBN2D's conv2_tr
    (2053, 256, 128),  # ResUNetBN2E's conv2_tr, level 0
])
def test_up_conv_kernel_matches_plain_on_gpu(cuda_device, blocks, cin, cout):
    """Absent region cells, whole padding blocks and a block count that is
    no multiple of the kernel's four blocks per thread block."""
    rng = np.random.default_rng(cin + cout)
    tbl, feats, mask = _region_inputs(rng, blocks, 900, cin, cuda_device)
    reg = block_gather(feats.bfloat16(), tbl)
    w = (torch.randn(27, cin, cout, device=cuda_device) * (2 / (8 * cin)) ** 0.5).bfloat16()
    before = up_conv_kernel.launches
    out = up_conv(reg, w, mask)
    assert up_conv_kernel.launches == before + 1
    torch.cuda.synchronize()
    ref = up_conv_plain(reg, w, mask)
    assert out.dtype == torch.float32 and out.shape == (blocks, 64, cout)
    assert float((out - ref).abs().max()) <= UP_ATOL
    assert bool((out[~mask] == 0).all())


def _dead_run_mask(blocks, device):
    """A (blocks, 64) fine cell mask with runs of live blocks, runs of dead
    blocks longer than a thread block's 16, single dead blocks between live
    ones, and a dead tail."""
    rng = np.random.default_rng(blocks)
    mask = rng.random((blocks, 64)) < 0.3
    mask[5] = False  # one dead block between live ones
    mask[40:90] = False  # a run of dead blocks
    mask[100::7] = False
    mask[-20:] = False
    return torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,cin,cout", [
    (203, 256, 128), (405, 256, 64), (1213, 128, 64),
    (611, 192, 64),  # ResUNetBN2B's conv3_tr, ResUNetBN2D's conv2_tr
    (2053, 256, 128),  # ResUNetBN2E's conv2_tr, level 0
])
def test_up_conv_kernel_dead_runs_on_gpu(cuda_device, blocks, cin, cout):
    """Runs of dead fine blocks, a dead block between live ones and a block
    count that is no multiple of the blocks per thread block; the dead
    blocks' outputs are exactly 0."""
    rng = np.random.default_rng(blocks + cin)
    tbl, feats, _ = _region_inputs(rng, blocks, 900, cin, cuda_device)
    mask = _dead_run_mask(blocks, cuda_device)
    reg = block_gather(feats.bfloat16(), tbl)
    w = (torch.randn(27, cin, cout, device=cuda_device) * (2 / (8 * cin)) ** 0.5).bfloat16()
    shape = up_conv_kernel.launch_shape(cin, cout)
    assert blocks % shape["blocks_per_cta"] != 0
    out = up_conv(reg, w, mask)
    torch.cuda.synchronize()
    assert float((out - up_conv_plain(reg, w, mask)).abs().max()) <= UP_ATOL
    assert bool((out[~mask] == 0).all())


def _gather_table(rng, m, n, kvol):
    """An (m, kvol) table into n rows with absent entries, whole tiles of
    padding (all -1), tiles whose rows use only offsets 0 and kvol // 2, and
    a ragged last tile."""
    nbr = rng.integers(0, n, size=(m, kvol))
    nbr[rng.random((m, kvol)) < 0.4] = -1
    nbr[64:192] = -1  # two tiles of padding
    few = nbr[256:320]
    keep = np.zeros(kvol, bool)
    keep[[0, kvol // 2]] = True
    few[:, ~keep] = -1
    nbr[-100:] = -1  # padding rows across the last tiles
    return nbr.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", GATHER_WIDTHS)
def test_gather_conv_kernel_tiles_on_gpu(cuda_device, cin, cout):
    """Each of the gather engine's 11 widths, with tiles of padding, tiles
    that use a few offsets and a ragged last tile; two launches on the same
    inputs are bit-equal."""
    rng = np.random.default_rng(cin * 1000 + cout)
    n, m = 2500, 64 * 9 + 37
    nbr = torch.from_numpy(_gather_table(rng, m, n, 27)).to(cuda_device)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(27, cin, cout, device=cuda_device) * (2 / (27 * cin)) ** 0.5).bfloat16()
    out = gather_conv(feats, nbr, w)
    again = gather_conv(feats, nbr, w)
    torch.cuda.synchronize()
    assert float((out - gather_conv_plain(feats, nbr, w)).abs().max()) <= GATHER_ATOL
    assert torch.equal(out, again)
    assert not bool(out[64:192].any())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kvol", [(256, 256, 27), (128, 64, 27), (256, 32, 9)])
def test_gather_conv_cluster_split_on_gpu(cuda_device, cin, cout, kvol):
    """A coarse-level tile whose offsets the kernel splits between the
    thread blocks of a cluster, at sizes with fewer offsets than blocks
    too: within tolerance of the plain version, and bit-equal twice."""
    n, m = 400, 150
    shape = gather_conv_kernel.launch_shape(m, cin, cout, kvol)
    assert shape["cluster_split"] > 1
    rng = np.random.default_rng(kvol)
    nbr = rng.integers(-1, n, size=(m, kvol)).astype(np.int32)
    nbr[100:, 2:] = -1  # a tile with two offsets
    nbr = torch.from_numpy(nbr).to(cuda_device)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(kvol, cin, cout, device=cuda_device) * (2 / (kvol * cin)) ** 0.5).bfloat16()
    out = gather_conv(feats, nbr, w)
    again = gather_conv(feats, nbr, w)
    torch.cuda.synchronize()
    assert float((out - gather_conv_plain(feats, nbr, w)).abs().max()) <= GATHER_ATOL
    assert torch.equal(out, again)


OUT_OF_RANGE = """
import torch
from roreg_tpu_torch.kernels.gather_conv import gather_conv
nbr = torch.full((64, 27), -1, dtype=torch.int32, device="cuda")
nbr[0, 13] = 5
feats = torch.ones(5, 32, dtype=torch.bfloat16, device="cuda")
gather_conv(feats, nbr, torch.ones(27, 32, 32, dtype=torch.bfloat16, device="cuda"))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
def test_gather_conv_raises_on_out_of_range_entries_on_gpu(cuda_device):
    """An entry >= N makes the kernel trap, which the next synchronisation
    raises as a CUDA error (in a child process: the trap leaves the CUDA
    context unusable)."""
    import subprocess
    import sys

    run = subprocess.run(
        [sys.executable, "-c", OUT_OF_RANGE], capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert run.returncode != 0
    assert "CUDA error" in run.stderr


# the gather conv's two backward kernels: f32 sums with atomic adds, in
# another order than the plain version's autograd (at most K x Cout terms
# for dX, M terms for dW, of products of magnitude <~ 1)
BWD_ATOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kvol", [(32, 32, 27), (64, 128, 27), (256, 256, 27), (16, 16, 27),
                                           (48, 24, 7), (32, 64, 40)])
def test_gather_conv_bwd_kernels_match_plain_on_gpu(cuda_device, cin, cout, kvol):
    """dgrad and wgrad against their plain versions (autograd through
    gather_conv_plain), with padding rows, tiles that use few offsets, a
    ragged last tile, and widths and kernel volumes the forward kernel
    does not take directly."""
    from roreg_tpu_torch.kernels.gather_conv import (
        gather_conv_dgrad, gather_conv_dgrad_kernel, gather_conv_dgrad_plain,
        gather_conv_wgrad, gather_conv_wgrad_kernel, gather_conv_wgrad_plain,
    )

    rng = np.random.default_rng(cin + cout + kvol)
    n, m = 2500, 64 * 9 + 37
    nbr = torch.from_numpy(_gather_table(rng, m, n, kvol)).to(cuda_device)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(kvol, cin, cout, device=cuda_device) * (2 / (kvol * cin)) ** 0.5).bfloat16()
    dy = torch.randn(m, cout, device=cuda_device)
    dy[-100:] = 0.0  # padding rows get no gradient
    before = (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches)
    dx = gather_conv_dgrad(feats, nbr, w, dy)
    dw = gather_conv_wgrad(feats, nbr, w, dy)
    assert (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert dx.dtype == torch.float32 and dx.shape == feats.shape and dw.shape == w.shape
    assert float((dx - gather_conv_dgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL
    assert float((dw - gather_conv_wgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL
    unused = torch.ones(n, dtype=torch.bool, device=cuda_device)
    unused[nbr[nbr >= 0].long()] = False
    assert not bool(dx[unused].any())


@pytest.mark.cuda
def test_gather_conv_with_a_gradient_runs_the_kernels_on_gpu(cuda_device):
    """A CUDA tensor that needs a gradient goes through GatherConvFn: one
    forward launch, then one dgrad and one wgrad launch; its gradients
    equal autograd through the plain version within the tolerance (bf16
    once rounded)."""
    from roreg_tpu_torch.kernels.gather_conv import gather_conv_dgrad_kernel, gather_conv_wgrad_kernel

    rng = np.random.default_rng(11)
    n, m, cin, cout = 1800, 1500, 64, 32
    nbr = torch.from_numpy(_gather_table(rng, m, n, 27)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).requires_grad_()
    w = (torch.randn(27, cin, cout, device=cuda_device) * 0.05).requires_grad_()
    dy = torch.randn(m, cout, device=cuda_device)
    counts = lambda: (gather_conv_kernel.launches, gather_conv_dgrad_kernel.launches,  # noqa: E731
                      gather_conv_wgrad_kernel.launches)
    before = counts()
    out = gather_conv(x.bfloat16(), nbr, w.bfloat16())
    assert type(out.grad_fn).__name__ == "GatherConvFnBackward"
    out.backward(dy)
    assert counts() == tuple(c + 1 for c in before)
    x2, w2 = x.detach().bfloat16().float().requires_grad_(), w.detach().bfloat16().float().requires_grad_()
    gather_conv_plain(x2, nbr, w2).backward(dy)
    torch.cuda.synchronize()
    # one bf16 rounding of each gradient: relative 2^-8 of its value
    for got, want in ((x.grad, x2.grad), (w.grad, w2.grad)):
        assert float((got - want.bfloat16().float()).abs().max()) <= BWD_ATOL + float(want.abs().max()) * 2 ** -8


@pytest.mark.cuda
def test_gather_conv_bwd_kernels_on_an_empty_table_on_gpu(cuda_device):
    """A table whose entries are all -1: one launch each, and dX and dW are
    exactly zero (every tile and row group leaves after reading its
    entries)."""
    from roreg_tpu_torch.kernels.gather_conv import gather_conv_dgrad_kernel, gather_conv_wgrad_kernel

    n, m, cin, cout = 700, 1000, 64, 128
    nbr = torch.full((m, 27), -1, dtype=torch.int32, device=cuda_device)
    feats = torch.randn(n, cin, device=cuda_device).bfloat16()
    w = torch.randn(27, cin, cout, device=cuda_device).bfloat16()
    dy = torch.randn(m, cout, device=cuda_device)
    before = (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches)
    dx = gather_conv_dgrad_kernel(feats, nbr, w, dy)
    dw = gather_conv_wgrad_kernel(feats, nbr, w, dy)
    torch.cuda.synchronize()
    assert (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert dx.shape == (n, cin) and dw.shape == (27, cin, cout)
    assert not bool(dx.any()) and not bool(dw.any())


@pytest.mark.cuda
def test_gather_conv_bwd_kernels_sum_repeated_targets_on_gpu(cuda_device):
    """A custom region in which one row's two offsets name the same source
    row (and other rows name it too): dgrad's atomic adds must sum every
    product into it, and wgrad must count the row once per offset."""
    from roreg_tpu_torch.kernels.gather_conv import (
        gather_conv_dgrad, gather_conv_dgrad_plain, gather_conv_wgrad, gather_conv_wgrad_plain,
    )

    rng = np.random.default_rng(5)
    n, m, kvol, cin, cout = 300, 200, 9, 32, 64
    nbr = rng.integers(-1, n, size=(m, kvol)).astype(np.int32)
    nbr[7, 2] = nbr[7, 6] = 17  # one row's two offsets, one source row
    nbr[130, 2] = nbr[150, 4] = 17
    nbr = torch.from_numpy(nbr).to(cuda_device)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(kvol, cin, cout, device=cuda_device) * (2 / (kvol * cin)) ** 0.5).bfloat16()
    dy = torch.randn(m, cout, device=cuda_device)
    dx = gather_conv_dgrad(feats, nbr, w, dy)
    dw = gather_conv_wgrad(feats, nbr, w, dy)
    torch.cuda.synchronize()
    want = gather_conv_dgrad_plain(feats, nbr, w, dy)
    assert float((dx - want).abs().max()) <= BWD_ATOL
    wf, d = w.float(), dy
    row17 = d[7] @ wf[2].T + d[7] @ wf[6].T + d[130] @ wf[2].T + d[150] @ wf[4].T
    others = [(r, k) for r, k in zip(*np.nonzero(nbr.cpu().numpy() == 17)) if (r, k) not in
              {(7, 2), (7, 6), (130, 2), (150, 4)}]
    for r, k in others:
        row17 = row17 + d[r] @ wf[k].T
    assert float((dx[17] - row17).abs().max()) <= BWD_ATOL
    assert float((dw - gather_conv_wgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL


@pytest.mark.cuda
def test_gather_conv_bwd_kernels_at_a_coarse_level_on_gpu(cuda_device):
    """The coarsest level's shape: Cin = Cout = 256, K = 27, 4096 capacity
    rows of which the first 412 are live (7 live tiles of 64): dgrad cuts
    each tile's offsets between thread blocks, and both kernels match their
    plain versions."""
    from roreg_tpu_torch.kernels.gather_conv import (
        gather_conv_dgrad_kernel, gather_conv_dgrad_plain, gather_conv_wgrad_kernel, gather_conv_wgrad_plain,
    )

    rng = np.random.default_rng(27)
    cap, live, c = 4096, 412, 256
    nbr = rng.integers(0, live, size=(cap, 27))
    nbr[rng.random((cap, 27)) < 0.5] = -1
    nbr[live:] = -1
    nbr = torch.from_numpy(nbr.astype(np.int32)).to(cuda_device)
    assert int((nbr >= 0).view(-1, 64 * 27).any(1).sum()) == 7
    assert gather_conv_dgrad_kernel.launch_shape(cap, c, c, 27)["offsets_per_block"] < 27
    feats = torch.from_numpy(rng.normal(size=(cap, c)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(27, c, c, device=cuda_device) * (2 / (27 * c)) ** 0.5).bfloat16()
    dy = torch.randn(cap, c, device=cuda_device)
    dy[live:] = 0.0
    dx = gather_conv_dgrad_kernel(feats, nbr, w, dy)
    dw = gather_conv_wgrad_kernel(feats, nbr, w, dy)
    torch.cuda.synchronize()
    assert float((dx - gather_conv_dgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL
    assert float((dw - gather_conv_wgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL
    assert not bool(dx[live:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 24), (3, 7)])
def test_gather_conv_bwd_kernels_pad_widths_of_40_offsets_on_gpu(cuda_device, cin, cout):
    """K = 40 (more offsets than one dgrad thread block lists) at widths the
    kernels do not take natively: the wrapper pads Cin (and dgrad's odd
    Cout; wgrad adds an odd Cout's columns one at a time), one launch a
    call, and both match their plain versions."""
    from roreg_tpu_torch.kernels.gather_conv import (
        gather_conv_dgrad_kernel, gather_conv_dgrad_plain, gather_conv_wgrad_kernel, gather_conv_wgrad_plain,
    )

    rng = np.random.default_rng(cin * cout)
    n, m, kvol = 900, 64 * 5 + 11, 40
    nbr = torch.from_numpy(_gather_table(rng, m, n, kvol)).to(cuda_device)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda_device).bfloat16()
    w = (torch.randn(kvol, cin, cout, device=cuda_device) * (2 / (kvol * cin)) ** 0.5).bfloat16()
    dy = torch.randn(m, cout, device=cuda_device)
    before = (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches)
    dx = gather_conv_dgrad_kernel(feats, nbr, w, dy)
    dw = gather_conv_wgrad_kernel(feats, nbr, w, dy)
    assert (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert dx.shape == (n, cin) and dw.shape == (kvol, cin, cout)
    assert float((dx - gather_conv_dgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL
    assert float((dw - gather_conv_wgrad_plain(feats, nbr, w, dy)).abs().max()) <= BWD_ATOL


BWD_OUT_OF_RANGE = """
import torch
from roreg_tpu_torch.kernels.gather_conv import gather_conv_{which}_kernel as kernel
nbr = torch.full((64, 27), -1, dtype=torch.int32, device="cuda")
nbr[0, 13] = 5
feats = torch.ones(5, 32, dtype=torch.bfloat16, device="cuda")
kernel(feats, nbr, torch.ones(27, 32, 32, dtype=torch.bfloat16, device="cuda"),
       torch.ones(64, 32, device="cuda"))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dgrad", "wgrad"])
def test_gather_conv_bwd_kernels_raise_on_out_of_range_entries_on_gpu(cuda_device, which):
    """An entry >= N makes dgrad and wgrad trap, which the next
    synchronisation raises as a CUDA error (in a child process, as for the
    forward)."""
    import subprocess
    import sys

    run = subprocess.run(
        [sys.executable, "-c", BWD_OUT_OF_RANGE.format(which=which)], capture_output=True, text=True,
        timeout=300, cwd=Path(__file__).resolve().parents[1],
    )
    assert run.returncode != 0
    assert "CUDA error" in run.stderr


# f32 operands: two bf16 terms of each operand on the tensor cores (three
# products, about 3 * 2^-18 of each product lost), held to 1e-4 of the
# output's largest magnitude against the f32 plain version with TF32 off
F32_RTOL = 1e-4


@pytest.fixture
def exact_f32(cuda_device):
    """TF32 off for cuBLAS and cuDNN while a test runs, so that the f32
    plain versions are f32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kvol,launches", [(32, 32, 27, 1), (256, 256, 27, 1), (64, 64, 40, 2)])
def test_gather_conv_kernel_f32_on_gpu(exact_f32, cin, cout, kvol, launches):
    """f32 features and weights, narrow, wide and with more offsets than one
    launch takes: one launch of the f32 entry per 32 offsets (each gathered
    row split on chip, three products a step), within ``F32_RTOL`` of the
    f32 plain version, bit-equal twice; the launch shapes of both entries."""
    dev = exact_f32
    rng = np.random.default_rng(cin + cout + kvol)
    n, m = 2500, 64 * 9 + 37
    nbr = torch.from_numpy(_gather_table(rng, m, n, kvol)).to(dev)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(dev)
    w = torch.randn(kvol, cin, cout, device=dev) * (2 / (kvol * cin)) ** 0.5
    before = gather_conv_kernel.launches
    out = gather_conv(feats, nbr, w)
    assert gather_conv_kernel.launches == before + launches
    again = gather_conv(feats, nbr, w)
    torch.cuda.synchronize()
    ref = gather_conv_plain(feats, nbr, w)
    assert out.dtype == torch.float32 and out.shape == (m, cout)
    assert _f32_err(out, ref) <= F32_RTOL
    assert _f32_err(gather_conv_plain(feats.bfloat16(), nbr, w.bfloat16()), ref) > 10 * F32_RTOL
    assert torch.equal(out, again)
    assert not bool(out[64:192].any())
    # the launch shapes the kernel reports (csrc/gather_conv.cu's Layout): at
    # least three slots, two steps gathered ahead of the one multiplied;
    # within 100 KB and its barriers, two thread blocks an SM, but the f32
    # entry at Cout 256
    for f32 in (False, True):
        shape = gather_conv_kernel.launch_shape(m, cin, cout, min(kvol, 32), f32)
        assert shape["rows_per_cta"] == 64 and shape["stages"] >= 3
        assert shape["channels_per_step"] == (64 if not f32 and cin % 64 == 0 and cout == 128 else 32)
        assert shape["smem_bytes"] <= 102400 + 16 * shape["stages"] or (f32 and cout == 256)


def _peak_above(fn):
    """``fn()`` and the device memory its call took at its peak beyond what
    was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kvol", [(32, 32, 27), (256, 256, 27), (48, 24, 7)])
def test_gather_conv_bwd_kernels_f32_on_gpu(exact_f32, cin, cout, kvol):
    """dgrad and wgrad with f32 operands: one launch of the f32 entry per
    call (W or X split into two bf16 terms on chip or in dgrad's one weight
    packing), within ``F32_RTOL`` of the f32 plain versions, a second call
    within ``F32_RTOL`` of the first (f32 atomics: not bit-equal), and no
    device memory beyond the launch's output (and its cut, where the width
    was padded), the packed weights and wgrad's dY scratch: no split copy
    of W or X, no second output (either would take over 300 KB here)."""
    from roreg_tpu_torch.kernels.gather_conv import (
        bwd_kernel_widths, gather_conv_dgrad, gather_conv_dgrad_kernel, gather_conv_dgrad_plain,
        gather_conv_wgrad, gather_conv_wgrad_kernel, gather_conv_wgrad_plain, pack_dgrad_split_weights,
    )

    dev = exact_f32
    rng = np.random.default_rng(cin + cout + kvol + 1)
    n, m = 2500, 64 * 9 + 37
    nbr = torch.from_numpy(_gather_table(rng, m, n, kvol)).to(dev)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(dev)
    w = torch.randn(kvol, cin, cout, device=dev) * (2 / (kvol * cin)) ** 0.5
    dy = torch.randn(m, cout, device=dev)
    dy[-100:] = 0.0
    before = (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches)
    dx = gather_conv_dgrad(feats, nbr, w, dy)
    dw = gather_conv_wgrad(feats, nbr, w, dy)
    assert (gather_conv_dgrad_kernel.launches, gather_conv_wgrad_kernel.launches) == (before[0] + 1, before[1] + 1)
    again_dx, again_dw = gather_conv_dgrad(feats, nbr, w, dy), gather_conv_wgrad(feats, nbr, w, dy)
    torch.cuda.synchronize()
    assert dx.shape == feats.shape and dw.shape == w.shape
    assert _f32_err(dx, gather_conv_dgrad_plain(feats, nbr, w, dy)) <= F32_RTOL
    assert _f32_err(dw, gather_conv_wgrad_plain(feats, nbr, w, dy)) <= F32_RTOL
    assert _f32_err(again_dx, dx) <= F32_RTOL and _f32_err(again_dw, dw) <= F32_RTOL
    del again_dx, again_dw
    scratch = gather_conv_wgrad_kernel.launch_shape(m, cin, cout, kvol, True)["scratch_bytes"]
    for which, call, operand in (
            ("dgrad", gather_conv_dgrad, lambda: pack_dgrad_split_weights(w)),
            ("wgrad", gather_conv_wgrad, lambda: torch.empty(scratch, dtype=torch.uint8, device=dev))):
        kin = bwd_kernel_widths(which, cin, cout)[0]
        _, operand_peak = _peak_above(operand)
        out, peak = _peak_above(lambda: call(feats, nbr, w, dy))
        launch_out = out.numel() // cin * kin * 4
        cut = out.numel() * 4 if kin != cin else 0
        assert peak - launch_out - cut - operand_peak <= 64 << 10, which
        del out


@pytest.mark.cuda
def test_voxelize_divides_exactly_on_gpu(cuda_device):
    """Points one ulp from voxel faces (k * vs in f32, k != 0), where
    ``floor(p / vs)`` and ``floor(p * (1 / vs))`` differ for some:
    ``voxelize`` on the card gives every leaf that it gives on the CPU, an
    exact f32 division on both as in the JAX package, while a division by
    the Python number on the card (a product with the reciprocal) puts
    some of them into other voxels."""
    from roreg_tpu_torch.sparse.voxelize import voxelize

    rng = np.random.default_rng(5)
    vs = 0.05
    k = rng.integers(1, 200, size=(6000, 3)) * rng.choice([-1, 1], size=(6000, 3))
    faces = k.astype(np.float32) * np.float32(vs)
    side = rng.integers(-1, 2, size=faces.shape)
    pts = np.where(side < 0, np.nextafter(faces, np.float32(-np.inf)),
                   np.where(side > 0, np.nextafter(faces, np.float32(np.inf)), faces)).astype(np.float32)
    assert (np.floor(pts / np.float32(vs)) != np.floor(pts * (np.float32(1) / np.float32(vs)))).any()
    p_cpu, mask = torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool)
    p_gpu = p_cpu.to(cuda_device)
    assert bool((torch.floor(p_gpu / vs).cpu() != torch.floor(p_cpu / vs)).any())
    cpu = voxelize(p_cpu, mask, vs, 16384)
    gpu = voxelize(p_gpu, mask.to(cuda_device), vs, 16384)
    for name, a, b in zip(cpu._fields, cpu, gpu):
        assert torch.equal(a, b.cpu()), name
