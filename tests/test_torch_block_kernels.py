"""The block engine's two kernels, block_gather and halo_conv: their wrappers
on the CPU (dispatch, argument checks, the work counts behind the card's
bounds) and, on a CUDA card, each kernel against its plain version.

This file imports no JAX, so its ``cuda`` tests run on the card box:
``python -m pytest tests/test_torch_block_kernels.py -m cuda -q``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from roreg_tpu_torch.kernels.block_gather import (  # noqa: E402
    block_gather,
    block_gather_kernel,
    block_gather_plain,
    gather_work,
)
from roreg_tpu_torch.kernels.halo_conv import (  # noqa: E402
    halo_conv,
    halo_conv_kernel,
    halo_conv_plain,
    halo_maps,
    halo_work,
    pack_weights,
)

# bf16 products are exact in f32; kernel and plain version differ only by
# the order of the f32 sums (27 * Cin terms)
HALO_ATOL = 1e-3


def _blocks(rng, b, nsrc, absent=0.3):
    """A (b, 27) table into nsrc source blocks with some entries -1 and
    centre entries present, and a (b, 64) cell mask with some empty blocks."""
    tbl = rng.integers(0, nsrc, size=(b, 27))
    tbl[rng.random((b, 27)) < absent] = -1
    tbl[:, 13] = rng.integers(0, nsrc, size=b)
    mask = rng.random((b, 64)) < 0.4
    mask[rng.random(b) < 0.25] = False  # whole padding blocks
    return tbl.astype(np.int32), mask


def test_block_gather_plain_zero_rows():
    src = torch.arange(12, dtype=torch.float32).view(4, 3)
    tbl = torch.tensor([[0, -1, 3], [-1, -1, -1]], dtype=torch.int16)
    out = block_gather_plain(src, tbl)
    assert out.shape == (2, 3, 3) and out.dtype == torch.float32
    assert torch.equal(out[0, 0], src[0]) and torch.equal(out[0, 2], src[3])
    assert not out[0, 1].any() and not out[1].any()


def test_wrappers_dispatch_on_cpu():
    """CPU tensors take the plain versions and launch nothing; the kernels'
    own wrappers refuse them."""
    rng = np.random.default_rng(0)
    tbl, mask = _blocks(rng, 6, 5)
    tbl, mask = torch.from_numpy(tbl), torch.from_numpy(mask)
    feats = torch.from_numpy(rng.normal(size=(5, 64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(27, 16, 32)).astype(np.float32))
    before = (block_gather_kernel.launches, halo_conv_kernel.launches)
    assert torch.equal(block_gather(feats.view(5, -1), tbl), block_gather_plain(feats.view(5, -1), tbl))
    assert torch.equal(halo_conv(feats, tbl, w, mask, 6, 1), halo_conv_plain(feats, tbl, w, mask, 6, 1))
    assert (block_gather_kernel.launches, halo_conv_kernel.launches) == before
    with pytest.raises(ValueError):
        block_gather_kernel(feats.view(5, -1).bfloat16(), tbl)
    with pytest.raises(ValueError):
        halo_conv_kernel(feats.bfloat16(), tbl, w.bfloat16(), mask, 6, 1)
    with pytest.raises(ValueError, match="6/1 or 9/2"):
        halo_conv(feats, tbl, w, mask, 6, 2)


@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_plain_is_the_dense_conv(stride):
    """The plain version's 27 slice GEMMs equal a dense 3^3 conv of each
    block's materialised halo (F.conv3d, the smoke's library yardstick)."""
    from roreg_tpu_torch.kernels.halo_conv import halo_gather_plain

    rng = np.random.default_rng(stride)
    span = 3 * stride + 3
    tbl, mask = _blocks(rng, 10, 7)
    feats = torch.from_numpy(rng.normal(size=(7, 64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(27, 16, 32)).astype(np.float32))
    tbl, mask = torch.from_numpy(tbl), torch.from_numpy(mask)
    out = halo_conv_plain(feats, tbl, w, mask, span, stride)
    halo = halo_gather_plain(feats, tbl, stride).view(10, span, span, span, 16)
    ref = torch.nn.functional.conv3d(
        halo.permute(0, 4, 1, 2, 3), w.view(3, 3, 3, 16, 32).permute(4, 3, 0, 1, 2), stride=stride
    ).permute(0, 2, 3, 4, 1).reshape(10, 64, 32)
    ref = torch.where(mask[..., None], ref, torch.zeros(()))
    assert float((out - ref).abs().max()) <= 1e-4


def test_halo_maps_cover_the_halo():
    for stride, span in ((1, 6), (2, 9)):
        koff, cell, q = halo_maps(3, stride)
        assert koff.shape == cell.shape == (span**3,)
        assert q.shape == (64 * 27,) and q.min() == 0 and q.max() == span**3 - 1
        assert set(koff.tolist()) == set(range(27))


def test_work_counts_what_the_tables_use():
    """Bytes count each referenced source row or cell once, the table, the
    mask, the weights and the whole output; halo operations count the taps
    of occupied output cells into existing source blocks only."""
    tbl = torch.tensor([[0, 2, -1], [2, -1, -1], [-1, -1, -1]], dtype=torch.int32)
    src = torch.zeros(6, 64, dtype=torch.bfloat16)
    ops, nbytes = gather_work(src, tbl)
    assert ops == 0 and nbytes == 2 * 128 + 9 * 4 + 9 * 128

    t27 = torch.full((3, 27), -1, dtype=torch.int32)
    t27[0, 13], t27[0, 0], t27[1, 13], t27[2, 13] = 4, 1, 1, 7
    mask = torch.zeros(3, 64, dtype=torch.bool)
    mask[0, 5] = mask[1, 63] = True  # block 2 is padding: its block 7 is not read
    cin, cout = 32, 64
    ops, nbytes = halo_work(t27, mask, cin, cout, 1)
    # cell 5 = (0, 1, 1) of block 0: its 9 taps at x = -1 fall in the absent
    # neighbour 4, the other 18 in block 4 (18 cells); cell 63 = (3, 3, 3) of
    # block 1: 8 taps stay in block 1 (8 cells), 19 fall in absent neighbours
    assert ops == 2 * (18 + 8) * cin * cout
    assert nbytes == (18 + 8) * cin * 2 + 81 * 4 + 192 + 27 * cin * cout * 2 + 3 * 64 * cout * 4


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 64), (64, 256)])
def test_pack_weights_is_wgmma_k_major_layout(cin, cout):
    """Stage (c, tap) of the packed weights holds w[tap, 16c + k, n] at byte
    (n/8)*256 + (k/8)*128 + (n%8)*16 + (k%8)*2 of its Cout * 32 bytes, the
    layout the kernel's wgmma descriptor names (csrc/halo_conv.cu)."""
    w = torch.arange(27 * cin * cout, dtype=torch.int32).view(27, cin, cout)
    flat = pack_weights(w).reshape(-1)
    assert flat.numel() == w.numel()
    c, tap, k, n = np.meshgrid(np.arange(cin // 16), np.arange(27), np.arange(16), np.arange(cout),
                               indexing="ij")
    elem = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8  # bytes / 2
    where = (c * 27 + tap) * cout * 16 + elem
    assert torch.equal(flat[torch.from_numpy(where.reshape(-1))],
                       w[torch.from_numpy(tap.reshape(-1)), torch.from_numpy((16 * c + k).reshape(-1)),
                         torch.from_numpy(n.reshape(-1))])


@pytest.mark.parametrize("kernel", ["block_gather", "halo_conv"])
def test_plain_versions_refuse_out_of_range_entries(kernel):
    """An entry >= Nsrc is an error, not an absent block (the kernels trap
    on it)."""
    tbl = torch.full((2, 27), -1, dtype=torch.int32)
    tbl[0, 13] = 5
    mask = torch.ones(2, 64, dtype=torch.bool)
    feats = torch.ones(5, 64, 16)
    with pytest.raises(IndexError):
        if kernel == "block_gather":
            block_gather(feats.view(5, -1), tbl)
        else:
            halo_conv(feats, tbl, torch.ones(27, 16, 32), mask, 6, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,dtype", [
    (64, torch.bfloat16), (128, torch.bfloat16), (256, torch.bfloat16), (64, torch.float32),
])
def test_block_gather_kernel_matches_plain_on_gpu(cuda_device, r, dtype):
    """Bit-exact: the kernel copies rows."""
    rng = np.random.default_rng(r)
    nsrc, b = 3000, 1037
    tbl, _ = _blocks(rng, b, nsrc)
    tbl = torch.from_numpy(tbl).to(cuda_device)
    src = torch.randn(nsrc, r, device=cuda_device).to(dtype)
    before = block_gather_kernel.launches
    out = block_gather(src, tbl)
    assert block_gather_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, block_gather_plain(src, tbl))


@pytest.mark.cuda
@pytest.mark.parametrize("span,stride", [(6, 1), (9, 2)])
@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64), (64, 128), (256, 256)])
def test_halo_conv_kernel_matches_plain_on_gpu(cuda_device, span, stride, cin, cout):
    rng = np.random.default_rng(cin + cout + span)
    nsrc, b = 700, 613
    tbl, mask = _blocks(rng, b, nsrc)
    tbl = torch.from_numpy(tbl).to(cuda_device)
    mask = torch.from_numpy(mask).to(cuda_device)
    feats = torch.randn(nsrc, 64, cin, device=cuda_device).bfloat16()
    w = (torch.randn(27, cin, cout, device=cuda_device) * (2 / (27 * cin)) ** 0.5).bfloat16()
    before = halo_conv_kernel.launches
    out = halo_conv(feats, tbl, w, mask, span, stride)
    assert halo_conv_kernel.launches == before + 1
    torch.cuda.synchronize()
    ref = halo_conv_plain(feats, tbl, w, mask, span, stride)
    assert out.dtype == torch.float32 and out.shape == (b, 64, cout)
    assert float((out - ref).abs().max()) <= HALO_ATOL
    assert bool((out[~mask] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("span,stride", [(6, 1), (9, 2)])
@pytest.mark.parametrize("cin,cout", [(16, 32), (48, 64), (32, 128), (64, 256)])
def test_halo_conv_kernel_dead_runs_on_gpu(cuda_device, span, stride, cin, cout):
    """Runs of live blocks and of dead ones (no occupied cell) in the order
    the host builder packs them, a dead block beside a live one in a thread
    block, and a block count that is no multiple of the blocks per thread
    block."""
    rng = np.random.default_rng(cin * cout + span)
    nsrc, b = 300, 3 * 67
    tbl, mask = _blocks(rng, b, nsrc, absent=0.5)
    mask[:, 0] = True
    mask[40:70] = False  # a run of padding
    mask[71] = False  # one dead block between live ones
    mask[130:] = False  # the tail of the capacity
    tbl = torch.from_numpy(tbl).to(cuda_device)
    mask = torch.from_numpy(mask).to(cuda_device)
    feats = torch.randn(nsrc, 64, cin, device=cuda_device).bfloat16()
    w = (torch.randn(27, cin, cout, device=cuda_device) * (2 / (27 * cin)) ** 0.5).bfloat16()
    out = halo_conv(feats, tbl, w, mask, span, stride)
    torch.cuda.synchronize()
    ref = halo_conv_plain(feats, tbl, w, mask, span, stride)
    assert float((out - ref).abs().max()) <= HALO_ATOL
    assert bool((out[~mask] == 0).all())
    shape = halo_conv_kernel.launch_shape(cin, cout, span, stride)
    assert b % shape["blocks_per_cta"] and shape["stages"] >= 2


OUT_OF_RANGE = """
import torch
from roreg_tpu_torch.kernels.block_gather import block_gather
from roreg_tpu_torch.kernels.halo_conv import halo_conv
tbl = torch.full((2, 27), -1, dtype=torch.int32, device="cuda")
tbl[0, 13] = 5
feats = torch.ones(5, 64, 16, dtype=torch.bfloat16, device="cuda")
if "{kernel}" == "block_gather":
    block_gather(feats.view(5, -1), tbl)
else:
    mask = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    halo_conv(feats, tbl, torch.ones(27, 16, 32, dtype=torch.bfloat16, device="cuda"), mask, 6, 1)
torch.cuda.synchronize()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_gather", "halo_conv"])
def test_kernels_raise_on_out_of_range_entries_on_gpu(cuda_device, kernel):
    """An entry >= Nsrc makes the kernel trap, which the next
    synchronisation raises as a CUDA error (in a child process: the trap
    leaves the CUDA context unusable)."""
    import subprocess
    import sys

    run = subprocess.run(
        [sys.executable, "-c", OUT_OF_RANGE.format(kernel=kernel)],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parents[1],
    )
    assert run.returncode != 0
    assert "CUDA error" in run.stderr
