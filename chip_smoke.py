"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each ending in one flushed progress line on stderr:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``g++`` for the host voxel hash and ``nvcc`` for the six CUDA
   kernels (gather_conv, block_gather, halo_conv, up_conv, skip_concat,
   cell_dense), all started together, from the sources in this checkout;
3. kernel: the gather-conv kernel against its plain PyTorch version on the
   tables of one full-capacity host pyramid of the synthetic cloud, at the
   11 ResUNetBN2C conv shapes, both as one rotation's table and as the main
   path's table of a whole rotation chunk; error, a second launch that must
   be bit-equal to the first, CUDA-event times, the card's bound and the
   kernel's launch shape (rows per thread block, channels per step, ring
   slots, cluster split) for each;
3b. block kernels: block_gather (bit-exact), halo_conv (1e-3), up_conv
   (1e-3), skip_concat (bit-exact) and cell_dense (1e-5 relative, with the
   level-0 cell mask the main path passes) against their plain versions at
   every shape the block engine's ResUNetBN2C calls, on the tables of the
   main path's own upload of one chunk of cloud 0; error, times, bound and a
   library call's time for each, and halo_conv's and up_conv's launch
   shapes (output blocks per thread block, weight stages);
3c. reference: ``register_pair`` at a small configuration on the GPU and on
   the CPU (plain versions), gather engine and block engine, whose
   descriptors must agree; and the RM matcher on both devices fed the same
   sampled descriptors and keys, whose Sinkhorn matching scores and matches
   must agree. This also brings up every library the slices call, so the
   later phases time a warm process;
4. gather slice: ``RegistrationPipeline.register_pair`` on a seeded
   20000-point pair at the full-width gather-engine configuration with
   seeded random weights;
5. block slice: the same pair through ``PipelineConfig(use_rm=False)``, the
   block engine with the mutual-NN matcher, full width; no block may be
   dropped;
6. default chain: the same pair through ``PipelineConfig()``, the JAX
   package's default (block engine, RM matcher with 100 Sinkhorn
   iterations, top-match selection, ET, yohoo), full width; no block may be
   dropped, and RM's matches must be a valid set;
7. quality: the committed trained weights (``checkpoints/quality_full/``)
   under ``quality_full_config()`` (conv1 kernel 5, chunks of 6 rotations)
   on the JAX package's held-out benchmark scenes (4 + 4 scenes of 7
   clouds). First the five block kernels against their plain versions at
   chunk 6 on the first cloud (as phase 3b); then each of the 56 clouds is
   described once into one store (each cloud ran 10 chunks of the five
   block kernels, and no block was dropped), and the four chain variants
   register all 168 pairs at keynum 1024. FMR, IR and RR must lie within
   the bands of ``QUALITY_BANDS`` around the JAX package's rows for these
   weights on the CPU; ``QUALITY.json``'s TPU rows are printed beside.

Each slice checks the descriptor shapes and norms, the launch counts of
every kernel (zeroed just before the run: each kernel of the path ran
once per use per chunk, and no other kernel ran), and that the transform
is a proper rigid motion. Then the script prints the kernel report as one
JSON line, and as the last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero without that line; so does a run without
CUDA or outside the repository. The run ends itself after ``DEADLINE_S``
seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # FFMA outside the tensor cores
PEAK_BYTES = 3.35e12
# bf16 products are exact in f32, so kernel and plain version differ only by
# the order of f32 summation (<= 6912 terms of outputs of magnitude <~ 10)
KERNEL_ATOL = 1e-3
# small-config descriptors, GPU kernel vs CPU plain version, both bf16: one
# bf16 rounding of an intermediate activation may flip where the two
# devices' f32 sums differ in the last bits, and that flip propagates
REFERENCE_ATOL = 1e-2
REFERENCE_MEAN_ATOL = 5e-4
# cell_dense: f32 FFMA against F.linear's f32 sums, <= 96 terms in another
# order
DENSE_RTOL = 1e-5
# RM on the two devices fed the same descriptors: f32 GEMMs (no TF32) and
# 100 Sinkhorn iterations summed in another order
RM_SCORE_ATOL = 1e-3

# (table, Cin, Cout, uses per forward) of ResUNetBN2C's 20 gather convs
CONV_SHAPES = [
    (("same", 0), 32, 32, 2),
    (("down", 0), 32, 64, 1),
    (("same", 1), 64, 64, 4),
    (("down", 1), 64, 128, 1),
    (("same", 2), 128, 128, 4),
    (("down", 2), 128, 256, 1),
    (("same", 3), 256, 256, 2),
    (("up", 2), 256, 128, 1),
    (("up", 1), 256, 64, 1),
    (("up", 0), 128, 64, 1),
    (("same", 0), 64, 64, 2),
]

# the block engine's ResUNetBN2C, one chunk's forward: (table, level, Cin,
# Cout, uses) of its 17 halo convs (14 same-level, 3 down) ...
BLOCK_HALO_SHAPES = [
    ("same", 0, 32, 32, 2),
    ("down", 0, 32, 64, 1),
    ("same", 1, 64, 64, 4),
    ("down", 1, 64, 128, 1),
    ("same", 2, 128, 128, 4),
    ("down", 2, 128, 256, 1),
    ("same", 3, 256, 256, 2),
    ("same", 0, 64, 64, 2),
]
# ... (use, table level, row width R) of its 4 block gathers: conv1's
# neighbour occupancy, and the coarse regions of the 3 up convs ...
BLOCK_GATHER_SHAPES = [
    ("conv1", 0, 64),
    ("up", 2, 256),
    ("up", 1, 256),
    ("up", 0, 128),
]
# ... (layer, fine level, Cin, Cout) of its 3 up convs ...
UP_SHAPES = [
    ("conv4_tr", 2, 256, 128),
    ("conv3_tr", 1, 256, 64),
    ("conv2_tr", 0, 128, 64),
]
# ... (feeds, level, Ca, Cb) of its 2 skip concatenations ...
SKIP_SHAPES = [
    ("conv3_tr", 2, 128, 128),
    ("conv2_tr", 1, 64, 64),
]
# ... and (layer, Ca, Cb, N, bias, relu) of its 2 level-0 cell-dense layers
DENSE_SHAPES = [
    ("conv1_tr", 64, 32, 64, False, True),
    ("final", 64, 0, 32, True, False),
]

# phase 7's bands at keynum 1024 around the JAX package's rows for the same
# weights and scenes on the CPU (checkpoints/quality_full/
# jax_cpu_reference.json). IR and FMR of the two RD + RM variants are
# deterministic given the weights (NMS and RM are): |IR - JAX| <= 0.03 and
# |FMR - JAX| <= 0.04 on both splits. RR of full_rd_rm_et_yohoo is nearly so
# (1000 of 1024 hypotheses scored): >= 0.97 on 3dmatch_analog, within 0.08
# (7 of 84 pairs) of JAX's on 3dlomatch_analog. yohoc draws at random: its
# RR >= 0.95 on 3dmatch_analog. QUALITY.json's TPU rows are printed beside.
QUALITY_BANDS = {"ir": 0.03, "fmr": 0.04, "full_rr_hi_min": 0.97, "full_rr_lo": 0.08,
                 "yohoc_rr_hi_min": 0.95}
QUALITY_KEYNUM = 1024

# the run ends itself (exit code 1, tracebacks on stderr) after this long;
# it must end within 1200 s, builds included
DEADLINE_S = 1000.0

T0 = time.perf_counter()


def progress(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - T0:.1f}s] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, flush: torch.Tensor | None = None) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls. With
    ``flush``, that buffer is overwritten before each call (outside the
    timed span), so every call starts with a cold L2 as on the main path,
    where other layers' traffic runs between two convs."""
    for _ in range(warmup):
        fn()
    spans = []
    torch.cuda.synchronize()
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    progress(f"phase 1 device: {kind} ({smi}), {torch.cuda.device_count()} visible, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"kind": kind, "nvidia_smi": smi}


def _kernels() -> dict:
    """name -> wrapper of every CUDA kernel of the port."""
    from roreg_tpu_torch.kernels.block_gather import block_gather_kernel
    from roreg_tpu_torch.kernels.cell_dense import cell_dense_kernel
    from roreg_tpu_torch.kernels.gather_conv import gather_conv_kernel
    from roreg_tpu_torch.kernels.halo_conv import halo_conv_kernel
    from roreg_tpu_torch.kernels.skip_concat import skip_concat_kernel
    from roreg_tpu_torch.kernels.up_conv import up_conv_kernel

    return {"gather_conv": gather_conv_kernel, "block_gather": block_gather_kernel,
            "halo_conv": halo_conv_kernel, "up_conv": up_conv_kernel,
            "skip_concat": skip_concat_kernel, "cell_dense": cell_dense_kernel}


def phase_build() -> dict:
    from roreg_tpu_torch.native import lib as native_lib

    builds = {"g++ voxelhash": native_lib.build}
    builds.update({f"nvcc {name}": k.build for name, k in _kernels().items()})
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(fn, True) for name, fn in builds.items()}
        secs = {name: f.result() for name, f in futures.items()}
    progress("phase 2 build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return secs


def phase_kernel(cfg, pair: dict, seed: int, device: str = "cuda") -> tuple[dict, list]:
    from roreg_tpu_torch.core.group import get_group
    from roreg_tpu_torch.kernels.gather_conv import conv_work, gather_conv_kernel, gather_conv_plain
    from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host, tree_slice
    from roreg_tpu_torch.pipeline.extractor import effective_chunk, upload_chunk

    # the host pyramids of the main path's first rotation chunk of cloud 0,
    # uploaded and batched as the main path does it
    chunk = effective_chunk(cfg.group_size, cfg.group_chunk)
    rots = get_group(cfg.group_size).rotations.astype(np.float32)[:chunk]
    buf = alloc_pyramid_buffers(cfg.capacities, cfg.conv1_kernel_size, chunk)
    for b in range(chunk):
        fill_pyramid_host(pair["points0"] @ rots[b].T, cfg.voxel_size, tree_slice(buf, b),
                          conv1_kernel_size=cfg.conv1_kernel_size)
    dev = torch.device(device)
    keys_rot = np.einsum("kj,bij->bki", pair["keys0"].astype(np.float32), rots)
    batched, _, _ = upload_chunk(buf, keys_rot, dev)
    caps = cfg.capacities
    nvox = [int(l.num[0]) for l in buf.levels]
    gen = torch.Generator(device=dev).manual_seed(seed)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # 5x the H100's 50 MB L2
    rows = []
    total = dict.fromkeys(("ms", "warm_l2_ms", "plain_ms", "bound_ms", "t_ops", "t_bytes", "err"), 0.0)
    for (kind, lvl), cin, cout, uses in CONV_SHAPES:
        src_lvl = lvl if kind in ("same", "down") else lvl + 1
        n_src = caps[src_lvl]
        single = torch.from_numpy(getattr(buf, kind)[lvl][0].astype(np.int32)).to(dev)
        table_b = getattr(batched, kind)[lvl]
        w = (torch.randn(27, cin, cout, generator=gen, device=dev) * (2.0 / (27 * cin)) ** 0.5).bfloat16()
        feats_b = torch.randn(chunk * n_src, cin, generator=gen, device=dev).bfloat16()
        feats_1 = feats_b[:n_src].contiguous()
        row = {"table": f"{kind}[{lvl}]", "M": single.shape[0], "N": n_src, "cin": cin,
               "cout": cout, "uses": uses, "voxels": nvox}
        for tag, feats, table in (("one", feats_1, single), ("chunk", feats_b, table_b)):
            out_k = gather_conv_kernel(feats, table, w)
            again = gather_conv_kernel(feats, table, w)
            out_p = gather_conv_plain(feats, table, w)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            if not np.isfinite(err) or err > KERNEL_ATOL:
                raise AssertionError(
                    f"gather_conv {row['table']} {cin}->{cout} ({tag}): max abs err {err} > {KERNEL_ATOL}")
            if not torch.equal(out_k, again):
                raise AssertionError(f"gather_conv {row['table']} {cin}->{cout} ({tag}): two launches differ")
            del again
            ms = cuda_ms(lambda: gather_conv_kernel(feats, table, w), reps=20, flush=l2_flush)
            warm_ms = cuda_ms(lambda: gather_conv_kernel(feats, table, w), reps=20)
            plain_ms = cuda_ms(lambda: gather_conv_plain(feats, table, w), reps=3, warmup=1,
                               flush=l2_flush)
            ops, nbytes = conv_work(table, cin, cout)
            t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row[tag] = {"table_dtype": str(table.dtype).replace("torch.", ""), "rows": table.shape[0],
                        "max_abs_err": err, "ms": ms, "warm_l2_ms": warm_ms, "plain_ms": plain_ms,
                        "ops_ms": t_ops, "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "tflops": ops / ms / 1e9,
                        **gather_conv_kernel.launch_shape(table.shape[0], cin, cout, 27)}
            total["err"] = max(total["err"], err)
        c = row["chunk"]
        total["ms"] += uses * c["ms"]
        total["warm_l2_ms"] += uses * c["warm_l2_ms"]
        total["plain_ms"] += uses * c["plain_ms"]
        total["bound_ms"] += uses * c["bound_ms"]
        total["t_ops"] += uses * c["ops_ms"]
        total["t_bytes"] += uses * c["bytes_ms"]
        rows.append(row)
        progress(
            f"  {row['table']:8s} M={row['M']:6d} N={n_src:6d} {cin:3d}->{cout:3d}: "
            f"one-rotation err {row['one']['max_abs_err']:.2e} kernel {row['one']['ms']:.3f} ms "
            f"plain {row['one']['plain_ms']:.3f} ms | chunk of {chunk} int32 err {c['max_abs_err']:.2e} "
            f"kernel {c['ms']:.3f} ms (warm L2 {c['warm_l2_ms']:.3f}) plain {c['plain_ms']:.3f} ms bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), {c['tflops']:.1f} TFLOP/s (tol {KERNEL_ATOL}, bit-equal twice); "
            f"rows/CTA {c['rows_per_cta']}, channels/step {c['channels_per_step']}, stages {c['stages']}, "
            f"cluster split {row['one']['cluster_split']} (one rotation) / {c['cluster_split']} (chunk)")
    progress(f"phase 3 kernel: 11 shapes within {KERNEL_ATOL}; one chunk's 20 convs: kernel "
             f"{total['ms']:.2f} ms (warm L2 {total['warm_l2_ms']:.2f} ms), plain {total['plain_ms']:.2f} ms, bound {total['bound_ms']:.3f} ms")
    return total, rows


def _bound(ops: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops_ms": t_ops, "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_block_kernels(cfg, pair: dict, seed: int, device: str = "cuda",
                        tag: str = "phase 3b block kernels") -> tuple[dict, list]:
    """The block engine's five kernels against their plain versions at every
    shape of one chunk's forward, on the main path's own upload of chunk 0
    of cloud 0. Returns (totals per kernel over one chunk's forward, rows)."""
    import torch.nn.functional as F

    from roreg_tpu_torch.kernels.block_gather import block_gather_kernel, block_gather_plain, gather_work
    from roreg_tpu_torch.kernels.cell_dense import cell_dense_kernel, cell_dense_plain, dense_work
    from roreg_tpu_torch.kernels.halo_conv import (
        halo_conv_kernel, halo_conv_plain, halo_gather_plain, halo_work,
    )
    from roreg_tpu_torch.kernels.skip_concat import concat_work, skip_concat_kernel, skip_concat_plain
    from roreg_tpu_torch.kernels.up_conv import up_conv_kernel, up_conv_plain, up_work
    from roreg_tpu_torch.pipeline.extractor import (
        build_cloud_payloads, chunk_block_pyramid, effective_chunk, upload_cloud_payloads,
    )
    from roreg_tpu_torch.sparse.block import unpack_cell_occupancy

    dev = torch.device(device)
    chunk = effective_chunk(cfg.group_size, cfg.group_chunk)
    payload, key_rows, caps, dropped = build_cloud_payloads(pair["points0"], pair["keys0"], cfg)
    if dropped:
        raise AssertionError(f"cloud 0 drops {dropped} blocks at block_caps {caps}")
    dev_payload, _ = upload_cloud_payloads(payload, key_rows, dev)
    pyr = chunk_block_pyramid(dev_payload, 0, caps, chunk)
    occs = [unpack_cell_occupancy(lvl.occ_words) for lvl in pyr.levels]
    blocks = [int(o.any(1).sum()) for o in occs]
    gen = torch.Generator(device=dev).manual_seed(seed)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    keys = ("ms", "warm_l2_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "err", "uses")
    names = ("block_gather", "halo_conv", "up_conv", "skip_concat", "cell_dense")
    totals = {name: dict.fromkeys(keys, 0.0) for name in names}
    rows = []

    def measure(name, kernel, plain, library, work, uses, tol, label, peak=PEAK_BF16_FLOPS, launch=None):
        """tol: "exact", or ("abs" | "rel", limit). library: (one PyTorch
        call computing the same function, what it is). launch: the kernel's
        launch shape, reported with the row."""
        out_k = kernel()
        out_p = plain()
        torch.cuda.synchronize()
        diff = (out_k.float() - out_p.float()).abs()
        err = float(diff.max())
        checked = err  # the error the tolerance applies to
        if tol == "exact":
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{name} {label}: kernel differs from its plain version (max {err})")
            limit = 0.0
        else:
            kind, limit = tol
            if kind == "rel":
                checked = float((diff / (out_p.float().abs() + 1)).max())
            if not np.isfinite(checked) or checked > limit:
                raise AssertionError(f"{name} {label}: max {kind} err {checked} > {limit}")
        lib_fn, lib_what = library
        row = {"kernel": name, "shape": label, "uses": uses, "max_abs_err": err,
               "checked_err": checked, "tolerance": tol,
               "ms": cuda_ms(kernel, reps=20, flush=l2_flush),
               "warm_l2_ms": cuda_ms(kernel, reps=20),
               "plain_ms": cuda_ms(plain, reps=3, warmup=1, flush=l2_flush),
               "library_ms": cuda_ms(lib_fn, reps=5, warmup=1, flush=l2_flush),
               "library": lib_what, **_bound(*work, peak), **(launch or {})}
        row["tflops"] = work[0] / row["ms"] / 1e9
        row["gbps"] = work[1] / row["ms"] / 1e6
        t = totals[name]
        t["err"] = max(t["err"], err)
        t["uses"] += uses
        for k in keys[:-2]:
            t[k] += uses * row[k]
        rows.append(row)
        shape = "".join(f", {k} {v}" for k, v in (launch or {}).items())
        progress(f"  {name:12s} {label:34s} err {err:.2e} kernel {row['ms']:.3f} ms (warm L2 "
                 f"{row['warm_l2_ms']:.3f}) plain {row['plain_ms']:.3f} ms library {row['library_ms']:.3f} ms "
                 f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {row['gbps']:.0f} GB/s, "
                 f"{row['tflops']:.1f} TFLOP/s{shape}")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for use, lvl, r in BLOCK_GATHER_SHAPES:
        if use == "conv1":
            tbl = pyr.levels[0].same_tbl
            src = occs[0].to(torch.bfloat16).contiguous()
        else:
            tbl = pyr.up_tbl[lvl]
            src = randn(occs[lvl + 1].numel(), r).bfloat16()
        padded = torch.cat([torch.zeros_like(src[:1]), src])
        ids = tbl.long() + 1
        measure("block_gather", lambda: block_gather_kernel(src, tbl), lambda: block_gather_plain(src, tbl),
                (lambda: F.embedding(ids, padded),
                 "torch.nn.functional.embedding over the source with a zero row prepended"),
                gather_work(src, tbl), 1, "exact", f"{use}[{lvl}] B={tbl.shape[0]} R={r} Nsrc={src.shape[0]}")

    for kind, lvl, cin, cout, uses in BLOCK_HALO_SHAPES:
        span, stride = (6, 1) if kind == "same" else (9, 2)
        tbl = pyr.levels[lvl].same_tbl if kind == "same" else pyr.down_tbl[lvl]
        mask = occs[lvl] if kind == "same" else occs[lvl + 1]
        feats = (randn(occs[lvl].shape[0], 64, cin) * occs[lvl][..., None]).bfloat16()
        w = (randn(27, cin, cout) * (2.0 / (27 * cin)) ** 0.5).bfloat16()
        # the library yardstick: a dense conv3d over the halo the plain version
        # materialises (the gather is left out of its time)
        halo = halo_gather_plain(feats, tbl, stride).view(-1, span, span, span, cin)
        halo = halo.permute(0, 4, 1, 2, 3).contiguous()
        w5 = w.view(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
        measure("halo_conv", lambda: halo_conv_kernel(feats, tbl, w, mask, span, stride),
                lambda: halo_conv_plain(feats, tbl, w, mask, span, stride),
                (lambda: F.conv3d(halo, w5, stride=stride),
                 "torch.nn.functional.conv3d over the halo the plain version materialises (gather not timed)"),
                halo_work(tbl, mask, cin, cout, stride), uses, ("abs", KERNEL_ATOL),
                f"{kind}[{lvl}] {cin}->{cout} B={tbl.shape[0]}",
                launch=halo_conv_kernel.launch_shape(cin, cout, span, stride))
        del halo

    for layer, lvl, cin, cout in UP_SHAPES:
        tbl, mask = pyr.up_tbl[lvl], occs[lvl]
        coarse = (randn(occs[lvl + 1].shape[0], 64, cin) * occs[lvl + 1][..., None]).bfloat16()
        reg = block_gather_plain(coarse.reshape(-1, cin), tbl)  # the main path's up-conv input
        w = (randn(27, cin, cout) * (2.0 / (8 * cin)) ** 0.5).bfloat16()
        # the library yardstick: one stride-2 transposed conv3d of each fine
        # block's 3^3 coarse region (layouts made outside the timed span)
        reg5 = reg.view(-1, 3, 3, 3, cin).permute(0, 4, 1, 2, 3).contiguous()
        w5 = w.view(3, 3, 3, cin, cout).flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        measure("up_conv", lambda: up_conv_kernel(reg, w, mask), lambda: up_conv_plain(reg, w, mask),
                (lambda: F.conv_transpose3d(reg5, w5, stride=2, padding=1),
                 "torch.nn.functional.conv_transpose3d, stride 2, over each fine block's 3^3 region "
                 "(layouts made outside the timed span)"),
                up_work(tbl, mask, cin, cout), 1, ("abs", KERNEL_ATOL),
                f"{layer} [{lvl}] {cin}->{cout} B={tbl.shape[0]}",
                launch=up_conv_kernel.launch_shape(cin, cout))
        del reg5

    for layer, lvl, ca, cb in SKIP_SHAPES:
        a = randn(occs[lvl].shape[0], 64, ca) * occs[lvl][..., None]
        b = randn(occs[lvl].shape[0], 64, cb) * occs[lvl][..., None]
        out_lib = torch.empty(a.shape[:-1] + (ca + cb,), dtype=torch.bfloat16, device=dev)
        measure("skip_concat", lambda: skip_concat_kernel(a, b), lambda: skip_concat_plain(a, b),
                (lambda: torch.cat([a, b], -1, out=out_lib), "torch.cat into a bf16 out= tensor"),
                concat_work(a, b), 1, "exact", f"into {layer} [{lvl}] {ca}+{cb} B={a.shape[0]}")

    row_mask = occs[0].reshape(-1)  # the main path passes the level-0 cell mask
    for layer, ca, cb, n, has_bias, relu in DENSE_SHAPES:
        a = torch.relu(randn(occs[0].shape[0] * 64, ca))
        b = torch.relu(randn(occs[0].shape[0] * 64, cb)) if cb else None
        weight = randn(n, ca + cb) / (ca + cb) ** 0.5
        bias = randn(n) * 0.1 if has_bias else None
        if b is None:
            library = (lambda: F.linear(a, weight, bias), "torch.nn.functional.linear over all rows")
        else:
            x = torch.cat([a, b], -1)
            library = (lambda: F.linear(x, weight, bias),
                       "torch.nn.functional.linear over all rows of the concatenated input "
                       "(concatenation, ReLU and mask not timed)")
        measure("cell_dense", lambda: cell_dense_kernel(a, b, weight, bias, relu, row_mask),
                lambda: cell_dense_plain(a, b, weight, bias, relu, row_mask), library,
                dense_work(a, b, weight, bias, row_mask), 1, ("rel", DENSE_RTOL),
                f"{layer} {ca}+{cb}->{n} rows={a.shape[0]} kept={int(row_mask.sum())}", PEAK_F32_FLOPS)
        if b is not None:
            del x

    for name, t in totals.items():
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
    progress(
        f"{tag}: chunk of {chunk} rotations, {blocks} occupied of "
        f"{[o.shape[0] for o in occs]} blocks per level; one chunk's forward: " + "; ".join(
            f"{n} x{int(t['uses'])} kernel {t['ms']:.2f} ms, plain {t['plain_ms']:.2f} ms, library "
            f"{t['library_ms']:.2f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), max err {t['err']:.1e}"
            for n, t in totals.items()))
    return totals, rows


def _check_rm_matches(out: dict, cfg) -> None:
    """RM's matches are a valid set: keypoint indices in range, one-to-one
    among the valid ones, and the top-match subset (``match_n``) inside
    them at the size the rule gives."""
    valid = out["match_valid"]
    est = out["est_valid"]
    pairs = out["matches"][valid]
    n = int(valid.sum())
    if n < 3:
        raise AssertionError(f"RM found {n} matches")
    if bool((pairs < 0).any()) or bool((pairs >= cfg.num_keypoints).any()):
        raise AssertionError("RM matches index outside the keypoints")
    for side in (0, 1):
        if torch.unique(pairs[:, side]).numel() != n:
            raise AssertionError(f"RM matches are not one-to-one on side {side}")
    want = min(max(int(n * cfg.match_n), 10), n) if cfg.match_n < 0.999 else n
    if bool((est & ~valid).any()) or int(est.sum()) != want:
        raise AssertionError(f"top-match subset of {int(est.sum())} (expected {want} of {n} valid)")
    if not bool(torch.isfinite(out["match_scores"]).all()):
        raise AssertionError("RM matching scores are not finite")


def phase_slice(cfg, pair: dict, seed: int, per_chunk: dict, tag: str, device: str = "cuda") -> dict:
    """One full-width ``register_pair``. ``per_chunk``: kernel name -> its
    launches per chunk forward on this path; every kernel's count is zeroed
    just before the run and must equal that times the pair's chunks after it
    (0 for a kernel off the path)."""
    from roreg_tpu_torch.pipeline.extractor import effective_chunk
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.weights import init_variables

    t0 = time.perf_counter()
    pipe = RegistrationPipeline(cfg, init_variables(cfg, seed), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(seed)
    timings: dict[str, float] = {}
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = pipe.register_pair(pair["points0"], None, pair["keys0"], pair["points1"], None,
                             pair["keys1"], generator=gen, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    k, g = cfg.num_keypoints, cfg.group_size
    for name in ("bb0", "gf0"):
        x = out[name]
        if tuple(x.shape) != (k, g, 32) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"describe {name}: shape {tuple(x.shape)} or non-finite values")
        dev_norm = float((torch.linalg.norm(x, dim=-1) - 1).abs().max())
        if dev_norm > 1e-3:
            raise AssertionError(f"describe {name}: rows not unit-norm (max |norm-1| {dev_norm})")
    chunks = 2 * (g // effective_chunk(g, cfg.group_chunk))
    expected = {name: per_chunk.get(name, 0) * chunks for name in kernels}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected} ({chunks} chunks)")
    dropped = out["dropped_blocks"].tolist() if "dropped_blocks" in out else None
    if dropped is not None and any(dropped):
        raise AssertionError(f"blocks dropped per cloud {dropped} at block_caps {cfg.block_caps}")
    T = out["transform"].double().cpu()
    R = T[:3, :3]
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("transform is not finite")
    ortho = float((R.T @ R - torch.eye(3, dtype=R.dtype)).abs().max())
    det = float(torch.linalg.det(R))
    if ortho > 1e-4 or abs(det - 1) > 1e-4:
        raise AssertionError(f"transform not a proper rotation: |RtR-I| {ortho}, det {det}")
    if cfg.use_rm:
        _check_rm_matches(out, cfg)
    res = {"engine": cfg.engine, "setup_s": setup_s, "register_pair_s": wall, "stages_s": timings,
           "launches": launches, "chunks": chunks, "dropped_blocks": dropped, "ortho_err": ortho,
           "det": det, "overlap": float(out["overlap"]), "use_rm": cfg.use_rm,
           "matches": int(out["match_valid"].sum()), "est_valid": int(out["est_valid"].sum()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    counts = ", ".join(f"{n} {c} = {per_chunk[n]} x {chunks} chunks" for n, c in launches.items() if c)
    progress(
        f"{tag}: register_pair {wall:.2f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
        + f"), launches {counts}, dropped blocks per cloud {dropped}, |RtR-I| {ortho:.1e}, "
        f"det {det:.6f}, {res['matches']} {'RM' if cfg.use_rm else 'mutual'} matches, "
        f"{res['est_valid']} to RANSAC, peak {res['peak_mem_gb']:.1f} GB")
    return res


def _small(cfg):
    return dataclasses.replace(
        cfg, group_size=12, capacities=(4096, 2048, 1024, 512), block_caps=(512, 256, 128, 64),
        conv1_kernel_size=5, voxel_size=0.05, group_chunk=4, num_keypoints=256, keynum=128)


def _small_pair(seed: int) -> dict:
    from roreg_tpu_torch.data.synthetic import synthetic_pair

    return synthetic_pair(seed + 1, points_per_cloud=6000, num_keypoints=256, surface_extent=1.6)


def phase_reference(cfg, seed: int, device: str = "cuda") -> dict:
    """``cfg``'s engine at a small configuration, on the GPU (kernels) and
    on the CPU (plain versions): the descriptors must agree."""
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.weights import init_variables

    small = _small(cfg)
    pair = _small_pair(seed)
    variables = init_variables(small, seed)
    feats = {}
    for dev in (device, "cpu"):
        pipe = RegistrationPipeline(small, variables, device=dev)
        out = pipe.register_pair(pair["points0"], None, pair["keys0"], pair["points1"], None,
                                 pair["keys1"], generator=torch.Generator().manual_seed(seed))
        feats[dev] = (out["bb0"].float().cpu(), out["gf0"].float().cpu())
        if "dropped_blocks" in out and bool(out["dropped_blocks"].any()):
            raise AssertionError(f"small config drops blocks: {out['dropped_blocks'].tolist()}")
    errs = {}
    for i, name in enumerate(("bb", "gf")):
        d = (feats[device][i] - feats["cpu"][i]).abs()
        errs[name] = {"max": float(d.max()), "mean": float(d.mean())}
        if errs[name]["max"] > REFERENCE_ATOL or errs[name]["mean"] > REFERENCE_MEAN_ATOL:
            raise AssertionError(f"GPU and CPU describe disagree on {name}: {errs[name]}")
    progress(f"phase 3c reference ({cfg.engine} engine): small-config register_pair descriptors, "
             f"GPU kernels vs CPU plain versions: {errs} (tol max {REFERENCE_ATOL}, mean {REFERENCE_MEAN_ATOL})")
    return errs


def phase_rm_reference(cfg, seed: int, device: str = "cuda") -> dict:
    """RM (``use_rm=True``) at the small configuration on the GPU and on the
    CPU, fed the same sampled descriptors and keys (the CPU pipeline's):
    ``rm_apply``'s matches must be equal and its Sinkhorn matching scores
    within ``RM_SCORE_ATOL``."""
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline, rm_apply
    from roreg_tpu_torch.weights import init_variables

    small = _small(dataclasses.replace(cfg, use_rm=True))
    pair = _small_pair(seed)
    variables = init_variables(small, seed)
    cpu = RegistrationPipeline(small, variables, device="cpu")
    gpu = RegistrationPipeline(small, variables, device=device)
    sampled = []
    for i in (0, 1):
        keys = torch.as_tensor(pair[f"keys{i}"], dtype=torch.float32)
        _, gf = cpu.describe(pair[f"points{i}"], None, keys)
        ones = torch.ones(keys.shape[0], dtype=torch.bool)
        s = cpu.sample_keypoints(keys, cpu.detect(gf, ones), ones)
        sampled += [gf[s], keys[s]]
    gf0, k0, gf1, k1 = sampled
    with torch.inference_mode():
        ref = rm_apply(cpu.nets["rm"], gf0, gf1, k0, k1)
        out = [x.cpu() for x in rm_apply(gpu.nets["rm"], *(t.to(device) for t in (gf0, gf1, k0, k1)))]
    err = float((out[2] - ref[2]).abs().max())
    res = {"keynum": small.keynum, "valid": int(ref[1].sum()), "max_score_err": err,
           "matches_equal": bool(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]))}
    if not res["matches_equal"] or not np.isfinite(err) or err > RM_SCORE_ATOL:
        raise AssertionError(f"RM on the GPU and on the CPU disagree: {res}")
    progress(f"phase 3c reference (RM): small-config rm_apply on the same sampled descriptors, GPU vs "
             f"CPU: matches equal ({res['valid']} valid of {small.keynum}), max Sinkhorn score err "
             f"{err:.1e} (tol {RM_SCORE_ATOL})")
    return res


def phase_quality(seed: int, per_chunk: dict, device: str = "cuda") -> dict:
    """Phase 7: the trained weights on the held-out scenes (see the module
    docstring). ``per_chunk``: the block kernels' launches per chunk."""
    from roreg_tpu_torch.pipeline.extractor import effective_chunk
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.quality import VARIANTS, describe_scenes, jax_references, quality_scenes, run_variants
    from roreg_tpu_torch.weights import QUALITY_FULL_DIR, load_checkpoint_dir

    t0 = time.perf_counter()
    cfg = quality_full_config()
    variables = load_checkpoint_dir(QUALITY_FULL_DIR, cfg)
    groups = quality_scenes(cfg)
    refs = jax_references()
    ref = refs["cpu"]  # the bands' reference: the JAX package with these weights
    cells = [f"{split}@{QUALITY_KEYNUM}" for split in groups]
    missing = [(k, v, c) for k, r in refs.items() for v in VARIANTS for c in cells if c not in r.get(v, {})]
    if missing:
        raise AssertionError(f"the JAX reference rows {missing} are missing")
    first = next(iter(groups["3dmatch_analog"].values()))
    progress(f"phase 7 quality: weights and {sum(len(g) for g in groups.values())} scenes ready in "
             f"{time.perf_counter() - t0:.1f} s")
    chunk6, chunk6_rows = phase_block_kernels(
        cfg, {"points0": first.clouds[0], "keys0": first.keypoints[0]}, seed, device,
        tag=f"phase 7a block kernels at chunk {cfg.group_chunk}, conv1 kernel {cfg.conv1_kernel_size}")

    pipe = RegistrationPipeline(cfg, variables, device=device)
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    store: dict = {}
    described = describe_scenes(pipe, groups, store)
    launches = {name: k.launches for name, k in kernels.items()}
    del pipe
    chunks = cfg.group_size // effective_chunk(cfg.group_size, cfg.group_chunk)
    expected = {name: per_chunk.get(name, 0) * chunks * described["clouds"] for name in kernels}
    if launches != expected:
        raise AssertionError(f"phase 7 describe launches {launches}, expected {expected} "
                             f"({chunks} chunks x {described['clouds']} clouds)")
    if described["dropped_blocks"]:
        raise AssertionError(f"phase 7: {described['dropped_blocks']} blocks dropped at {cfg.block_caps}")
    k, g = cfg.num_keypoints, cfg.group_size
    for key, (bb, gf, det) in store.items():
        for name, x in (("bb", bb), ("gf", gf)):
            if tuple(x.shape) != (k, g, 32) or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"phase 7 {key} {name}: shape {tuple(x.shape)} or non-finite values")
    progress(f"phase 7b describe: {described['clouds']} clouds in {described['seconds']:.1f} s "
             f"({described['seconds'] / described['clouds']:.3f} s a cloud), launches "
             + ", ".join(f"{n} {c} = {per_chunk[n]} x {chunks} chunks x {described['clouds']} clouds"
                         for n, c in launches.items() if c)
             + ", 0 dropped blocks")

    t1 = time.perf_counter()
    progress("phase 7c pair stages at keynum 1024 (card; JAX on the CPU and on a TPU in brackets):")
    results = run_variants(variables, cfg, groups, VARIANTS, [QUALITY_KEYNUM], store, device,
                           log=lambda msg: progress("  " + msg))
    pair_s = time.perf_counter() - t1
    faults = []
    hi, lo = cells
    for v, rows in results.items():
        for c in cells:
            mine, jax_row = rows[c], ref[v][c]
            if v in ("rd_rm_yohoc", "full_rd_rm_et_yohoo"):
                for m in ("ir", "fmr"):
                    if abs(mine[m] - jax_row[m]) > QUALITY_BANDS[m]:
                        faults.append(f"{v} {c} {m.upper()} {mine[m]:.4f} vs JAX (CPU) {jax_row[m]:.4f} "
                                      f"(band {QUALITY_BANDS[m]})")
        rr_hi, rr_lo = rows[hi]["rr_pointdsc"], rows[lo]["rr_pointdsc"]
        if v == "full_rd_rm_et_yohoo":
            if rr_hi < QUALITY_BANDS["full_rr_hi_min"]:
                faults.append(f"{v} {hi} RR {rr_hi:.4f} < {QUALITY_BANDS['full_rr_hi_min']}")
            if abs(rr_lo - ref[v][lo]["rr_pointdsc"]) > QUALITY_BANDS["full_rr_lo"]:
                faults.append(f"{v} {lo} RR {rr_lo:.4f} vs JAX (CPU) {ref[v][lo]['rr_pointdsc']:.4f} "
                              f"(band {QUALITY_BANDS['full_rr_lo']})")
        elif rr_hi < QUALITY_BANDS["yohoc_rr_hi_min"]:
            faults.append(f"{v} {hi} RR {rr_hi:.4f} < {QUALITY_BANDS['yohoc_rr_hi_min']}")
    if faults:
        raise AssertionError("phase 7 quality outside its bands: " + "; ".join(faults))
    rates = {}
    for v, rows in results.items():
        pairs = sum(rows[c]["pairs"] for c in cells)
        rates[v] = pairs / sum(rows[c]["pairs"] / rows[c]["pairs_per_sec"] for c in cells)
    n_pairs = sum(r[c]["pairs"] for r in results.values() for c in cells)
    progress(f"phase 7 quality: all bands met; {n_pairs} pair stages in {pair_s:.1f} s; "
             + ", ".join(f"{v} {r:.2f} pairs/s" for v, r in rates.items()))
    return {"describe": described, "launches": launches, "expected_launches": expected,
            "chunk6_kernels": {"totals": chunk6, "rows": chunk6_rows}, "results": results,
            "jax": {k: {v: {c: r[v][c] for c in cells} for v in results} for k, r in refs.items()},
            "pair_stages_s": pair_s,
            "pairs_per_sec": rates,
            "bands": QUALITY_BANDS, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the full report as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from roreg_tpu_torch.data.synthetic import synthetic_pair
    from roreg_tpu_torch.pipeline.config import PipelineConfig

    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        report = {"device": phase_device(), "build_s": phase_build()}
        gather_cfg = PipelineConfig(engine="gather", use_rm=False)
        block_cfg = PipelineConfig(use_rm=False)  # the default engine: block
        default_cfg = PipelineConfig()  # the JAX package's default chain
        pair = synthetic_pair(args.seed, points_per_cloud=20000, num_keypoints=block_cfg.num_keypoints)
        total, rows = phase_kernel(gather_cfg, pair, args.seed)
        report["kernel_shapes"] = rows
        block_totals, block_rows = phase_block_kernels(block_cfg, pair, args.seed)
        report["block_kernel_shapes"] = block_rows
        report["reference"] = {c.engine: phase_reference(c, args.seed) for c in (gather_cfg, block_cfg)}
        report["reference"]["rm"] = phase_rm_reference(default_cfg, args.seed)
        block_per_chunk = {"halo_conv": 17, "block_gather": 4, "up_conv": 3, "skip_concat": 2, "cell_dense": 2}
        report["slice"] = phase_slice(gather_cfg, pair, args.seed, {"gather_conv": 20}, "phase 4 gather slice")
        report["block_slice"] = phase_slice(block_cfg, pair, args.seed, block_per_chunk, "phase 5 block slice")
        report["default_slice"] = phase_slice(
            default_cfg, pair, args.seed, block_per_chunk, "phase 6 default chain (block engine + RM)")
        report["quality"] = phase_quality(args.seed, block_per_chunk)
        report["total_s"] = time.perf_counter() - T0
        entries = [{
            "name": "gather_conv",
            "route": "cuda",
            "source": "roreg_tpu_torch/csrc/gather_conv.cu",
            "replaces": "roreg_tpu/sparse/window_conv.py:140",
            "launches": report["slice"]["launches"]["gather_conv"],
            "max_abs_err": total["err"],
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if total["t_ops"] >= total["t_bytes"] else "bytes",
            "library_ms": None,
            "library": "none: no PyTorch call computes a gathered sum of per-offset GEMMs",
            "unit": "the 20 convs of one rotation chunk's batched forward (gather engine)",
        }]
        for name, replaces, unit in (
            ("block_gather", "scripts/experiment_pallas_gather.py:67",
             "the 4 gathers of one rotation chunk's batched forward"),
            ("halo_conv", "scripts/experiment_pallas_primitives.py:110",
             "the 17 same/down convs of one rotation chunk's batched forward"),
            ("up_conv", "scripts/experiment_pallas_primitives.py:152",
             "the 3 up convs (after their region gathers) of one rotation chunk's batched forward"),
            ("skip_concat", "scripts/experiment_pallas_primitives.py:177",
             "the 2 bf16 skip concatenations of one rotation chunk's batched forward"),
            ("cell_dense", "scripts/experiment_pallas_primitives.py:75",
             "conv1_tr and final of one rotation chunk's batched forward"),
        ):
            t = block_totals[name]
            libraries = sorted({r["library"] for r in block_rows if r["kernel"] == name})
            entries.append({
                "name": name, "route": "cuda", "source": f"roreg_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": report["default_slice"]["launches"][name],
                "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "library": "; ".join(libraries), "unit": unit + " (block engine)",
            })
        kernels = {"kernels": entries}
        report.update(kernels)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        progress(f"all phases passed in {report['total_s']:.1f} s")
        print(json.dumps(kernels), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": report["device"]["kind"],
            "count": torch.cuda.device_count()}}), flush=True)
    finally:
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
