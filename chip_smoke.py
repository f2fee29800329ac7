"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each ending in one flushed progress line on stderr:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``g++`` for the host voxel hash and ``nvcc`` for the CUDA
   sources (gather_conv, gather_conv_bwd with its dgrad and wgrad kernels,
   block_gather, halo_conv, up_conv, skip_concat, cell_dense), all started
   together, from the sources in this checkout;
3. kernel: the gather-conv kernel against its plain PyTorch version on the
   tables of one full-capacity host pyramid of the synthetic cloud, at the
   11 ResUNetBN2C conv shapes, both as one rotation's table and as the main
   path's table of a whole rotation chunk; error, a second launch that must
   be bit-equal to the first, CUDA-event times, the card's bound and the
   kernel's launch shape (rows per thread block, channels per step, ring
   slots, cluster split) for each;
3d. backward kernels: the gather conv's dgrad and wgrad against their
   plain versions (autograd through gather_conv_plain) at the 20 conv
   shapes of one full-width training forward (the tables of one
   full-capacity host pyramid of cloud 0, one cloud as training runs it),
   with a second launch's gap (f32 atomics: run-to-run nondeterministic),
   max and mean gaps, CUDA-event times, the card's bound and the launch
   shape for each, and beside each kernel the time of a composite of
   library calls that computes the same function (dgrad: one cuBLAS GEMM
   of dY by every offset's W^T, then a masked ``index_add_``; wgrad: a
   masked gather to (M, K, Cin), then one batched GEMM), a yardstick and
   not a single library call;
3b. block kernels: block_gather (bit-exact), halo_conv (1e-3), up_conv
   (1e-3), skip_concat (bit-exact) and cell_dense (1e-5 relative, with the
   level-0 cell mask the main path passes) against their plain versions at
   every shape the block engine's ResUNetBN2C calls, on the tables of the
   main path's own upload of one chunk of cloud 0; error, times, bound and a
   library call's time for each, and halo_conv's and up_conv's launch
   shapes (output blocks per thread block, weight stages);
3e. f32 kernels: with f32 operands and TF32 off (restored after), each
   conv kernel against its f32 plain version, within ``F32_RTOL`` of the
   output's largest magnitude: gather_conv at phase 3's 11 shapes (its
   f32 entry, which splits each gathered f32 row on chip), dgrad and
   wgrad at phase 3d's 20 convs (their f32 entries, one launch a call:
   dgrad's W split in its one packing, wgrad's X split on chip; a second
   call's gap and the library composites at f32 beside), and
   block_gather (f32 rows), halo_conv (its f32 entry, each halo row split
   on chip) and up_conv (its f32 entry, each region row split on chip) at
   phase 3b's shapes and at the bench's block capacities; error, times
   beside the bf16 rows, bounds at f32 operand bytes, each f32 conv's
   launch shape, and for every f32 conv the device memory a call takes
   beyond its output and packed weights or scratch (none: no split copy of
   the features or the region, no second output); each f32 conv call's
   device time under ``torch.profiler``, split into its kernel and
   everything else it launches (the weight packing), summed over one
   chunk's forward;
3c. reference: ``register_pair`` at a small configuration on the GPU and on
   the CPU (plain versions), gather engine and block engine, whose
   descriptors must agree; and the RM matcher on both devices fed the same
   sampled descriptors and keys, whose Sinkhorn matching scores and matches
   must agree. This also brings up every library the slices call, so the
   later phases time a warm process;
3f. f32 reference: phase 3c's describes at ``backbone_compute_dtype=None``
   on both engines, within ``F32_REFERENCE_ATOL`` and
   ``F32_REFERENCE_MEAN_ATOL``;
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
6f. f32 full width: phase 6 and phase 4 at ``backbone_compute_dtype=None``:
   the same conv launches a chunk as at bf16 (skip_concat none: the f32
   path concatenates with ``torch.cat``), finite rigid transforms;
7. quality: the committed trained weights (``checkpoints/quality_full/``)
   under ``quality_full_config()`` (conv1 kernel 5, chunks of 6 rotations)
   on the JAX package's held-out benchmark scenes (4 + 4 scenes of 7
   clouds). First the five block kernels against their plain versions at
   chunk 6 on the first cloud (as phase 3b); then each of the 56 clouds is
   described once into one store (each cloud ran 10 chunks of the five
   block kernels, and no block was dropped), and the four chain variants
   register all 168 pairs at keynum 1024 through the batched evaluator
   (``eval_pair_batch`` 6 pairs a call). FMR, IR, RR and the Predator
   protocol's RR must lie within the bands of ``QUALITY_BANDS`` around the
   JAX package's rows for these weights on the CPU; ``QUALITY.json``'s TPU
   rows are printed beside. Last, the pose-sync probe on the first
   3dmatch_analog scene (21 pairs, pair 0 corrupted by 90 degrees and 1 m):
   the synchronized RR may fall at most one pair below the raw RR, and
   must beat the corrupted RR where pair 0 registered in the raw run;
7d. pair batch: one batch of 7 pairs of that scene at the bench's width
   (keynum 1000, 1000 yohoo iterations, the default chain, the trained
   weights) through the batched pair stage and one pair at a time with the
   same permutations: transforms within ``PAIR_BATCH_T_TOL``, ``m0``,
   ``m1`` and ``est_valid`` equal;
8a. bench kernels: phase 3b's check at the bench's block capacities
   (2880, 832, 240, 80) and at its fallback (3072, 1024, 512, 256), chunk
   10, on the bench's cloud 0;
8b. bench: ``roreg_tpu_torch.bench.run_bench`` once at its full
   configuration (8 clouds, 28 pairs in 4 batches of 7, both timed
   phases); its JSON line is
   printed, each phase must give 28 finite transforms, each describe must
   have run 6 chunks of the five block kernels, and no block may be
   dropped after a fallback rebuild. Then a host build made to raise on
   the builder thread must end a bench with that exception within 60 s;
9. CLIs: ``cli.demo``, ``cli.testset --dataset demo`` (into the npz
   cache) and ``cli.test --testset demo`` through ``main(argv)`` in a
   temporary directory with random weights; the test run must read both
   clouds from the cache (no kernel launch), write ``pre.log`` and
   ``results.log``, and give no Predator RR (2 clouds); then ``cli.test
   --testset synthetic`` (4 clouds, 6 pairs), whose Predator RR must be a
   number;
10. train: GF, ET, RM and RD each train ``TRAIN_STEPS`` steps through
   ``cli.train``'s set-up at full width (2 synthetic scenes of 3 clouds, the
   default block-engine describe, the reference's batch sizes) in a
   temporary directory; the describes must have run the five block
   kernels, every loss must be finite, and each head's best checkpoint must
   load into a ``PipelineConfig()`` pipeline that registers the smoke pair
   to a proper rigid motion. Steps/s, peak memory and the describes'
   launches are printed per head;
11. backbone training: ``cli.train --component backbone`` for
   ``BACKBONE_STEPS`` steps at full width (the CLI's ``PipelineConfig``,
   capacities 32768/16384/8192/4096, conv1 kernel 7, bf16, 2 synthetic
   scenes of 3 clouds of 20000 points, 1024 pairs) in a temporary
   directory: each step's 2 forwards and 1 backward must launch gather_conv
   40 times, dgrad 40 and wgrad 40 and nothing else, every loss must be
   finite; then 12 steps on one fixed batch must lower the loss; the saved
   backbone must load into ``PipelineConfig()`` (block engine) and
   ``PipelineConfig(engine="gather")``, each of which must register the
   smoke pair to a proper rigid motion. Steps/s with the host's batch
   builds apart, and peak memory; then ``PROFILED_STEPS`` more steps on the
   overfit's batch under ``torch.profiler``: device time per step of each
   conv kernel and of everything else, and the device busy share;
11c. f32 backbone training: ``cli.train --component backbone`` at
   ``backbone_compute_dtype=None`` for ``BACKBONE_F32_STEPS`` steps (a step
   launches gather_conv 40, dgrad 40 and wgrad 40 times: one launch a
   call, as at bf16), every loss
   finite, and the 12-step overfit at f32 must lower the loss;
11b. zoo: each ``RESUNET_VARIANTS`` and ``SIMPLENET_VARIANTS`` entry's
   gather-engine forward on one full-width pyramid of cloud 0, kernels
   against plain versions, at phase 3c's tolerance; each forward must
   launch gather_conv once per gather conv;
11d. block zoo: each batch-norm ``RESUNET_VARIANTS`` entry on the block
   engine, ``PipelineConfig(engine="block", backbone_variant=...)`` at full
   width with seeded random weights: cloud 0's describe through
   ``extract_group_features_blocks`` (each chunk must launch the five
   block kernels ``BLOCK_PER_CHUNK`` times and nothing else, no block
   dropped, keypoint features finite and unit-norm), then chunk 0's
   forward against the same forward with ``sparse.block``'s kernel names
   pointed at the plain versions, at phase 3c's tolerance (finite,
   occupied rows unit-norm, padding rows zero); each variant's forward ms
   a chunk and each block kernel's device ms a chunk (``torch.profiler``).
   Then ResUNetBN2E, the widest, registers the smoke pair through
   ``PipelineConfig(backbone_variant="ResUNetBN2E")`` at bf16 and at
   ``backbone_compute_dtype=None`` (the f32 entries; skip_concat none), with
   phase 6's launch counts;
12. device-built pyramids: ``PipelineConfig(engine="gather",
   host_maps=False)`` at full width: all 60 rotations of both clouds
   built on the card bit-equal to the host builder, the describe within
   1e-3 of the host-map describe, ``register_pair`` a rigid motion; the
   device and host build seconds of a cloud;
13. distribution on NCCL in a world of one: ``shard_train_step`` on a GF
   batch against the plain step, ``eval_pairs_sharded`` and
   ``pair_stacks_sharded`` against the batched stage,
   ``all_gather_metrics``.

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
PEAK_TF32_FLOPS = 495e12  # the tensor cores' rate for f32 (here with bf16) operands
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
# f32 operands (phase 3e): two bf16 terms of each (three products) leave
# about 3 * 2^-18 of each product; each kernel is held to 1e-4 of its
# output's largest magnitude against its f32 plain version, TF32 off
F32_RTOL = 1e-4
# phase 3f: small-config descriptors at f32 convs, GPU kernels vs CPU plain
# versions: no bf16 rounding of activations to flip, only the kernels'
# 1e-5 split error carried through 20 convs and their norms
F32_REFERENCE_ATOL = 1e-3
F32_REFERENCE_MEAN_ATOL = 1e-4
# phase 11c: backbone training steps at f32 convs
BACKBONE_F32_STEPS = 10
# phase 13: an Adam step moves an element whose gradient is rounding-sized
# (below this share of the largest) by up to the step size either way
# (ROADMAP C19); every other parameter element is held to 1e-5 relative
DIST_NOISE_GRAD = 1e-5
DIST_RTOL = 1e-5

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
# RR >= 0.95 on 3dmatch_analog. The Predator protocol's RR (the 60
# non-consecutive pairs of a split) has the same bands. QUALITY.json's TPU
# rows are printed beside.
QUALITY_BANDS = {"ir": 0.03, "fmr": 0.04, "full_rr_hi_min": 0.97, "full_rr_lo": 0.08,
                 "yohoc_rr_hi_min": 0.95}
# the pose-sync probe: the synchronized RR may lose at most this many of
# its pairs against the raw RR
POSE_SYNC_SLACK_PAIRS = 1
QUALITY_KEYNUM = 1024
# phase 7d: the batched pair stage against the one-pair path, as
# tests/test_dist_eval.py holds the JAX package's (f32 sums in another order)
PAIR_BATCH_T_TOL = 1e-4
# phase 10: steps a head trains
TRAIN_STEPS = 20
# phase 11: backbone training steps at full width, and the overfit's
BACKBONE_STEPS = 30
OVERFIT_STEPS = 12
PROFILED_STEPS = 3
# phase 3d: dgrad and wgrad against autograd through the plain version;
# f32 sums in another order (dgrad: <= 27 x Cout terms with atomic adds;
# wgrad: <= M terms), with dY split into three bf16 terms on the tensor
# cores (2^-24 of it left), outputs of magnitude <~ 100 at these shapes
BWD_ATOL = 1e-2

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


def device_ms_by_tag(fn, tags: dict, reps: int = 5, windows: int = 3) -> dict:
    """Device milliseconds of one warm call of ``fn`` under
    ``torch.profiler`` (mean over ``reps``): for each ``name: tag`` of
    ``tags``, the kernels whose names hold the tag (each must have run),
    and under ``"other"`` everything else the call launches. A window
    whose records lack a tag is profiled again, up to ``windows`` times
    (on the card a window has come back without one of its kernels, the
    same kernel recorded in the windows before and after it); then it
    fails, naming what was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == cuda]
        missing = [t for t in tags.values() if not any(t in e.name for e in device)]
        if not missing:
            break
    else:
        names = sorted({e.name[:80] for e in device})
        raise AssertionError(f"the profiler recorded no {missing} on the device in {windows} windows; it "
                             f"recorded {names}")
    ms = {n: sum(e.time_range.elapsed_us() for e in device if t in e.name) / 1e3 / reps for n, t in tags.items()}
    ms["other"] = sum(e.time_range.elapsed_us() for e in device
                      if not any(t in e.name for t in tags.values())) / 1e3 / reps
    return ms


def device_split_ms(fn, kernel_tag: str, reps: int = 5) -> dict:
    """:func:`device_ms_by_tag` for one kernel: its device ms and the rest's."""
    ms = device_ms_by_tag(fn, {"kernel": kernel_tag}, reps)
    return {"kernel_device_ms": ms["kernel"], "other_device_ms": ms["other"]}


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
    from roreg_tpu_torch.kernels.gather_conv import (
        gather_conv_dgrad_kernel, gather_conv_kernel, gather_conv_wgrad_kernel,
    )
    from roreg_tpu_torch.kernels.halo_conv import halo_conv_kernel
    from roreg_tpu_torch.kernels.skip_concat import skip_concat_kernel
    from roreg_tpu_torch.kernels.up_conv import up_conv_kernel

    return {"gather_conv": gather_conv_kernel, "gather_conv_dgrad": gather_conv_dgrad_kernel,
            "gather_conv_wgrad": gather_conv_wgrad_kernel, "block_gather": block_gather_kernel,
            "halo_conv": halo_conv_kernel, "up_conv": up_conv_kernel,
            "skip_concat": skip_concat_kernel, "cell_dense": cell_dense_kernel}


def phase_build() -> dict:
    from roreg_tpu_torch.native import lib as native_lib

    builds = {"g++ voxelhash": native_lib.build}
    sources = {}
    for name, k in _kernels().items():  # one build per source file
        sources.setdefault(k.source, (name, k))
    builds.update({f"nvcc {k.source}": k.build for _, k in sources.values()})
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(fn, True) for name, fn in builds.items()}
        secs = {name: f.result() for name, f in futures.items()}
    progress("phase 2 build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return secs


def _peak_above(fn) -> tuple[object, int]:
    """``fn()`` and the device memory its call took at its peak beyond what
    was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


def _extra_bytes(call, operands, name: str) -> int:
    """The device memory one f32 conv call takes at its peak beyond its
    output and what its weight packing (``operands()``, the wrapper's own
    step) takes at its peak: 0 up to the allocator's rounding, where a
    split copy of the features would take 3 Cin bf16 a row. Fails above 1
    MiB."""
    packed, pack_peak = _peak_above(operands)
    del packed
    res, peak = _peak_above(call)
    extra = peak - res.numel() * res.element_size() - pack_peak
    del res
    if extra > 1 << 20:
        raise AssertionError(f"{name} at f32: a call took {extra} bytes beyond its output and weight packing")
    return int(extra)


def _f32_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """An f32 kernel's error: its largest gap to the plain version over the
    plain version's largest magnitude."""
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_kernel(cfg, pair: dict, seed: int, device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16) -> tuple[dict, list]:
    """Phase 3 (bf16 operands; one rotation's table and the chunk's) or, at
    f32, phase 3e's gather_conv (the chunk's tables; the error relative to
    the output's largest magnitude, the bound at f32 operand bytes)."""
    from roreg_tpu_torch.core.group import get_group
    from roreg_tpu_torch.kernels.gather_conv import conv_work, gather_conv_kernel, gather_conv_plain
    from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host, tree_slice
    from roreg_tpu_torch.pipeline.extractor import effective_chunk, upload_chunk

    f32 = dtype == torch.float32
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
    total = dict.fromkeys(("ms", "warm_l2_ms", "plain_ms", "bound_ms", "t_ops", "t_bytes", "err",
                           "kernel_device_ms", "other_device_ms"), 0.0)
    tol = F32_RTOL if f32 else KERNEL_ATOL
    peak, elem = (PEAK_TF32_FLOPS, 4) if f32 else (PEAK_BF16_FLOPS, 2)
    for (kind, lvl), cin, cout, uses in CONV_SHAPES:
        src_lvl = lvl if kind in ("same", "down") else lvl + 1
        n_src = caps[src_lvl]
        single = torch.from_numpy(getattr(buf, kind)[lvl][0].astype(np.int32)).to(dev)
        table_b = getattr(batched, kind)[lvl]
        w = (torch.randn(27, cin, cout, generator=gen, device=dev) * (2.0 / (27 * cin)) ** 0.5).to(dtype)
        feats_b = torch.randn(chunk * n_src, cin, generator=gen, device=dev).to(dtype)
        feats_1 = feats_b[:n_src].contiguous()
        row = {"table": f"{kind}[{lvl}]", "M": single.shape[0], "N": n_src, "cin": cin,
               "cout": cout, "uses": uses, "voxels": nvox, "dtype": str(dtype).replace("torch.", "")}
        variants = (("chunk", feats_b, table_b),) if f32 else (("one", feats_1, single), ("chunk", feats_b, table_b))
        for tag, feats, table in variants:
            out_k = gather_conv_kernel(feats, table, w)
            again = gather_conv_kernel(feats, table, w)
            out_p = gather_conv_plain(feats, table, w)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            checked = _f32_err(out_k, out_p) if f32 else err
            if not np.isfinite(checked) or checked > tol:
                raise AssertionError(
                    f"gather_conv {row['table']} {cin}->{cout} ({tag}, {row['dtype']}): "
                    f"{'relative' if f32 else 'max abs'} err {checked} > {tol}")
            if not torch.equal(out_k, again):
                raise AssertionError(f"gather_conv {row['table']} {cin}->{cout} ({tag}): two launches differ")
            del again
            ms = cuda_ms(lambda: gather_conv_kernel(feats, table, w), reps=20, flush=l2_flush)
            warm_ms = cuda_ms(lambda: gather_conv_kernel(feats, table, w), reps=20)
            plain_ms = cuda_ms(lambda: gather_conv_plain(feats, table, w), reps=3, warmup=1,
                               flush=l2_flush)
            ops, nbytes = conv_work(table, cin, cout, elem)
            t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            row[tag] = {"table_dtype": str(table.dtype).replace("torch.", ""), "rows": table.shape[0],
                        "max_abs_err": err, "checked_err": checked, "ms": ms, "warm_l2_ms": warm_ms,
                        "plain_ms": plain_ms, "ops_ms": t_ops, "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "tflops": ops / ms / 1e9,
                        **gather_conv_kernel.launch_shape(table.shape[0], cin, cout, 27, f32)}
            if f32:
                row[tag]["extra_bytes"] = _extra_bytes(lambda: gather_conv_kernel(feats, table, w),
                                                       lambda: gather_conv_kernel.operands(feats, w), "gather_conv")
                row[tag].update(device_split_ms(lambda: gather_conv_kernel(feats, table, w), "gather_conv_kernel"))
            total["err"] = max(total["err"], checked)
        c = row["chunk"]
        total["ms"] += uses * c["ms"]
        total["warm_l2_ms"] += uses * c["warm_l2_ms"]
        total["plain_ms"] += uses * c["plain_ms"]
        total["bound_ms"] += uses * c["bound_ms"]
        total["t_ops"] += uses * c["ops_ms"]
        total["t_bytes"] += uses * c["bytes_ms"]
        if f32:
            total["kernel_device_ms"] += uses * c["kernel_device_ms"]
            total["other_device_ms"] += uses * c["other_device_ms"]
        rows.append(row)
        one = "" if f32 else (f"one-rotation err {row['one']['max_abs_err']:.2e} kernel {row['one']['ms']:.3f} ms "
                              f"plain {row['one']['plain_ms']:.3f} ms | ")
        progress(
            f"  {row['table']:8s} M={row['M']:6d} N={n_src:6d} {cin:3d}->{cout:3d} {row['dtype']}: {one}"
            f"chunk of {chunk} int32 err {c['checked_err']:.2e}{' (relative)' if f32 else ''} "
            f"kernel {c['ms']:.3f} ms (warm L2 {c['warm_l2_ms']:.3f}) plain {c['plain_ms']:.3f} ms bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), {c['tflops']:.1f} TFLOP/s (tol {tol}, bit-equal twice); "
            f"rows/CTA {c['rows_per_cta']}, channels/step {c['channels_per_step']}, stages {c['stages']}, "
            f"cluster split {c['cluster_split']} (chunk)"
            + (f", {c['extra_bytes']} bytes beyond output and weight packing; device time kernel "
               f"{c['kernel_device_ms']:.3f} ms, the rest {c['other_device_ms']:.3f} ms" if f32 else ""))
    total["bound_by"] = "operations" if total["t_ops"] >= total["t_bytes"] else "bytes"
    split = (f"; device time by the profiler: kernel {total['kernel_device_ms']:.3f} ms, everything else the "
             f"calls launch {total['other_device_ms']:.3f} ms" if f32 else "")
    progress(f"phase {'3e f32 gather_conv' if f32 else '3 kernel'}: 11 shapes within {tol}; one chunk's 20 convs: kernel "
             f"{total['ms']:.2f} ms (warm L2 {total['warm_l2_ms']:.2f} ms), plain {total['plain_ms']:.2f} ms, bound "
             f"{total['bound_ms']:.3f} ms{split}")
    return total, rows


def phase_bwd_kernels(cfg, pair: dict, seed: int, device: str = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> tuple[dict, list]:
    """Phase 3d: dgrad and wgrad against their plain versions at the 20
    conv shapes of one full-width training forward (one cloud's host
    pyramid). At f32 (phase 3e) each call launches its f32 entry once; the
    error and a second call's gap are relative to the output's largest
    magnitude (both within ``F32_RTOL``), the bound is at f32 operand
    bytes, the library composites run in f32 (the caller turns TF32 off)
    and their sum is also the totals' ``library_ms``, each call's device
    memory beyond its output and packed weights or scratch is measured,
    and its device time under ``torch.profiler`` is split into its
    kernels and the rest it launches. Returns (totals per kernel over the
    20 convs, rows)."""
    from roreg_tpu_torch.kernels.gather_conv import (
        bwd_work, gather_conv_dgrad_kernel, gather_conv_dgrad_plain,
        gather_conv_wgrad_kernel, gather_conv_wgrad_plain,
    )
    from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host

    f32 = dtype == torch.float32
    tol = F32_RTOL if f32 else BWD_ATOL
    dev = torch.device(device)
    host = alloc_pyramid_buffers(cfg.capacities, cfg.conv1_kernel_size)
    fill_pyramid_host(pair["points0"], cfg.voxel_size, host, conv1_kernel_size=cfg.conv1_kernel_size)
    caps = cfg.capacities
    gen = torch.Generator(device=dev).manual_seed(seed)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    keys = ("ms", "warm_l2_ms", "plain_ms", "composite_ms", "bound_ms", "ops_ms", "bytes_ms") + (
        ("kernel_device_ms", "other_device_ms") if f32 else ())
    totals = {n: {**dict.fromkeys(keys, 0.0), "err": 0.0, "mean_err": 0.0, "rerun_gap": 0.0,
                  **({"extra_bytes": 0} if f32 else {})}
              for n in ("gather_conv_dgrad", "gather_conv_wgrad")}
    rows = []
    for (kind, lvl), cin, cout, uses in CONV_SHAPES:
        n_src = caps[lvl if kind in ("same", "down") else lvl + 1]
        nbr = torch.from_numpy(getattr(host, kind)[lvl].astype(np.int32)).to(dev)
        w = (torch.randn(27, cin, cout, generator=gen, device=dev) * (2.0 / (27 * cin)) ** 0.5).to(dtype)
        feats = torch.randn(n_src, cin, generator=gen, device=dev).to(dtype)
        dy = torch.randn(nbr.shape[0], cout, generator=gen, device=dev)
        dy[~(nbr >= 0).any(1)] = 0.0  # pad rows are masked in the forward: no gradient
        for name, kernel, plain in (("gather_conv_dgrad", gather_conv_dgrad_kernel, gather_conv_dgrad_plain),
                                    ("gather_conv_wgrad", gather_conv_wgrad_kernel, gather_conv_wgrad_plain)):
            out_k = kernel(feats, nbr, w, dy)
            again = kernel(feats, nbr, w, dy)
            out_p = plain(feats, nbr, w, dy)
            torch.cuda.synchronize()
            diff = (out_k - out_p).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            checked = _f32_err(out_k, out_p) if f32 else err
            rerun = _f32_err(again, out_k) if f32 else float((out_k - again).abs().max())
            label = f"{kind}[{lvl}] {cin}->{cout} M={nbr.shape[0]} N={n_src} {str(dtype)[6:]}"
            if not np.isfinite(checked) or checked > tol:
                raise AssertionError(f"{name} {label}: {'relative' if f32 else 'max abs'} err {checked} > {tol}")
            if f32 and not rerun <= tol:
                raise AssertionError(f"{name} {label}: a second call differs by {rerun} (relative) > {tol}")
            del again, out_p
            composite = _COMPOSITES[name]
            comp_err = float((composite(feats, nbr, w, dy) - out_k).abs().max())
            row = {"kernel": name, "shape": label, "uses": uses, "max_abs_err": err, "mean_abs_err": mean_err,
                   "checked_err": checked, "rerun_gap": rerun, "composite_err": comp_err,
                   "ms": cuda_ms(lambda: kernel(feats, nbr, w, dy), reps=20, flush=l2_flush),
                   "warm_l2_ms": cuda_ms(lambda: kernel(feats, nbr, w, dy), reps=20),
                   "plain_ms": cuda_ms(lambda: plain(feats, nbr, w, dy), reps=1 if f32 else 3,
                                       warmup=0 if f32 else 1, flush=l2_flush),
                   "composite_ms": cuda_ms(lambda: composite(feats, nbr, w, dy), reps=5, warmup=1,
                                           flush=l2_flush),
                   **kernel.launch_shape(nbr.shape[0], cin, cout, 27, f32)}
            if f32:
                # the launch's operands beside its output: dgrad's packed
                # weights (and dY as it is), wgrad's dY scratch (and X as it is)
                scratch = row["scratch_bytes"]
                operands = ((lambda: kernel.operands(feats, w, dy)) if name == "gather_conv_dgrad" else
                            (lambda: torch.empty(scratch, dtype=torch.uint8, device=dev)))
                row["extra_bytes"] = _extra_bytes(lambda: kernel(feats, nbr, w, dy), operands, name)
                # device time of the call's kernels (wgrad's split pass and
                # kernel) and of the rest it launches (dgrad's weight packing)
                tags = ({"dgrad": "dgrad_kernel"} if name == "gather_conv_dgrad" else
                        {"split_pass": "wgrad_split_kernel", "wgrad": "wgrad_kernel"})
                dev_ms = device_ms_by_tag(lambda: kernel(feats, nbr, w, dy), tags)
                row["kernel_device_ms"] = sum(dev_ms[t] for t in tags)
                row["other_device_ms"] = dev_ms["other"]
            work = bwd_work(name.rsplit("_", 1)[1], nbr, n_src, cin, cout, 4 if f32 else 2)
            # bound at the tensor cores' TF32 rate: dY stays f32, its partner
            # (W or X) is bf16
            row.update(_bound(*work, PEAK_TF32_FLOPS))
            row["tflops"] = work[0] / row["ms"] / 1e9
            t = totals[name]
            for k in keys:
                t[k] += uses * row[k]
            t["err"], t["rerun_gap"] = max(t["err"], checked), max(t["rerun_gap"], rerun)
            t["mean_err"] = max(t["mean_err"], mean_err)
            if f32:
                t["extra_bytes"] = max(t["extra_bytes"], row["extra_bytes"])
            rows.append(row)
            extra = (f"{row['extra_bytes']} bytes beyond output and operands, device time kernel "
                     f"{row['kernel_device_ms']:.3f} ms and the rest {row['other_device_ms']:.3f} ms; " if f32 else "")
            progress(f"  {name:17s} {label:45s} err max {checked:.2e}{' (relative)' if f32 else ''} mean {mean_err:.2e} "
                     f"(rerun gap {rerun:.1e}) "
                     f"kernel {row['ms']:.3f} ms (warm L2 {row['warm_l2_ms']:.3f}) plain {row['plain_ms']:.3f} ms "
                     f"composite {row['composite_ms']:.3f} ms (err {comp_err:.1e}) {extra}"
                     f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {row['tflops']:.2f} TFLOP/s; "
                     f"{row['blocks']} thread blocks, {row.get('offsets_per_block', row.get('rows_per_block'))} "
                     f"{'offsets' if 'offsets_per_block' in row else 'rows'} each, {row['stages']} stages, "
                     f"{row['smem_bytes']} bytes of shared memory")
    for t in totals.values():
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
        if f32:
            t["library_ms"] = t["composite_ms"]
    progress(f"phase {'3e f32' if f32 else '3d'} backward kernels, one full-width forward's 20 convs: " + "; ".join(
        f"{n} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.2f} ms, library composite {t['composite_ms']:.3f} ms, "
        f"bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}), max err {t['err']:.1e}, mean err {t['mean_err']:.1e}, rerun gap {t['rerun_gap']:.1e} "
        f"(tol {tol})" + (f", device time by the profiler: kernel {t['kernel_device_ms']:.3f} ms, everything else "
                          f"the calls launch {t['other_device_ms']:.3f} ms" if f32 else "")
        for n, t in totals.items()))
    return totals, rows


def _dgrad_composite(feats, nbr, w, dy):
    """dgrad from library calls: dY @ W_k^T for every offset k in one cuBLAS
    GEMM (f32), the products of -1 entries zeroed, then one ``index_add_``
    into dX (they add zero rows to row 0)."""
    m, k = nbr.shape
    cin, cout = w.shape[1], w.shape[2]
    prod = (dy @ w.float().permute(2, 0, 1).reshape(cout, k * cin)).view(m * k, cin)
    idx = nbr.reshape(-1).long()
    prod = prod * (idx >= 0).unsqueeze(1)
    return torch.zeros(feats.shape, dtype=torch.float32, device=dy.device).index_add_(0, idx.clamp_min(0), prod)


def _wgrad_composite(feats, nbr, w, dy):
    """wgrad from library calls: the gathered X rows (M, K, Cin) in f32,
    zero for -1, then one batched GEMM with dY over the rows."""
    idx = nbr.long()
    g = feats.float()[idx.clamp_min(0)] * (idx >= 0).unsqueeze(-1)
    return torch.matmul(g.permute(1, 2, 0), dy)


# phase 3d's yardsticks: library-call composites of dgrad and wgrad, timed
# beside the kernels and used nowhere in the port
_COMPOSITES = {"gather_conv_dgrad": _dgrad_composite, "gather_conv_wgrad": _wgrad_composite}
_COMPOSITE_NOTES = {
    "gather_conv_dgrad": "a composite, not one library call: cuBLAS dY @ [W_k^T] stacked over k, then masked index_add_",
    "gather_conv_wgrad": "a composite, not one library call: masked gather to (M, K, Cin), then one batched GEMM with dY",
}


def _bound(ops: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops_ms": t_ops, "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_block_kernels(cfg, pair: dict, seed: int, device: str = "cuda",
                        tag: str = "phase 3b block kernels",
                        dtype: torch.dtype = torch.bfloat16) -> tuple[dict, list]:
    """The block engine's five kernels against their plain versions at every
    shape of one chunk's forward, on the main path's own upload of chunk 0
    of cloud 0. At f32 (phase 3e) the three the f32 path runs: block_gather
    on f32 rows, halo_conv and up_conv on f32 operands (errors relative to
    the output's largest magnitude, bounds at f32 operand bytes); the f32
    path concatenates with ``torch.cat`` and cell_dense is f32 on both
    paths. Returns (totals per kernel over one chunk's forward, rows)."""
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
    f32 = dtype == torch.float32
    names = ("block_gather", "halo_conv", "up_conv") if f32 else (
        "block_gather", "halo_conv", "up_conv", "skip_concat", "cell_dense")
    conv_tol = ("max_rel", F32_RTOL) if f32 else ("abs", KERNEL_ATOL)
    conv_peak, elem = (PEAK_TF32_FLOPS, 4) if f32 else (PEAK_BF16_FLOPS, 2)
    totals = {name: dict.fromkeys(keys, 0.0) for name in names}
    rows = []

    def measure(name, kernel, plain, library, work, uses, tol, label, peak=PEAK_BF16_FLOPS, launch=None,
                split_tag=None):
        """tol: "exact", or ("abs" | "rel" | "max_rel", limit): "rel" takes
        each element's gap over ``|plain| + 1``, "max_rel" the largest gap
        over the plain version's largest magnitude (then also the total's
        error). library: (one PyTorch
        call computing the same function, what it is). launch: the kernel's
        launch shape, reported with the row. split_tag: the kernel's name,
        to split the call's device time into it and the rest."""
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
            elif kind == "max_rel":
                checked = _f32_err(out_k.float(), out_p.float())
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
        t["err"] = max(t["err"], checked if tol != "exact" and tol[0] == "max_rel" else err)
        t["uses"] += uses
        for k in keys[:-2]:
            t[k] += uses * row[k]
        if split_tag:
            row.update(device_split_ms(kernel, split_tag))
            for k in ("kernel_device_ms", "other_device_ms"):
                t[k] = t.get(k, 0.0) + uses * row[k]
        rows.append(row)
        shape = "".join(f", {k} {v}" for k, v in (launch or {}).items())
        if split_tag:
            shape += f", device time kernel {row['kernel_device_ms']:.3f} ms, the rest {row['other_device_ms']:.3f} ms"
        progress(f"  {name:12s} {label:34s} err {err:.2e} kernel {row['ms']:.3f} ms (warm L2 "
                 f"{row['warm_l2_ms']:.3f}) plain {row['plain_ms']:.3f} ms library {row['library_ms']:.3f} ms "
                 f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {row['gbps']:.0f} GB/s, "
                 f"{row['tflops']:.1f} TFLOP/s{shape}")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for use, lvl, r in BLOCK_GATHER_SHAPES:
        if use == "conv1":
            tbl = pyr.levels[0].same_tbl
            src = occs[0].to(dtype).contiguous()
        else:
            tbl = pyr.up_tbl[lvl]
            src = randn(occs[lvl + 1].numel(), r).to(dtype)
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
        feats = (randn(occs[lvl].shape[0], 64, cin) * occs[lvl][..., None]).to(dtype)
        w = (randn(27, cin, cout) * (2.0 / (27 * cin)) ** 0.5).to(dtype)
        # the library yardstick: a dense conv3d over the halo the plain version
        # materialises (the gather is left out of its time)
        halo = halo_gather_plain(feats, tbl, stride).view(-1, span, span, span, cin)
        halo = halo.permute(0, 4, 1, 2, 3).contiguous()
        w5 = w.view(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
        measure("halo_conv", lambda: halo_conv_kernel(feats, tbl, w, mask, span, stride),
                lambda: halo_conv_plain(feats, tbl, w, mask, span, stride),
                (lambda: F.conv3d(halo, w5, stride=stride),
                 "torch.nn.functional.conv3d over the halo the plain version materialises (gather not timed)"),
                halo_work(tbl, mask, cin, cout, stride, elem), uses, conv_tol,
                f"{kind}[{lvl}] {cin}->{cout} B={tbl.shape[0]} {str(dtype)[6:]}", conv_peak,
                launch={**halo_conv_kernel.launch_shape(cin, cout, span, stride, f32),
                        **({"extra_bytes": _extra_bytes(lambda: halo_conv_kernel(feats, tbl, w, mask, span, stride),
                                                        lambda: halo_conv_kernel.operands(feats, w), "halo_conv")}
                           if f32 else {})},
                split_tag="halo_conv_kernel" if f32 else None)
        del halo

    for layer, lvl, cin, cout in UP_SHAPES:
        tbl, mask = pyr.up_tbl[lvl], occs[lvl]
        coarse = (randn(occs[lvl + 1].shape[0], 64, cin) * occs[lvl + 1][..., None]).to(dtype)
        reg = block_gather_plain(coarse.reshape(-1, cin), tbl)  # the main path's up-conv input
        w = (randn(27, cin, cout) * (2.0 / (8 * cin)) ** 0.5).to(dtype)
        # the library yardstick: one stride-2 transposed conv3d of each fine
        # block's 3^3 coarse region (layouts made outside the timed span)
        reg5 = reg.view(-1, 3, 3, 3, cin).permute(0, 4, 1, 2, 3).contiguous()
        w5 = w.view(3, 3, 3, cin, cout).flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        measure("up_conv", lambda: up_conv_kernel(reg, w, mask), lambda: up_conv_plain(reg, w, mask),
                (lambda: F.conv_transpose3d(reg5, w5, stride=2, padding=1),
                 "torch.nn.functional.conv_transpose3d, stride 2, over each fine block's 3^3 region "
                 "(layouts made outside the timed span)"),
                up_work(tbl, mask, cin, cout, elem), 1, conv_tol,
                f"{layer} [{lvl}] {cin}->{cout} B={tbl.shape[0]} {str(dtype)[6:]}", conv_peak,
                launch={**up_conv_kernel.launch_shape(cin, cout, f32),
                        **({"extra_bytes": _extra_bytes(lambda: up_conv_kernel(reg, w, mask),
                                                        lambda: up_conv_kernel.operands(reg, w), "up_conv")}
                           if f32 else {})},
                split_tag="up_conv_kernel" if f32 else None)
        del reg5

    if f32:  # the f32 path runs neither skip_concat nor (in another type) cell_dense
        skips, denses = (), ()
    else:
        skips, denses = SKIP_SHAPES, DENSE_SHAPES

    for layer, lvl, ca, cb in skips:
        a = randn(occs[lvl].shape[0], 64, ca) * occs[lvl][..., None]
        b = randn(occs[lvl].shape[0], 64, cb) * occs[lvl][..., None]
        out_lib = torch.empty(a.shape[:-1] + (ca + cb,), dtype=torch.bfloat16, device=dev)
        measure("skip_concat", lambda: skip_concat_kernel(a, b), lambda: skip_concat_plain(a, b),
                (lambda: torch.cat([a, b], -1, out=out_lib), "torch.cat into a bf16 out= tensor"),
                concat_work(a, b), 1, "exact", f"into {layer} [{lvl}] {ca}+{cb} B={a.shape[0]}")

    row_mask = occs[0].reshape(-1)  # the main path passes the level-0 cell mask
    for layer, ca, cb, n, has_bias, relu in denses:
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
            + (f", device time by the profiler: kernel {t['kernel_device_ms']:.3f} ms, everything else the calls "
               f"launch {t['other_device_ms']:.3f} ms" if "kernel_device_ms" in t else "")
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
    torch.cuda.reset_peak_memory_stats()
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


def phase_reference(cfg, seed: int, device: str = "cuda", atol: float = REFERENCE_ATOL,
                    mean_atol: float = REFERENCE_MEAN_ATOL, tag: str = "phase 3c reference") -> dict:
    """``cfg``'s engine at a small configuration, on the GPU (kernels) and
    on the CPU (plain versions): the descriptors must agree within ``atol``
    (largest gap) and ``mean_atol`` (mean gap)."""
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
        if not errs[name]["max"] <= atol or not errs[name]["mean"] <= mean_atol:
            raise AssertionError(f"{tag}: GPU and CPU describe disagree on {name}: {errs[name]}")
    progress(f"{tag} ({cfg.engine} engine, {cfg.backbone_compute_dtype or 'float32'} convs): small-config "
             f"register_pair descriptors, GPU kernels vs CPU plain versions: {errs} (tol max {atol}, mean {mean_atol})")
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
    gf0, k0, gf1, k1 = (x[None] for x in sampled)  # one pair: B = 1
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
    from roreg_tpu_torch.quality import (
        VARIANTS, describe_scenes, jax_pose_sync, jax_references, pose_sync_probe, quality_scenes, run_variants,
    )
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
        pred_hi, pred_lo = rows[hi]["rr_predator"], rows[lo]["rr_predator"]
        if pred_hi is None or pred_lo is None:
            faults.append(f"{v}: no Predator RR ({pred_hi}, {pred_lo})")
        elif v == "full_rd_rm_et_yohoo":
            if pred_hi < QUALITY_BANDS["full_rr_hi_min"]:
                faults.append(f"{v} {hi} Predator RR {pred_hi:.4f} < {QUALITY_BANDS['full_rr_hi_min']}")
            if abs(pred_lo - ref[v][lo]["rr_predator"]) > QUALITY_BANDS["full_rr_lo"]:
                faults.append(f"{v} {lo} Predator RR {pred_lo:.4f} vs JAX (CPU) {ref[v][lo]['rr_predator']:.4f} "
                              f"(band {QUALITY_BANDS['full_rr_lo']})")
        elif pred_hi < QUALITY_BANDS["yohoc_rr_hi_min"]:
            faults.append(f"{v} {hi} Predator RR {pred_hi:.4f} < {QUALITY_BANDS['yohoc_rr_hi_min']}")
    probe = pose_sync_probe(variables, cfg, first, store, device)
    slack = POSE_SYNC_SLACK_PAIRS / probe["pairs"]
    if probe["rr_corrupted_synced"] < probe["rr_raw"] - slack:
        faults.append(f"pose sync: synchronized RR {probe['rr_corrupted_synced']:.4f} below raw "
                      f"{probe['rr_raw']:.4f} - {slack:.4f}")
    if probe["pair0_registered"] and probe["rr_corrupted_synced"] <= probe["rr_corrupted"]:
        faults.append(f"pose sync did not overrule the corrupted pair: {probe}")
    progress(f"phase 7 pose-sync probe on {first.name}: {probe} (JAX on a TPU: {jax_pose_sync()})")
    if faults:
        raise AssertionError("phase 7 quality outside its bands: " + "; ".join(faults))
    pair_batch = phase_pair_batch(variables, first, store, seed, device)
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
            "pose_sync": probe, "pose_sync_jax_tpu": jax_pose_sync(), "pair_batch": pair_batch,
            "bands": QUALITY_BANDS, "seconds": time.perf_counter() - t0}


def phase_pair_batch(variables: dict, scene, store: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 7d: one batch of 7 pairs of ``scene`` through the batched pair
    stage and the same 7 pairs one at a time, at the bench's width (keynum
    1000, 1000 yohoo iterations, the default chain) on the trained weights
    and the stored descriptors (clouds missing from ``store`` are described
    into it). Each cloud's keypoints are sampled once (RD + NMS), both runs
    take the same permutations; transforms must agree within
    ``PAIR_BATCH_T_TOL``, and ``m0``, ``m1`` and ``est_valid`` must be
    equal."""
    from roreg_tpu_torch.bench import bench_config
    from roreg_tpu_torch.eval.evaluator import Evaluator
    from roreg_tpu_torch.pipeline.quality_config import quality_full_config
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline

    bench_cfg = bench_config()
    cfg = dataclasses.replace(quality_full_config(), keynum=bench_cfg.keynum, max_iter=bench_cfg.max_iter,
                              eval_pair_batch=bench_cfg.eval_pair_batch)
    pipe = RegistrationPipeline(cfg, variables, device=device)
    ev = Evaluator(pipe, desc_store=store)
    nb = cfg.eval_pair_batch
    rows = {}
    with torch.inference_mode():
        for k in range(len(scene.clouds)):
            bb, gf, det = ev.describe_cloud(scene, k)
            kp = pipe._tensor(scene.keypoints[k])
            s = pipe.sample_keypoints(kp, det, torch.ones(kp.shape[0], dtype=torch.bool, device=pipe.device))
            rows[str(k)] = (bb[s], gf[s], kp[s])
        pairs = list(scene.pair_ids)[:nb]
        sets = [torch.stack([rows[p[side]][i] for p in pairs]) for i in range(3) for side in (0, 1)]
        bb0, bb1, gf0, gf1, k0, k1 = sets
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        perm = torch.argsort(torch.rand((nb, cfg.keynum), generator=gen, device=pipe.device), -1)
        secs = {}
        for rep in range(2):  # the first of each is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe.batched_pair_stage(bb0, bb1, gf0, gf1, k0, k1, perm=perm)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            singles = [pipe.pair_stage(bb0[b], bb1[b], gf0[b], gf1[b], k0[b], k1[b], perm=perm[b]) for b in range(nb)]
            torch.cuda.synchronize()
            secs = {"batched_s": t1 - t0, "one_at_a_time_s": time.perf_counter() - t1}
    t_err = max(float((out["transform"][b] - one["transform"]).abs().max()) for b, one in enumerate(singles))
    unequal = {key: [b for b, one in enumerate(singles) if not torch.equal(out[key][b], one[key])]
               for key in ("m0", "m1", "est_valid")}
    res = {"pairs": nb, "keynum": cfg.keynum, "max_transform_err": t_err, "unequal_pairs": unequal,
           "valid_matches": [int(one["est_valid"].sum()) for one in singles], **secs,
           "pairs_per_sec_batched": nb / secs["batched_s"], "pairs_per_sec_one_at_a_time": nb / secs["one_at_a_time_s"]}
    if t_err > PAIR_BATCH_T_TOL or not np.isfinite(t_err) or any(unequal.values()):
        raise AssertionError(f"phase 7d: the batched pair stage differs from the one-pair path: {res}")
    progress(f"phase 7d pair batch: {nb} pairs at keynum {cfg.keynum}, batched vs one at a time: transforms "
             f"within {t_err:.1e} (tol {PAIR_BATCH_T_TOL}), m0/m1/est_valid equal; {res['pairs_per_sec_batched']:.1f} "
             f"pairs/s batched, {res['pairs_per_sec_one_at_a_time']:.1f} one at a time")
    return res


BLOCK_PER_CHUNK = {"halo_conv": 17, "block_gather": 4, "up_conv": 3, "skip_concat": 2, "cell_dense": 2}


def _bench_scene_cloud0(cfg) -> dict:
    """The bench's cloud 0 (its scene's first draws)."""
    from roreg_tpu_torch.data.synthetic import synthetic_scene

    scene = synthetic_scene(np.random.default_rng(0), num_clouds=1, points_per_cloud=20000,
                            num_keypoints=cfg.num_keypoints, overlap=0.75, max_angle_deg=40.0)
    return {"points0": scene.clouds[0], "keys0": scene.keypoints[0]}


def phase_bench_kernels(seed: int, device: str = "cuda") -> dict:
    """Phase 8a: phase 3b's check at the bench's block capacities and at its
    fallback capacities (each alone, no rebuild), on the bench's cloud 0."""
    from roreg_tpu_torch.bench import bench_config

    cfg = bench_config()
    cloud0 = _bench_scene_cloud0(cfg)
    out = {}
    for name, caps in (("bench", cfg.block_caps), ("fallback", cfg.block_caps_fallback)):
        c = dataclasses.replace(cfg, block_caps=caps, block_caps_fallback=None)
        totals, rows = phase_block_kernels(c, cloud0, seed, device,
                                           tag=f"phase 8a block kernels at the {name} block capacities {caps}")
        out[name] = {"block_caps": list(caps), "totals": totals, "rows": rows}
    return out


class _BuildFault(RuntimeError):
    """The fault phase 8b injects into the bench's builder thread."""


def phase_bench(device: str = "cuda") -> dict:
    """Phase 8b: the bench at its full configuration, then with a failing
    host build on its builder thread."""
    import threading

    import roreg_tpu_torch.bench as bench
    from roreg_tpu_torch.pipeline.extractor import effective_chunk

    cfg = bench.bench_config()
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    result, transforms = bench.run_bench(cfg, device=device)
    launches = {name: k.launches for name, k in kernels.items()}
    print(json.dumps(result), flush=True)
    d = result["detail"]
    for phase, T in transforms.items():
        if tuple(T.shape) != (d["n_pairs"], 4, 4) or d["n_pairs"] != 28 or not bool(torch.isfinite(T).all()):
            raise AssertionError(f"bench {phase}: transforms {tuple(T.shape)}, finite {bool(torch.isfinite(T).all())}")
    chunks = cfg.group_size // effective_chunk(cfg.group_size, cfg.group_chunk)
    expected = {name: BLOCK_PER_CHUNK.get(name, 0) * chunks * d["describes"] for name in kernels}
    if launches != expected:
        raise AssertionError(f"bench launches {launches}, expected {expected} "
                             f"({chunks} chunks x {d['describes']} describes)")
    if d["dropped_blocks"]:
        raise AssertionError(f"bench dropped {d['dropped_blocks']} blocks after fallback")
    per_cloud = {n: c // d["describes"] for n, c in launches.items()}
    progress(f"phase 8b bench: {result['value']:.3f} pairs/s end to end (describe {d['describe_s']:.2f} s, "
             f"pair stages {d['pair_stage_s']:.2f} s), device only {d['device_only']['pairs_per_sec']:.3f} "
             f"pairs/s; launches a cloud {per_cloud}; fallback clouds {d['fallback_clouds']}, 0 dropped blocks")

    real = bench.build_cloud_payloads
    callers: list[str] = []

    def failing(*a, **k):  # the untimed builds pass; the builder thread's first build raises
        callers.append(threading.current_thread().name)
        if callers[-1] == "bench-builder":
            raise _BuildFault("injected host build fault")
        return real(*a, **k)

    caught: list[BaseException] = []

    def run() -> None:
        try:
            bench.run_bench(cfg, n_clouds=2, device=device)
        except BaseException as e:
            caught.append(e)

    bench.build_cloud_payloads = failing
    try:
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="bench-fault", daemon=True)
        th.start()
        th.join(60.0)
        fault_s = time.perf_counter() - t0
    finally:
        bench.build_cloud_payloads = real
    if (th.is_alive() or len(caught) != 1 or not isinstance(caught[0], _BuildFault)
            or callers != ["bench-fault"] * 2 + ["bench-builder"]):
        raise AssertionError(f"a failing host build did not end the bench within 60 s: alive {th.is_alive()}, "
                             f"raised {caught!r}, builds on {callers}")
    progress(f"phase 8b bench: a failing host build ended the bench with it after {fault_s:.1f} s")
    return {"result": result, "launches": launches, "expected_launches": expected, "fault_s": fault_s}


def phase_cli(device: str = "cuda") -> dict:
    """Phase 9: the three CLIs through ``main(argv)`` in a temporary
    directory, their own output sent to stderr."""
    import contextlib
    import tempfile

    from roreg_tpu_torch.cli import demo, test as cli_test, testset
    from roreg_tpu_torch.pipeline.extractor import effective_chunk

    kernels = _kernels()
    out: dict = {}
    cfg = cli_test.PipelineConfig()  # the CLIs' describe: the default block engine
    halo_a_cloud = BLOCK_PER_CHUNK["halo_conv"] * (cfg.group_size // effective_chunk(cfg.group_size, cfg.group_chunk))

    def call(name: str, fn, argv: list[str]):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = fn(argv + ["--random_init", "--device", device])
        launches = {n: k.launches for n, k in kernels.items() if k.launches}
        out[name] = {"result": res, "seconds": time.perf_counter() - t0, "launches": launches}
        progress(f"phase 9 {name}: {time.perf_counter() - t0:.1f} s, launches {launches}")
        return res, launches

    with tempfile.TemporaryDirectory(prefix="roreg_cli_") as tmp:
        data, dest = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        res, launches = call("demo", demo.main, ["--data_root", data])
        if not (np.isfinite(res["rre_deg"]) and np.isfinite(res["rte_m"])):
            raise AssertionError(f"cli.demo: {res}")
        if launches.get("halo_conv") != 2 * halo_a_cloud:
            raise AssertionError(f"cli.demo launches {launches}")
        n, _ = call("testset", testset.main, ["--dataset", "demo", "--origin_data_dir", data, "--outdir", dest])
        cached = sorted(os.listdir(os.path.join(dest, "desc_cache", "demo_kitchen")))
        if n != 2 or cached != ["0.npz", "1.npz"]:
            raise AssertionError(f"cli.testset described {n} clouds, cache {cached}")
        summary, launches = call("test demo", cli_test.main,
                                 ["--testset", "demo", "--origin_data_dir", data, "--output_dir", dest])
        if launches:
            raise AssertionError(f"cli.test --testset demo launched {launches}: the cache was not used")
        for f in ("demo_kitchen/pre.log", "results.log"):
            if not os.path.exists(os.path.join(dest, f)):
                raise AssertionError(f"cli.test did not write {f}")
        if summary["pairs"] != 1 or summary["rr_predator"] is not None:
            raise AssertionError(f"cli.test --testset demo: {summary}")
        summary, launches = call("test synthetic", cli_test.main,
                                 ["--testset", "synthetic", "--origin_data_dir", data, "--output_dir", dest])
        if summary["pairs"] != 6 or not isinstance(summary["rr_predator"], float):
            raise AssertionError(f"cli.test --testset synthetic: {summary}")
        if launches.get("halo_conv") != 4 * halo_a_cloud:
            raise AssertionError(f"cli.test --testset synthetic launches {launches}")
    progress(f"phase 9 CLIs: demo RRE {out['demo']['result']['rre_deg']:.2f} deg; testset cached 2 clouds; "
             f"test demo from the cache, rr_predator None; test synthetic {summary['pairs']} pairs, "
             f"RR {summary['rr_pointdsc']:.3f}, Predator RR {summary['rr_predator']:.3f}")
    return out


def phase_train(pair: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 10: each head trains ``TRAIN_STEPS`` steps through
    ``cli.train``'s own set-up (``prepare``: the default block-engine
    describe of 2 synthetic scenes of 3 clouds, the reference's batch sizes,
    4 held-out batches, validation twice) in a temporary directory,
    GF first so that ET trains over the trained GF. The GF/ET feature cache
    is filled before the step loop, so that the loop times training alone.
    Each head's losses must be finite, its best checkpoint must load into a
    ``PipelineConfig()`` pipeline, which must register the smoke pair to a
    proper rigid motion."""
    import contextlib
    import tempfile

    from roreg_tpu_torch.cli import train as cli_train
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.extractor import effective_chunk
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.train.checkpoints import load_pipeline_variables
    from roreg_tpu_torch.weights import init_variables

    kernels = _kernels()
    cfg = PipelineConfig()
    chunks = cfg.group_size // effective_chunk(cfg.group_size, cfg.group_chunk)
    out = {}
    with tempfile.TemporaryDirectory(prefix="roreg_train_") as tmp:
        for comp in ("GF", "ET", "RM", "RD"):
            args = cli_train.get_parser().parse_args([
                "--component", comp, "--steps", str(TRAIN_STEPS), "--val_interval", str(TRAIN_STEPS // 2), "--synthetic_scenes", "2",
                "--data_root", os.path.join(tmp, "data"), "--checkpoint_dir", os.path.join(tmp, "ckpt"),
                "--device", device, "--seed", str(seed)])
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                trainer, ctx = cli_train.prepare(args)
            if ctx["cache"] is not None:  # every cloud's rotated features before the step loop
                rng = np.random.default_rng(seed)
                for ds in ctx["scenes"]:
                    for pc_id in ds.pc_ids:
                        ctx["cache"].get(ds, pc_id, rng)
            torch.cuda.synchronize()
            launches = {n: k.launches for n, k in kernels.items() if k.launches}
            prepare_s = time.perf_counter() - t0
            describes = launches.get("halo_conv", 0) / (BLOCK_PER_CHUNK["halo_conv"] * chunks)
            expected = {n: int(c * chunks * describes) for n, c in BLOCK_PER_CHUNK.items()}
            if describes < 6 or describes != int(describes) or launches != expected:
                raise AssertionError(f"phase 10 {comp}: describe launches {launches}, expected "
                                     f"{BLOCK_PER_CHUNK} x {chunks} chunks a describe")
            del ctx
            losses, secs = [], {"step": 0.0, "val": 0.0, "save": 0.0, "init": 0.0}

            def timed(fn, key):
                def run(*a, **k):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r = fn(*a, **k)
                    torch.cuda.synchronize()
                    secs[key] += time.perf_counter() - t
                    return r
                return run

            step = timed(trainer.step_fn, "step")

            def step_fn(state, batch):
                m = step(state, batch)
                losses.append(float(m["loss"]))
                return m

            trainer.step_fn = step_fn
            trainer.val_fn = timed(trainer.val_fn, "val")
            trainer.save = timed(trainer.save, "save")
            trainer.init_fn = timed(trainer.init_fn, "init")
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            result = trainer.run(steps=TRAIN_STEPS)
            run_s = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated()
            del trainer
            if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
                raise AssertionError(f"phase 10 {comp}: losses {losses}")
            variables = init_variables(cfg, seed)
            loaded = load_pipeline_variables(os.path.join(tmp, "ckpt"), variables, cfg)
            if comp.lower() not in loaded:
                raise AssertionError(f"phase 10 {comp}: the best checkpoint did not load ({loaded})")
            pipe = RegistrationPipeline(cfg, variables, device=device)
            T = pipe.register_pair(pair["points0"], None, pair["keys0"], pair["points1"], None,
                                   pair["keys1"])["transform"].cpu().double()
            del pipe
            R = T[:3, :3]
            if not (bool(torch.isfinite(T).all()) and torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype), atol=1e-4)
                    and abs(float(torch.linalg.det(R)) - 1) < 1e-4):
                raise AssertionError(f"phase 10 {comp}: registration after loading gave {T}")
            out[comp] = {"steps": TRAIN_STEPS, "steps_per_sec": TRAIN_STEPS / secs["step"], "step_s": secs["step"],
                         "val_s": secs["val"], "save_s": secs["save"], "init_s": secs["init"], "run_s": run_s,
                         "prepare_s": prepare_s,
                         "peak_mem_gb": peak / 2**30,
                         "first_loss": losses[0], "last_loss": losses[-1], "best": float(result["best"]),
                         "describes": int(describes), "describe_launches": launches, "loaded": loaded}
            progress(f"phase 10 train {comp}: {TRAIN_STEPS} steps at {out[comp]['steps_per_sec']:.1f} steps/s "
                     f"(loop {run_s:.1f} s: init {secs['init']:.1f} s, validation {secs['val']:.1f} s, saves "
                     f"{secs['save']:.1f} s), "
                     f"peak memory {peak / 2**30:.2f} GiB, loss "
                     f"{losses[0]:.4g} -> {losses[-1]:.4g}; set-up {prepare_s:.1f} s with {int(describes)} describes "
                     f"(launches {launches}); the best checkpoint registered the smoke pair")
    return out


def _check_rigid(T: torch.Tensor, what: str) -> None:
    T = T.cpu().double()
    R = T[:3, :3]
    if not (bool(torch.isfinite(T).all()) and torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype), atol=1e-4)
            and abs(float(torch.linalg.det(R)) - 1) < 1e-4):
        raise AssertionError(f"{what}: transform {T} is not a proper rigid motion")


def phase_backbone_train(pair: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 11 (see the module docstring)."""
    import contextlib
    import tempfile

    from roreg_tpu_torch.cli import train as cli_train
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.train.backbone import backbone_pair_batches, make_backbone_train_step
    from roreg_tpu_torch.train.checkpoints import load_pipeline_variables
    from roreg_tpu_torch.weights import init_variables

    kernels = _kernels()
    per_step = {"gather_conv": 40, "gather_conv_dgrad": 40, "gather_conv_wgrad": 40}
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="roreg_backbone_") as tmp:
        args = cli_train.get_parser().parse_args([
            "--component", "backbone", "--steps", str(BACKBONE_STEPS), "--synthetic_scenes", "2",
            "--data_root", os.path.join(tmp, "data"), "--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--device", device, "--seed", str(seed)])
        cli_train.build_scenes(args)  # the scenes are written before the timed run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = cli_train.train_backbone(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        expected = {n: per_step.get(n, 0) * BACKBONE_STEPS for n in kernels}
        if launches != expected:
            raise AssertionError(f"phase 11: launches {launches}, expected {expected}")
        losses = res["losses"]
        if len(losses) != BACKBONE_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"phase 11: losses {losses}")
        out["cli"] = {"steps": BACKBONE_STEPS, "wall_s": wall, "step_s": res["step_s"], "host_s": res["host_s"],
                      "steps_per_sec": BACKBONE_STEPS / res["step_s"], "peak_mem_gib": peak / 2**30,
                      "first_loss": losses[0], "last_loss": losses[-1], "launches": launches}
        progress(f"phase 11 backbone training: {BACKBONE_STEPS} steps of cli.train --component backbone at full "
                 f"width in {wall:.1f} s: steps {res['step_s']:.2f} s ({out['cli']['steps_per_sec']:.2f} steps/s, "
                 f"device work and its launches), host batch builds {res['host_s']:.2f} s "
                 f"({res['host_s'] / (BACKBONE_STEPS + 1):.3f} s a batch: 2 pyramids + mutual NN), peak memory "
                 f"{peak / 2**30:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} "
                 f"= {per_step} x {BACKBONE_STEPS} steps")

        cfg = PipelineConfig(voxel_size=args.voxel_size, group_size=args.group_size,
                             num_keypoints=cli_train.SCENE["num_keypoints"])
        scenes = cli_train.build_scenes(args)
        batch = next(backbone_pair_batches(scenes, cfg, np.random.default_rng(seed + 7)))
        init_fn, step_fn = make_backbone_train_step(cfg, lr=3e-2, device=device)
        state = init_fn(seed=seed)
        fit = [float(step_fn(state, batch)["loss"]) for _ in range(OVERFIT_STEPS)]
        if not (np.isfinite(fit).all() and np.mean(fit[-3:]) < np.mean(fit[:3])):
            raise AssertionError(f"phase 11: the overfit did not lower the loss: {fit}")
        out["overfit"] = fit
        progress(f"phase 11 overfit: {OVERFIT_STEPS} steps on one batch ({int(batch['pair_mask'].sum())} pairs), "
                 f"loss {fit[0]:.4f} -> {fit[-1]:.4f}")
        out["profile"] = _profile_steps(lambda: float(step_fn(state, batch)["loss"]))
        del state

        for engine in ("block", "gather"):
            pcfg = PipelineConfig(engine=engine)
            variables = init_variables(pcfg, seed)
            loaded = load_pipeline_variables(os.path.join(tmp, "ckpt"), variables, pcfg)
            if loaded != ["backbone"]:
                raise AssertionError(f"phase 11: the trained backbone did not load ({loaded})")
            pipe = RegistrationPipeline(pcfg, variables, device=device)
            T = pipe.register_pair(pair["points0"], None, pair["keys0"], pair["points1"], None,
                                   pair["keys1"], generator=torch.Generator().manual_seed(seed))["transform"]
            del pipe
            _check_rigid(T, f"phase 11 {engine} engine with the trained backbone")
        progress("phase 11: the trained backbone loaded into PipelineConfig() (block engine) and "
                 "PipelineConfig(engine='gather'), each registered the smoke pair to a rigid motion")
    return out


def _profile_steps(step) -> dict:
    """Device time of ``PROFILED_STEPS`` warm backbone steps under
    ``torch.profiler``, per step: the three conv kernels by name, every
    other kernel and copy together (and the largest of them by name), and
    the device busy share of the steps' wall span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from roreg_tpu_torch.profile_pair import _union_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("backbone_steps"):
            for _ in range(PROFILED_STEPS):
                step()  # reads the loss: each step ends synchronised
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    span = next(e for e in events if e.name == "backbone_steps" and e.device_type != cuda).time_range
    device = [e for e in events if e.device_type == cuda and e.name != "backbone_steps"]
    if not device:
        raise AssertionError("phase 11: the profiler recorded no device activity")
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED_STEPS
    # the kernels' names (wgrad's call runs its split pass, then its kernel)
    ours = {"gather_conv": ("gather_conv_kernel",), "gather_conv_dgrad": ("dgrad_kernel",),
            "gather_conv_wgrad": ("wgrad_split_kernel", "wgrad_kernel")}
    kernel_ms = {k: sum(v for n, v in by_name.items() if any(t in n for t in tags)) for k, tags in ours.items()}
    rest = {n: v for n, v in by_name.items() if not any(t in n for tags in ours.values() for t in tags)}
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / PROFILED_STEPS
    res = {"steps": PROFILED_STEPS, "wall_ms": span.elapsed_us() / 1e3 / PROFILED_STEPS,
           "device_busy_ms": busy_ms, "kernel_ms": kernel_ms, "other_ms": sum(rest.values()),
           "top_other": [{"name": n[:120], "ms": v} for n, v in sorted(rest.items(), key=lambda kv: -kv[1])[:8]]}
    res["device_busy_share"] = busy_ms / res["wall_ms"]
    progress(f"phase 11 profile, {PROFILED_STEPS} warm steps on that batch, per step: wall {res['wall_ms']:.2f} ms, "
             f"device busy {busy_ms:.2f} ms ({100 * res['device_busy_share']:.1f} %); "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in kernel_ms.items())
             + f"; every other kernel and copy {res['other_ms']:.2f} ms, largest: "
             + "; ".join(f"{t['ms']:.2f} ms {t['name'][:70]}" for t in res["top_other"][:5]))
    return res


def phase_zoo(pair: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 11b (see the module docstring)."""
    import roreg_tpu_torch.sparse.conv as sconv
    from roreg_tpu_torch.kernels.gather_conv import gather_conv_plain
    from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.extractor import make_backbone, upload_pyramid
    from roreg_tpu_torch.sparse.resunet import RESUNET_VARIANTS, SIMPLENET_VARIANTS
    from roreg_tpu_torch.weights import init_module_variables, load_variables

    dev = torch.device(device)
    base = PipelineConfig(engine="gather")
    host = alloc_pyramid_buffers(base.capacities, base.conv1_kernel_size)
    fill_pyramid_host(pair["points0"], base.voxel_size, host, conv1_kernel_size=base.conv1_kernel_size)
    pyr = upload_pyramid(host, dev)
    mask = pyr.masks[0]
    kernels = _kernels()
    out = {}
    for name in list(RESUNET_VARIANTS) + list(SIMPLENET_VARIANTS):
        net = make_backbone(dataclasses.replace(base, backbone_variant=name))
        load_variables(net, init_module_variables(net, seed))
        net.to(dev).eval()
        convs = 20 if name in RESUNET_VARIANTS else 2 * SIMPLENET_VARIANTS[name][3] - 1
        for k in kernels.values():
            k.launches = 0
        with torch.inference_mode():
            got = net(pyr)
            torch.cuda.synchronize()
            launches = {n: k.launches for n, k in kernels.items() if k.launches}
            real = sconv.gather_conv
            sconv.gather_conv = gather_conv_plain
            try:
                want = net(pyr)
            finally:
                sconv.gather_conv = real
        if launches != {"gather_conv": convs}:
            raise AssertionError(f"phase 11b {name}: launches {launches}, expected {convs} gather_conv")
        d = (got - want).abs()[mask]
        norms = torch.linalg.norm(got[mask], dim=-1)
        # a valid row is unit-norm, or zero where every feature before the
        # final layer (zero bias at init) is zero, in both versions
        err = {"max": float(d.max()), "mean": float(d.mean()),
               "norm_err": float(torch.where(norms > 0, (norms - 1).abs(), torch.zeros_like(norms)).max()),
               "zero_rows": int((norms == 0).sum()), "pad_rows_nonzero": int(got[~mask].any(-1).sum())}
        if (not bool(torch.isfinite(got).all()) or err["max"] > REFERENCE_ATOL or err["mean"] > REFERENCE_MEAN_ATOL
                or err["norm_err"] > 1e-3 or err["pad_rows_nonzero"]):
            raise AssertionError(f"phase 11b {name}: kernels against plain versions {err}")
        out[name] = {"err": err, "launches": launches}
        del net
    progress(f"phase 11b zoo: {len(out)} variants' full-width gather-engine forwards, kernels against plain "
             f"versions: max err {max(v['err']['max'] for v in out.values()):.1e}, mean err "
             f"{max(v['err']['mean'] for v in out.values()):.1e} (tol max {REFERENCE_ATOL}, mean "
             f"{REFERENCE_MEAN_ATOL}); zero rows per variant "
             f"{ {n: v['err']['zero_rows'] for n, v in out.items() if v['err']['zero_rows']} }; gather_conv "
             f"launches = gather convs per variant")
    return out


def phase_block_zoo(pair: dict, seed: int, device: str = "cuda", base=None) -> dict:
    """Phase 11d (see the module docstring). ``base``: the configuration
    whose variant each run replaces (``PipelineConfig(engine="block")`` by
    default; a rehearsal passes a small one)."""
    import roreg_tpu_torch.sparse.block as sblock
    from roreg_tpu_torch.kernels.block_gather import block_gather_plain
    from roreg_tpu_torch.kernels.cell_dense import cell_dense_plain
    from roreg_tpu_torch.kernels.halo_conv import halo_conv_plain
    from roreg_tpu_torch.kernels.skip_concat import skip_concat_plain
    from roreg_tpu_torch.kernels.up_conv import up_conv_plain
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.extractor import (
        build_cloud_payloads, chunk_block_pyramid, effective_chunk, extract_group_features_blocks,
        make_backbone, upload_cloud_payloads,
    )
    from roreg_tpu_torch.sparse.resunet import RESUNET_VARIANTS
    from roreg_tpu_torch.weights import init_module_variables, load_variables

    dev = torch.device(device)
    base = base or PipelineConfig(engine="block")
    chunk = effective_chunk(base.group_size, base.group_chunk)
    n_chunks = base.group_size // chunk
    payload, key_rows, caps, dropped = build_cloud_payloads(pair["points0"], pair["keys0"], base)
    if dropped:
        raise AssertionError(f"phase 11d: cloud 0 drops {dropped} blocks at block_caps {caps}")
    dev_payload, _ = upload_cloud_payloads(payload, key_rows, dev)
    pyr = chunk_block_pyramid(dev_payload, 0, caps, chunk)
    mask = sblock.unpack_cell_occupancy(pyr.levels[0].occ_words).reshape(-1)
    kernels = _kernels()
    plains = {"block_gather": block_gather_plain, "halo_conv": halo_conv_plain, "up_conv": up_conv_plain,
              "skip_concat": skip_concat_plain, "cell_dense": cell_dense_plain}
    expected = {n: c * n_chunks for n, c in BLOCK_PER_CHUNK.items()}
    out = {}
    for name in [v for v, (_, _, norm) in RESUNET_VARIANTS.items() if norm == "BN"]:
        cfg = dataclasses.replace(base, backbone_variant=name)
        net = make_backbone(cfg, engine="block")
        load_variables(net, init_module_variables(net, seed))
        net.to(dev).eval()
        with torch.inference_mode():
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            feats, drop = extract_group_features_blocks(net, pair["points0"], pair["keys0"], cfg, dev)
            torch.cuda.synchronize()
            describe_s = time.perf_counter() - t0
            launches = {n: k.launches for n, k in kernels.items() if k.launches}
            got = net(pyr)
            real = {n: getattr(sblock, n) for n in plains}
            for n, fn in plains.items():
                setattr(sblock, n, fn)
            try:
                want = net(pyr)
            finally:
                for n, fn in real.items():
                    setattr(sblock, n, fn)
            forward_ms = cuda_ms(lambda: net(pyr), reps=3, warmup=1)
            kernel_ms = device_ms_by_tag(lambda: net(pyr), {n: f"{n}_kernel" for n in BLOCK_PER_CHUNK}, reps=3)
        if launches != expected:
            raise AssertionError(f"phase 11d {name}: describe launches {launches}, expected {expected} "
                                 f"({n_chunks} chunks)")
        if drop:
            raise AssertionError(f"phase 11d {name}: {drop} blocks dropped at {caps}")
        k_norm = torch.linalg.norm(feats, dim=-1)
        if (tuple(feats.shape) != (pair["keys0"].shape[0], cfg.group_size, 32)
                or not bool(torch.isfinite(feats).all()) or float((k_norm - 1).abs().max()) > 1e-3):
            raise AssertionError(f"phase 11d {name}: describe {tuple(feats.shape)}, finite "
                                 f"{bool(torch.isfinite(feats).all())}, max |norm-1| {float((k_norm - 1).abs().max())}")
        d = (got - want).abs()[mask]
        norms = torch.linalg.norm(got[mask], dim=-1)
        err = {"max": float(d.max()), "mean": float(d.mean()), "norm_err": float((norms - 1).abs().max()),
               "pad_rows_nonzero": int(got[~mask].any(-1).sum())}
        if (not bool(torch.isfinite(got).all()) or err["max"] > REFERENCE_ATOL or err["mean"] > REFERENCE_MEAN_ATOL
                or err["norm_err"] > 1e-3 or err["pad_rows_nonzero"]):
            raise AssertionError(f"phase 11d {name}: chunk 0's forward, kernels against plain versions {err}")
        out[name] = {"launches": launches, "launches_per_chunk": {n: c // n_chunks for n, c in launches.items()},
                     "describe_s": describe_s, "forward_ms": forward_ms, "kernel_ms": kernel_ms, "err": err,
                     "occupied_level0_cells": int(mask.sum())}
        progress(f"phase 11d {name}: describe {describe_s:.2f} s ({n_chunks} chunks, launches a chunk "
                 f"{out[name]['launches_per_chunk']}); chunk 0's forward {forward_ms:.2f} ms, device ms a chunk "
                 + ", ".join(f"{n} {v:.3f}" for n, v in kernel_ms.items())
                 + f"; kernels against plain versions max {err['max']:.1e}, mean {err['mean']:.1e}")
        del net, got, want, feats
        torch.cuda.empty_cache()
    wide = dataclasses.replace(base, backbone_variant="ResUNetBN2E")  # the default chain (RM), widest backbone
    res = {"variants": out,
           "bn2e_slice": phase_slice(wide, pair, seed, BLOCK_PER_CHUNK,
                                     "phase 11d ResUNetBN2E default chain", device),
           "bn2e_slice_f32": phase_slice(dataclasses.replace(wide, backbone_compute_dtype=None), pair, seed,
                                         {**BLOCK_PER_CHUNK, "skip_concat": 0},
                                         "phase 11d ResUNetBN2E default chain at f32 convs", device)}
    progress(f"phase 11d block zoo: {len(out)} batch-norm variants on the block engine at full width, each "
             f"chunk launching {BLOCK_PER_CHUNK}; kernels against plain versions max "
             f"{max(v['err']['max'] for v in out.values()):.1e}, mean {max(v['err']['mean'] for v in out.values()):.1e} "
             f"(tol {REFERENCE_ATOL}, {REFERENCE_MEAN_ATOL}); forward ms a chunk "
             + ", ".join(f"{n} {v['forward_ms']:.2f}" for n, v in out.items()))
    return res


def phase_f32_kernels(gather_cfg, block_cfg, pair: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 3e: the conv kernels with f32 operands against their f32 plain
    versions, TF32 off for cuBLAS and cuDNN (restored after): gather_conv at
    phase 3's 11 shapes, dgrad and wgrad at phase 3d's 20 convs, and
    block_gather (f32 rows), halo_conv and up_conv at phase 3b's shapes and
    at the bench's block capacities. Returns the totals by kernel (the
    block kernels' at phase 3b's shapes), the rows, and the bench-capacity
    totals."""
    from roreg_tpu_torch.bench import bench_config

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        out["gather_conv"], out["gather_rows"] = phase_kernel(gather_cfg, pair, seed, device, torch.float32)
        out["bwd"], out["bwd_rows"] = phase_bwd_kernels(gather_cfg, pair, seed, device, torch.float32)
        out["block"], out["block_rows"] = phase_block_kernels(block_cfg, pair, seed, device,
                                                              "phase 3e f32 block kernels", torch.float32)
        bcfg = bench_config()
        bcfg = dataclasses.replace(bcfg, block_caps_fallback=None)
        out["bench_block"], _ = phase_block_kernels(
            bcfg, _bench_scene_cloud0(bcfg), seed, device,
            f"phase 3e f32 block kernels at the bench's block capacities {bcfg.block_caps}", torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return out


def _f32_fields(t: dict | None, launches: int, same_as: dict | None = None) -> dict:
    """A kernel's f32 numbers in the kernels line: its phase 3e error (over
    the output's largest magnitude), ms and bound at f32 operand bytes, and
    its launches on the f32 main path (phase 6f, or 11c for the backward
    kernels). ``same_as``: a kernel that is f32 on both paths reports its
    phase 3b numbers (cell_dense: its phase 3b error, relative to ``|plain|
    + 1``); ``t`` None: a kernel the f32 path does not run (skip_concat)."""
    t = t or same_as
    if t is None:
        return {"f32_max_rel_err": None, "f32_ms": None, "f32_bound_ms": None, "f32_plain_ms": None,
                "f32_library_ms": None, "f32_launches": launches}
    return {"f32_max_rel_err": t["err"], "f32_ms": t["ms"], "f32_bound_ms": t["bound_ms"],
            "f32_plain_ms": t["plain_ms"], "f32_library_ms": t.get("library_ms"), "f32_launches": launches}


def phase_backbone_train_f32(seed: int, device: str = "cuda") -> dict:
    """Phase 11c: ``cli.train --component backbone`` with the CLI's
    ``PipelineConfig`` at ``backbone_compute_dtype=None`` (f32 convs on the
    card) for ``BACKBONE_F32_STEPS`` steps: every loss finite, a step
    launching gather_conv, dgrad and wgrad 40 times each (one a call:
    their f32 entries); then the 12-step overfit at f32 must lower the
    loss."""
    import contextlib
    import functools
    import tempfile

    from roreg_tpu_torch.cli import train as cli_train
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.train.backbone import backbone_pair_batches, make_backbone_train_step

    kernels = _kernels()
    per_step = {"gather_conv": 40, "gather_conv_dgrad": 40, "gather_conv_wgrad": 40}
    f32_cfg = functools.partial(PipelineConfig, backbone_compute_dtype=None)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="roreg_backbone_f32_") as tmp:
        args = cli_train.get_parser().parse_args([
            "--component", "backbone", "--steps", str(BACKBONE_F32_STEPS), "--synthetic_scenes", "2",
            "--data_root", os.path.join(tmp, "data"), "--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--device", device, "--seed", str(seed)])
        cli_train.build_scenes(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        real = cli_train.PipelineConfig
        cli_train.PipelineConfig = f32_cfg
        try:
            with contextlib.redirect_stdout(sys.stderr):
                res = cli_train.train_backbone(args)
        finally:
            cli_train.PipelineConfig = real
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        expected = {n: per_step.get(n, 0) * BACKBONE_F32_STEPS for n in kernels}
        if launches != expected:
            raise AssertionError(f"phase 11c: launches {launches}, expected {expected}")
        losses = res["losses"]
        if len(losses) != BACKBONE_F32_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"phase 11c: losses {losses}")
        out["cli"] = {"steps": BACKBONE_F32_STEPS, "step_s": res["step_s"], "host_s": res["host_s"],
                      "steps_per_sec": BACKBONE_F32_STEPS / res["step_s"],
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
                      "launches": launches}
        cfg = f32_cfg(voxel_size=args.voxel_size, group_size=args.group_size,
                      num_keypoints=cli_train.SCENE["num_keypoints"])
        batch = next(backbone_pair_batches(cli_train.build_scenes(args), cfg, np.random.default_rng(seed + 7)))
        init_fn, step_fn = make_backbone_train_step(cfg, lr=3e-2, device=device)
        state = init_fn(seed=seed)
        fit = [float(step_fn(state, batch)["loss"]) for _ in range(OVERFIT_STEPS)]
        if not (np.isfinite(fit).all() and np.mean(fit[-3:]) < np.mean(fit[:3])):
            raise AssertionError(f"phase 11c: the f32 overfit did not lower the loss: {fit}")
        out["overfit"] = fit
        del state
    progress(f"phase 11c f32 backbone training: {BACKBONE_F32_STEPS} steps of cli.train --component backbone at "
             f"backbone_compute_dtype=None, steps {res['step_s']:.2f} s ({out['cli']['steps_per_sec']:.2f} steps/s), "
             f"peak {out['cli']['peak_mem_gib']:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
             f"{launches} = {per_step} x {BACKBONE_F32_STEPS} steps; overfit {fit[0]:.4f} -> {fit[-1]:.4f}")
    return out


def _host_pyramid(points: np.ndarray, cfg):
    from roreg_tpu_torch.native.pyramid import alloc_pyramid_buffers, fill_pyramid_host

    buf = alloc_pyramid_buffers(cfg.capacities, cfg.conv1_kernel_size)
    fill_pyramid_host(points, cfg.voxel_size, buf, conv1_kernel_size=cfg.conv1_kernel_size)
    return buf


def _pyramid_diff(d, h, rep_points: bool = True) -> list[str]:
    """The leaves in which a device-built pyramid ``d`` (tensors) and a host
    build ``h`` (numpy) differ: keys, masks, counts, coordinates of valid
    rows (the host leaves pad rows' coordinates at 0, the reference decodes
    its SENTINEL), every table, the occupancy words and, with
    ``rep_points``, the representative points."""
    bad = []
    eq = lambda a, b: np.array_equal(a.cpu().numpy(), b)  # noqa: E731
    for l, (dl, hl) in enumerate(zip(d.levels, h.levels)):
        n = int(hl.num)
        if not (eq(dl.keys, hl.keys) and eq(dl.mask, hl.mask) and eq(dl.num, hl.num)
                and eq(dl.coords[:n], hl.coords[:n])):
            bad.append(f"level {l}")
    for name in ("same", "down", "up"):
        for l, (dt, ht) in enumerate(zip(getattr(d, name), getattr(h, name))):
            if not eq(dt, ht.astype(np.int32)):
                bad.append(f"{name}[{l}]")
    if not eq(d.conv1_occ, h.conv1_occ.view(np.int32)):
        bad.append("conv1_occ")
    if rep_points and not eq(d.grid.rep_point, h.grid.rep_point):
        bad.append("rep_point")
    return bad


def _tensor_pyramid_diff(d, c) -> list[str]:
    """The leaves (by path) in which two pyramids of tensors differ."""
    bad = []

    def walk(a, b, path):
        if isinstance(a, torch.Tensor):
            if not torch.equal(a.cpu(), b.cpu()):
                bad.append(path)
        elif hasattr(a, "_fields"):
            for f in a._fields:
                walk(getattr(a, f), getattr(b, f), f"{path}.{f}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
    walk(d, c, "pyramid")
    return bad


def phase_device_pyramids(pair: dict, seed: int, device: str = "cuda") -> dict:
    """Phase 12: ``PipelineConfig(engine="gather", host_maps=False)`` at its
    default capacities (32768/16384/8192/4096, G = 60) on the smoke pair.
    The device build divides exactly, as the reference (``p / voxel``); the
    host builder quantizes with ``p * (1 / voxel)``. For every rotation of
    each cloud, fed the same device-rotated points: where no point has
    ``floor(p / voxel) != floor(p * (1 / voxel))`` in f32, the device build
    and the host builder give every table, mask, ``to_voxel`` and
    representative point bit for bit; where one does, the device build
    equals the same code run on the CPU (an exact division there too) in
    every leaf. The rotations under each check and the points whose floors
    differ are counted. The device-built describe of cloud 0 equals the
    host-map describe within gather_conv's 1e-3 at every rotation whose two
    paths' pyramids are equal (the host path rotates on the host, the
    device path on the card); a rotation where they differ fails unless its
    host- and device-rotated points differ or one of its points' floors
    differ. ``register_pair`` registers the pair to a rigid motion with 20
    gather_conv launches a chunk. The device and host build seconds of a
    cloud's 60 rotations are printed."""
    import dataclasses as dc

    from roreg_tpu_torch.core.group import get_group
    from roreg_tpu_torch.native.pyramid import host_to_voxel
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.sparse.kernel_map import build_pyramid
    from roreg_tpu_torch.weights import init_variables

    cfg = PipelineConfig(engine="gather", host_maps=False)
    dev = torch.device(device)
    rots = get_group(cfg.group_size).rotations.astype(np.float32)
    inv = np.float32(1.0) / np.float32(cfg.voxel_size)
    out: dict = {"bit_equal": {}}

    def build(p):
        ones = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        return build_pyramid(p, ones, cfg.voxel_size, cfg.capacities, conv1_kernel_size=cfg.conv1_kernel_size)

    def device_build(pts_dev, R):
        p = pts_dev @ torch.from_numpy(R).to(dev).T
        return p, build(p)

    def floor_flips(p: np.ndarray) -> int:
        return int((np.floor(p / np.float32(cfg.voxel_size)) != np.floor(p * inv)).any(1).sum())

    for cloud in ("points0", "points1"):
        pts_dev = torch.from_numpy(pair[cloud]).to(dev)
        flips, vs_host, vs_exact = 0, 0, 0
        for g in range(cfg.group_size):
            p_dev, d = device_build(pts_dev, rots[g])
            p = p_dev.cpu().numpy()
            flip = floor_flips(p)
            if flip == 0:  # the host builder's quantization is the exact one here
                h = _host_pyramid(p, cfg)
                bad = _pyramid_diff(d, h)
                if not np.array_equal(d.grid.to_voxel.cpu().numpy(),
                                      host_to_voxel(p, cfg.voxel_size, cfg.capacities[0])):
                    bad.append("to_voxel")
                vs_host += 1
                what = "the host builder"
            else:  # the same code on the CPU: the exact division
                bad = _tensor_pyramid_diff(d, build(torch.from_numpy(p)))
                vs_exact += 1
                what = "the exact-division build on the CPU"
            if bad:
                raise AssertionError(f"phase 12 {cloud} rotation {g}: the device build and {what} differ in "
                                     f"{bad} ({flip} points whose floor(p / voxel) and floor(p * (1 / voxel)) "
                                     "differ)")
            flips += flip
            if g == 0:
                out["bit_equal"][cloud] = {"voxels_rotation0": [int(l.num) for l in d.levels]}
        out["bit_equal"][cloud].update({"rotations": cfg.group_size, "floor_flips": flips,
                                        "held_to_host_builder": vs_host, "held_to_exact_division": vs_exact})

    pts_dev = torch.from_numpy(pair["points0"]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = [device_build(pts_dev, R) for R in rots]
    torch.cuda.synchronize()
    out["device_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_pts = [pair["points0"] @ R.T for R in rots]  # as the host-map extractor rotates
    hosts = [_host_pyramid(p, cfg) for p in host_pts]
    out["host_build_s"] = time.perf_counter() - t0
    same = [not _pyramid_diff(d, h, rep_points=False) for (_, d), h in zip(built, hosts)]
    rot_gap = [float(np.abs(p.cpu().numpy() - hp).max()) for (p, _), hp in zip(built, host_pts)]
    host_flips = [floor_flips(hp) for hp in host_pts]
    del built, hosts
    unexplained = [g for g in range(cfg.group_size) if not same[g] and rot_gap[g] == 0.0 and host_flips[g] == 0]
    if unexplained:
        raise AssertionError(f"phase 12: the device and host builds differ at rotations {unexplained}, whose "
                             "host- and device-rotated points are equal and quantize alike")

    variables = init_variables(cfg, seed)
    feats = {}
    for host_maps in (False, True):
        pipe = RegistrationPipeline(dc.replace(cfg, host_maps=host_maps), variables, device=device)
        feats[host_maps] = pipe.extract(pair["points0"], None, pair["keys0"])
        del pipe
    gap = (feats[False] - feats[True]).abs().amax(dim=(0, 2)).cpu()  # per rotation
    held = [g for g in range(cfg.group_size) if same[g]]
    err = float(gap[held].max()) if held else float("nan")
    if not held or not err <= KERNEL_ATOL:
        raise AssertionError(f"phase 12: the device-built describe differs from the host-map describe by {err} "
                             f"at rotations whose pyramids are equal ({len(held)} of {cfg.group_size})")
    out.update({"describe_err": err, "rotations_held": len(held),
                "rotations_differing": {g: float(gap[g]) for g in range(cfg.group_size) if not same[g]}})
    out["slice"] = phase_slice(cfg, pair, seed, {"gather_conv": 20}, "phase 12 device-built pyramids", device)
    progress(f"phase 12 device-built pyramids: all {cfg.group_size} rotations of both clouds bit-equal to "
             f"the host builder where no point's floors differ and to the exact-division build on the CPU where "
             f"one does ({out['bit_equal']}); describe within {err:.2e} of the host-map describe at "
             f"{len(held)} of {cfg.group_size} rotations (tol {KERNEL_ATOL}; pyramids differ at "
             f"{out['rotations_differing']}); a cloud's {cfg.group_size} pyramids: device build {out['device_build_s']:.3f} s, "
             f"host build {out['host_build_s']:.3f} s (one thread, serial)")
    return out


def _gf_batch(b: int, g: int, seed: int) -> dict:
    """A GF batch as tests/test_dist.py makes one: random group features,
    the second side a Cayley-permuted copy, the true indices."""
    from roreg_tpu_torch.core.group import get_group

    rng = np.random.default_rng(seed)
    f0 = rng.normal(size=(b, g, 32)).astype(np.float32)
    idx = rng.integers(0, g, size=b)
    cayley = get_group(g).cayley
    return {"feats0": f0, "feats1": np.stack([f0[i][cayley[idx[i]]] for i in range(b)]), "true_idx": idx}


def phase_dist(seed: int, device: str = "cuda") -> dict:
    """Phase 13: ``torch.distributed`` on NCCL in a world of one (the card
    box has one GPU; tests/test_torch_dist.py runs a gloo world of two):
    ``shard_train_step`` on a GF batch of 32 equals the plain step (loss
    within tests/test_dist.py's 1e-3, parameters within ``DIST_RTOL``, and
    the step size for rounding-sized gradients); ``eval_pairs_sharded`` and
    ``pair_stacks_sharded`` equal the batched stage (transforms within
    ``PAIR_BATCH_T_TOL``, matches equal); ``all_gather_metrics``
    round-trips."""
    import tempfile

    import torch.distributed as dist

    from roreg_tpu_torch.dist import eval as dist_eval
    from roreg_tpu_torch.dist import multihost
    from roreg_tpu_torch.dist.mesh import make_mesh, shard_train_step
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.train.trainer import TrainConfig, make_train_step
    from roreg_tpu_torch.weights import _leaves, flatten_variables, init_variables

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="roreg_nccl_") as tmp:
        multihost.initialize(f"file://{tmp}/init", 1, 0, backend="nccl")
        try:
            mesh = make_mesh(1)
            out["backend"] = dist.get_backend()
            cfg = TrainConfig.defaults("gf")
            batch = _gf_batch(cfg.batch_size, cfg.group_size, seed)
            init_fn, step_fn, _ = make_train_step(cfg, device=device)
            plain, sharded = init_fn(seed=seed), init_fn(seed=seed)
            m_plain = step_fn(plain, batch)
            m_sharded = shard_train_step(step_fn, mesh)(sharded, batch)
            loss_gap = abs(float(m_plain["loss"]) - float(m_sharded["loss"]))
            grads = {"/".join(path): t.grad.cpu() for t, path, _ in _leaves(plain.net)
                     if path[0] == "params" and t.grad is not None}
            gmax = max(float(g.abs().max()) for g in grads.values())
            want, got = flatten_variables(plain.variables()), flatten_variables(sharded.variables())
            worst, noisy_worst = 0.0, 0.0
            for k, w in want.items():
                d = np.abs(got[k] - w)
                if k in grads:
                    g = grads[k].numpy()
                    g = g.T if g.shape != w.shape else g
                    noise = np.abs(g) < DIST_NOISE_GRAD * gmax
                    noisy_worst = max(noisy_worst, float(d[noise].max(initial=0.0)))
                    d, w = d[~noise], w[~noise]
                worst = max(worst, float((d / max(float(np.abs(w).max(initial=0.0)), 1e-12)).max(initial=0.0)))
            if not (loss_gap < 1e-3 and worst <= DIST_RTOL and noisy_worst <= 2 * cfg.lr_init * 1.001):
                raise AssertionError(f"phase 13: the sharded GF step differs from the plain one: loss gap {loss_gap}, "
                                     f"parameters {worst} relative, rounding-gradient elements {noisy_worst}")
            out["train"] = {"loss": float(m_plain["loss"]), "loss_gap": loss_gap, "param_rel_err": worst,
                            "noise_elem_err": noisy_worst}

            ecfg = PipelineConfig(keynum=256)
            pipe = RegistrationPipeline(ecfg, init_variables(ecfg, seed), device=device)
            gen = torch.Generator(device=device).manual_seed(seed)
            b, c, g = 4, 4, ecfg.group_size
            unit = lambda *shape: torch.nn.functional.normalize(  # noqa: E731
                torch.randn(*shape, generator=gen, device=device), dim=-1)
            all_bb, all_gf = unit(c, ecfg.keynum, g, 32), unit(c, ecfg.keynum, g, 32)
            all_kp = torch.rand(c, ecfg.keynum, 3, generator=gen, device=device) * 2.0
            i0, i1 = torch.tensor([0, 0, 1, 2], device=device), torch.tensor([1, 2, 3, 3], device=device)
            perm = torch.argsort(torch.rand(b, ecfg.keynum, generator=gen, device=device), -1)
            sets = [t[i] for t in (all_bb, all_gf, all_kp) for i in (i0, i1)]
            checks = {}
            for name, ref, got in (
                ("eval_pairs_sharded", dist_eval.batched_pair_stage(pipe, *sets, perm=perm),
                 dist_eval.eval_pairs_sharded(mesh, pipe, *sets, perm=perm)),
                ("pair_stacks_sharded", dist_eval.pair_batch_from_stacks(pipe, i0, i1, all_bb, all_gf, all_kp, perm=perm),
                 dist_eval.pair_stacks_sharded(mesh, pipe, i0, i1, all_bb, all_gf, all_kp, perm=perm)),
            ):
                t_gap = float((got["transform"] - ref["transform"]).abs().max())
                same = all(torch.equal(got[k], ref[k]) for k in ("m0", "m1", "est_valid", "keys_m0", "keys_m1")
                           if k in ref)
                if not (t_gap <= PAIR_BATCH_T_TOL and same and bool(torch.isfinite(got["transform"]).all())):
                    raise AssertionError(f"phase 13 {name}: transforms {t_gap}, matches equal {same}")
                checks[name] = {"transform_gap": t_gap, "matches_equal": same}
            out["eval"] = checks
            local = {"pairs": 4.0, "loss": float(m_plain["loss"])}
            gathered = multihost.all_gather_metrics(local)
            if gathered != {k: [float(np.float32(v))] for k, v in local.items()}:
                raise AssertionError(f"phase 13: all_gather_metrics gave {gathered} for {local}")
            out["metrics"] = gathered
        finally:
            dist.destroy_process_group()
    progress(f"phase 13 distribution on {out['backend']}, a world of one: shard_train_step on a GF batch of "
             f"{cfg.batch_size}: loss gap {out['train']['loss_gap']:.1e}, parameters {out['train']['param_rel_err']:.1e} "
             f"relative (tol {DIST_RTOL}), rounding-gradient elements {out['train']['noise_elem_err']:.1e} "
             f"(tol {2 * cfg.lr_init}); " + "; ".join(f"{n} transforms within {v['transform_gap']:.1e}, matches equal"
                                                     for n, v in out["eval"].items())
             + f"; all_gather_metrics {out['metrics']}")
    return out


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
        bwd_totals, bwd_rows = phase_bwd_kernels(gather_cfg, pair, args.seed)
        report["bwd_kernel_shapes"] = bwd_rows
        block_totals, block_rows = phase_block_kernels(block_cfg, pair, args.seed)
        report["block_kernel_shapes"] = block_rows
        report["f32"] = phase_f32_kernels(gather_cfg, block_cfg, pair, args.seed)
        report["reference"] = {c.engine: phase_reference(c, args.seed) for c in (gather_cfg, block_cfg)}
        report["reference"]["rm"] = phase_rm_reference(default_cfg, args.seed)
        report["reference_f32"] = {
            c.engine: phase_reference(dataclasses.replace(c, backbone_compute_dtype=None), args.seed,
                                      atol=F32_REFERENCE_ATOL, mean_atol=F32_REFERENCE_MEAN_ATOL,
                                      tag="phase 3f reference at f32")
            for c in (gather_cfg, block_cfg)}
        block_per_chunk = BLOCK_PER_CHUNK
        report["slice"] = phase_slice(gather_cfg, pair, args.seed, {"gather_conv": 20}, "phase 4 gather slice")
        report["block_slice"] = phase_slice(block_cfg, pair, args.seed, block_per_chunk, "phase 5 block slice")
        report["default_slice"] = phase_slice(
            default_cfg, pair, args.seed, block_per_chunk, "phase 6 default chain (block engine + RM)")
        # f32 convs: the same forward launches a chunk; the f32 path concatenates with torch.cat
        report["f32_slice"] = {
            "block": phase_slice(dataclasses.replace(default_cfg, backbone_compute_dtype=None), pair, args.seed,
                                 {**block_per_chunk, "skip_concat": 0}, "phase 6f default chain at f32 convs"),
            "gather": phase_slice(dataclasses.replace(gather_cfg, backbone_compute_dtype=None), pair, args.seed,
                                  {"gather_conv": 20}, "phase 6f gather engine at f32 convs")}
        report["quality"] = phase_quality(args.seed, block_per_chunk)
        report["bench_kernels"] = phase_bench_kernels(args.seed)
        report["bench"] = phase_bench()
        report["cli"] = phase_cli()
        report["train"] = phase_train(pair, args.seed)
        report["backbone_train"] = phase_backbone_train(pair, args.seed)
        report["backbone_train_f32"] = phase_backbone_train_f32(args.seed)
        report["zoo"] = phase_zoo(pair, args.seed)
        report["block_zoo"] = phase_block_zoo(pair, args.seed)
        report["device_pyramids"] = phase_device_pyramids(pair, args.seed)
        report["dist"] = phase_dist(args.seed)
        report["total_s"] = time.perf_counter() - T0
        f32 = report["f32"]
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
            **_f32_fields(f32["gather_conv"], report["f32_slice"]["gather"]["launches"]["gather_conv"]),
        }]
        for name in ("gather_conv_dgrad", "gather_conv_wgrad"):
            t = bwd_totals[name]
            entries.append({
                "name": name, "route": "cuda", "source": "roreg_tpu_torch/csrc/gather_conv_bwd.cu",
                "replaces": "roreg_tpu/sparse/window_conv.py:140",
                "launches": report["backbone_train"]["cli"]["launches"][name],
                "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "library": "none: no PyTorch call computes the gradient of a gathered sum of per-offset GEMMs",
                "composite_ms": t["composite_ms"],
                "composite": _COMPOSITE_NOTES[name],
                "unit": "the 20 convs of one full-width training forward's backward (one cloud, gather engine)",
                "rerun_gap": t["rerun_gap"],
                **_f32_fields(f32["bwd"][name], report["backbone_train_f32"]["cli"]["launches"][name]),
            })
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
                # this slice's path: the bench's launches, and one chunk's forward at its block capacities
                "bench_launches": report["bench"]["launches"][name],
                "bench_caps_ms": report["bench_kernels"]["bench"]["totals"][name]["ms"],
                "bench_caps_bound_ms": report["bench_kernels"]["bench"]["totals"][name]["bound_ms"],
                # phase 10: the GF feature cache's describes (12 clouds x rotations)
                "train_cache_launches": report["train"]["GF"]["describe_launches"][name],
                # phase 11d: each batch-norm variant's describe of cloud 0, and its device ms a chunk
                "block_zoo_launches": {v: r["launches"][name] for v, r in report["block_zoo"]["variants"].items()},
                "block_zoo_ms": {v: r["kernel_ms"][name] for v, r in report["block_zoo"]["variants"].items()},
                **_f32_fields(f32["block"].get(name), report["f32_slice"]["block"]["launches"][name],
                              t if name == "cell_dense" else None),
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
