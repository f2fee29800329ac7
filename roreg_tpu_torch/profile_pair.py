"""Where one full-width ``register_pair`` spends its device time.

    python -m roreg_tpu_torch.profile_pair [--engine block] [--matcher rm] [--seed 0] [--out report.json]

Runs the smoke's seeded 20000-point pair through ``PipelineConfig`` with
``--engine`` and ``--matcher`` (``rm``, the default chain, or ``mutual``,
``use_rm=False``) on the GPU with random weights from the seed: one warm-up
pair, then one pair under ``torch.profiler``. Prints the card's name and
power limit, the pair's wall time and stage times, the device busy share
(the union of all kernel and copy intervals over the pair's wall span), and
the device time of the largest kernels by name; ``--out`` also writes them
as JSON. Needs a CUDA device; fails when the profiler records no device
activity.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="block", choices=("block", "gather"))
    ap.add_argument("--matcher", default="rm", choices=("rm", "mutual"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile, record_function

    from roreg_tpu_torch.data.synthetic import synthetic_pair
    from roreg_tpu_torch.pipeline.config import PipelineConfig
    from roreg_tpu_torch.pipeline.registration import RegistrationPipeline
    from roreg_tpu_torch.weights import init_variables

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = PipelineConfig(use_rm=args.matcher == "rm", engine=args.engine)
    pair = synthetic_pair(args.seed, points_per_cloud=20000, num_keypoints=cfg.num_keypoints)
    pipe = RegistrationPipeline(cfg, init_variables(cfg, args.seed))
    inputs = (pair["points0"], None, pair["keys0"], pair["points1"], None, pair["keys1"])

    def run(timings=None):
        out = pipe.register_pair(*inputs, generator=torch.Generator().manual_seed(args.seed),
                                 timings=timings)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: builds the kernels, first use of every library
    timings: dict[str, float] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("register_pair"):
            run(timings)
        wall_s = time.perf_counter() - t0

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    span = next(e for e in events if e.name == "register_pair" and e.device_type != cuda).time_range
    # kernels and copies; the annotation's own device-timeline span is left out
    device = [e for e in events if e.device_type == cuda and e.name != "register_pair"]
    if not device:
        print("profile_pair: the profiler recorded no device activity", file=sys.stderr)
        return 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device])
    by_name: dict[str, list[float]] = {}
    for e in device:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    report = {
        "device": smi, "engine": args.engine, "matcher": args.matcher, "wall_s": wall_s, "stages_s": timings,
        "span_s": span.elapsed_us() / 1e6, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / span.elapsed_us(),
        "device_kernel_sum_s": sum(v[0] for v in by_name.values()) / 1e6,
        "top": [{"name": n[:160], "device_ms": v[0] / 1e3, "calls": v[1]} for n, v in top],
    }
    print(f"{args.engine} engine, {args.matcher} matcher: register_pair {wall_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
          + f"); device busy {report['device_busy_s']:.3f} s of {report['span_s']:.3f} s "
          f"({100 * report['device_busy_share']:.1f} %)", flush=True)
    for t in report["top"]:
        print(f"  {t['device_ms']:9.3f} ms  {t['calls']:6d} x  {t['name']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
