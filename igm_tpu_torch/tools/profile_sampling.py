"""Where a sampling step's time goes on the card.

    python -m igm_tpu_torch.tools.profile_sampling [--steps 10] [--batch 64] \\
        [--trace trace.json]

Composes ``experiment=ddpm/cifar10`` through the port's config (bf16 on the
card, seeded random weights), warms up, then runs ``--steps`` DDIM steps
under ``torch.profiler``.  Prints the card's name and power limit, the top
kernels by device time, and one JSON line: wall time per step (measured
once without and once under the profiler), device busy time per step (the sum of kernel times; one stream, so they do not overlap),
the idle share, and kernel launches per step, by group.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import compose, instantiate

REPO = Path(__file__).resolve().parent.parent.parent
GROUPS = (("group_norm_mish", ("group_norm_mish",)),
          ("linear_attention", ("linear_attention",)),
          ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "sm90_",
                    "cutlass", "gemm", "nhwc", "nchw")),
          ("copy_cast", ("copy", "cast", "convert")),
          ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.profile_sampling")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--trace", default=None, help="chrome trace output path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    cfg = compose(REPO / "configs", ["experiment=ddpm/cifar10", "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    model.ddim_sample(args.batch, steps=3, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.ddim_sample(args.batch, steps=args.steps, generator=gen)
    torch.cuda.synchronize()
    wall_unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.ddim_sample(args.batch, steps=args.steps, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_group_us, by_group_n = defaultdict(float), defaultdict(int)
    for e in kernels:
        g = group_of(e.name)
        by_group_us[g] += e.time_range.elapsed_us()
        by_group_n[g] += 1
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    steps = args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.splitlines()[0],
        "batch": args.batch, "steps": steps,
        "wall_ms_per_step": 1e3 * wall_unprofiled / steps,
        "wall_ms_per_step_profiled": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / 1e6 / wall_unprofiled,
        "idle_share_profiled": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step_by_group": {g: v / 1e3 / steps for g, v in by_group_us.items()},
        "launches_per_step_by_group": {g: v / steps for g, v in by_group_n.items()},
    }))


if __name__ == "__main__":
    main()
