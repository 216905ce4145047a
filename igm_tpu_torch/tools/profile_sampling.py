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
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import compose, instantiate
from .profiling import device_summary, nvidia_smi

REPO = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.profile_sampling")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--trace", default=None, help="chrome trace output path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling: needs a CUDA card")
    smi = nvidia_smi()
    print(smi)
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
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "batch": args.batch, "steps": args.steps,
        **device_summary(prof, args.steps, wall_unprofiled, wall)}))


if __name__ == "__main__":
    main()
