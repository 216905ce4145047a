"""Where a sampling step's time goes on the card.

    python -m igm_tpu_torch.tools.profile_sampling [overrides ...] [--steps 10] \\
        [--batch 64] [--mode graphed|eager|both] [--trace trace.json]

Composes the config (default ``experiment=ddpm/cifar10``; e.g.
``experiment=latent_ddpm/cifar10`` or ``experiment=tar/mnist``) through the
port's config (bf16 on the card, seeded random weights), warms up, then runs
``--steps`` sampler steps under ``torch.profiler``: DDIM steps for a
diffusion model, KV-cached decode steps from the ``<sos>`` token for TAR
(``--steps 784`` decodes a whole 28x28 image).  Prints the card's name and power limit, the top
kernels by device time, and one JSON line: wall time per step (measured
once without and once under the profiler), device busy time per step (the
sum of kernel times; one stream, so they do not overlap), the idle share,
and kernel launches per step, by group.  A latent model's run includes its
one decode (first-stage quantise and decoder), spread over the steps.
``--mode`` picks the denoiser as a CUDA graph (``graphed``, the default, as
the samplers run it), eagerly (``eager``), or both in turns in one process
(``both``: eager, graphed), one JSON line each; TAR's decode is eager in
both.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import compose, instantiate
from ..utils.platform import set_numerics
from .profiling import device_summary, nvidia_smi

REPO = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.profile_sampling")
    parser.add_argument("overrides", nargs="*", default=["experiment=ddpm/cifar10"],
                        help="config overrides (default: experiment=ddpm/cifar10)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--mode", choices=("graphed", "eager", "both"), default="graphed")
    parser.add_argument("--trace", default=None, help="chrome trace output path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling: needs a CUDA card")
    smi = nvidia_smi()
    print(smi)
    set_numerics()
    cfg = compose(REPO / "configs", [*args.overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    if hasattr(model, "ddim_sample"):
        def run(steps):
            model.ddim_sample(args.batch, steps=steps, generator=gen)
    else:                                   # TAR: one KV decode step per position
        def run(steps):
            model.sample_tokens(model.start_tokens(args.batch)[:, :steps + 1], gen)
    for mode in (("eager", "graphed") if args.mode == "both" else (args.mode,)):
        model.use_graphs = mode == "graphed"
        run(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_unprofiled = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
        if args.trace:
            prof.export_chrome_trace(args.trace.replace(".json", f"_{mode}.json"))
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "mode": mode,
            "overrides": args.overrides, "batch": args.batch, "steps": args.steps,
            **device_summary(prof, args.steps, wall_unprofiled, wall)}))


if __name__ == "__main__":
    main()
