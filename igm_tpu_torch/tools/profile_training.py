"""Where a training step's time goes on the card.

    python -m igm_tpu_torch.tools.profile_training [overrides ...] [--steps 10] \\
        [--batch 256] [--trace trace.json]

Composes the config (default ``experiment=ddpm/cifar10``; e.g.
``experiment=vqvae/cifar10``, or ``experiment=tar/mnist
model.flash_attention=dropout --batch 128`` for TAR with the dropout
flash-attention kernels) through the port's config (bf16 on the card
where the model has a compute dtype, seeded random weights), builds the
train state, warms up, then runs ``--steps`` train steps (the model's
``train_step``: forward, backward, Adam) on one
uint8 batch made on the card, once timed by the host clock and once under
``torch.profiler``.  Prints the card's name and power limit, the top kernels
by device time, and one JSON line: wall time per step, device busy time per
step (the sum of kernel times; one stream, so they do not overlap), the idle
share, images/s, and kernel launches and device time per step by group.
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
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.profile_training")
    parser.add_argument("overrides", nargs="*", default=["experiment=ddpm/cifar10"],
                        help="config overrides (default: experiment=ddpm/cifar10)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--trace", default=None, help="chrome trace output path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA card")
    smi = nvidia_smi()
    print(smi)
    # float32 products and convs in full float32, as the CLIs run them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = compose(REPO / "configs", [*args.overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")
    state = model.init_state(0)
    gen = torch.Generator("cuda").manual_seed(1)
    batch = (torch.randint(0, 256, (args.batch, model.height, model.width,
                                    model.channels), generator=gen, device="cuda",
                           dtype=torch.uint8),
             torch.zeros(args.batch, dtype=torch.int32, device="cuda"))

    def run(steps):
        nonlocal state
        for _ in range(steps):
            state, metrics = model.train_step(state, batch)
        return metrics

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run(args.steps)
    torch.cuda.synchronize()
    wall_unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "overrides": args.overrides, "batch": args.batch, "steps": args.steps,
        "dtype": str(getattr(model, "compute_dtype", torch.float32)),
        "loss": {k: float(v) for k, v in metrics.items()},
        "images_per_s": args.batch * args.steps / wall_unprofiled,
        **device_summary(prof, args.steps, wall_unprofiled, wall)}))


if __name__ == "__main__":
    main()
