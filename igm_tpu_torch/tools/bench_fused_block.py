"""The fused conv3x3+GroupNorm+Mish kernel against its plain version and the
UNet's own Block, at the flagship DDPM shapes.

    python -m igm_tpu_torch.tools.bench_fused_block [--iters 50] [--batch 256] \\
        [--device cpu]

Counterpart of ``tools/bench_fused_block.py``: the forward of the UNet Block
unit at the three levels of the CIFAR-10 flagship (hidden 64, dim_mults
[1, 2, 4]) in bf16, from the same ``np.random.default_rng(0)`` draws, timed
over a DEPTH-fold composition (Cin == Cout at every level).  Variants:

  cuda   ``ops.fused_block.fused_block_fwd``, the kernel (igm_tpu: ``pallas``)
  plain  ``ops.fused_block.block_fwd_plain`` (igm_tpu: ``xla``)
  block  ``networks.unet.Block`` with the same weights: cuDNN's bf16 conv, then
         the GroupNorm+Mish kernel, as the UNet runs it on the card

Prints one JSON line per (shape, variant) with ``ms`` per application, then
one per shape with ``max_abs_diff``: the kernel against the plain version
after one application on the same input, beside the plain output's largest
value (``depth_max_abs_diff``: after the composition; ``block_max_abs_diff``:
the Block after one application).  On the card the time comes from CUDA
events around ``--iters`` compositions, queued behind a short spin so the host
can run ahead (where the host enqueues slower than the card computes, as for
the Block's small calls, the time is the host's); on the CPU from the host
clock, and the ``cuda`` variant prints ``{"variant": "cuda", "skipped":
"cpu"}``.  Without a card and without ``--device cpu`` it raises.  A kernel
failure is not caught.  On the card the kernel launches DEPTH * (1 + iters) + 1
times per shape.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..networks.unet import Block
from ..ops.fused_block import block_fwd_plain, fused_block_fwd
from ..utils.platform import resolve_device
from .profiling import nvidia_smi

SHAPES = ((32, 32, 64, 64), (16, 16, 128, 128), (8, 8, 256, 256))   # (H, W, Cin, Cout)
DEPTH = 20
SLEEP_CYCLES = 50_000_000            # ~25 ms of spin ahead of the timed calls


def inputs(rng: np.random.Generator, batch: int, h: int, w: int, ci: int, co: int,
           device: torch.device):
    """x, w (HWIO) in bf16; b, scale, bias in f32: the draws of igm_tpu's tool."""
    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)
    return (t(rng.normal(size=(batch, h, w, ci)), torch.bfloat16),
            t(rng.normal(size=(3, 3, ci, co)) * 0.05, torch.bfloat16),
            t(rng.normal(size=(co,)) * 0.1, torch.float32),
            t(1 + rng.normal(size=(co,)) * 0.1, torch.float32),
            t(rng.normal(size=(co,)) * 0.1, torch.float32))


def unet_block(w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, dtype: torch.dtype) -> Block:
    """The port's UNet Block holding these weights (HWIO -> OIHW)."""
    ci, co = w.shape[2], w.shape[3]
    block = Block(ci, co, dtype=dtype).to(w.device).eval()
    with torch.no_grad():
        block.Conv_0.weight.copy_(w.float().permute(3, 2, 0, 1))
        block.Conv_0.bias.copy_(b)
        block.GroupNormMish_0.scale.copy_(scale)
        block.GroupNormMish_0.bias.copy_(bias)
    return block


def _time_ms(fn, x: torch.Tensor, iters: int) -> tuple[torch.Tensor, float]:
    """(the output of one untimed warm-up run, then the time per application)
    of ``fn``, a DEPTH-fold composition."""
    out = fn(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        total = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        total = 1e3 * (time.perf_counter() - t0)
    return out, total / (iters * DEPTH)


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def main(argv=None) -> list[dict]:
    """Runs the benchmark and returns the records it printed."""
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.bench_fused_block")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        print(nvidia_smi(), flush=True)
    name = torch.cuda.get_device_name(device) if on_card else str(device)
    # the plain version's f32 conv in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []

    def emit(**record):
        records.append(record)
        print(json.dumps(record), flush=True)

    rng = np.random.default_rng(0)
    with torch.no_grad():
        for h, w, ci, co in SHAPES:
            x, wt, b, sc, bi = inputs(rng, args.batch, h, w, ci, co, device)
            block = unet_block(wt, b, sc, bi, x.dtype)
            one = {"cuda": lambda x: fused_block_fwd(x, wt, b, sc, bi),
                   "plain": lambda x: block_fwd_plain(x, wt, b, sc, bi),
                   "block": block}

            def composed(f):
                def run(x):
                    for _ in range(DEPTH):
                        x = f(x)
                    return x
                return run

            shape = f"{args.batch}x{h}x{w}x{ci}->{co}"
            outs = {}
            for variant, f in one.items():
                if variant == "cuda" and not on_card:
                    emit(shape=shape, variant=variant, skipped="cpu")
                    continue
                deep, ms = _time_ms(composed(f), x, args.iters)
                emit(shape=shape, variant=variant, device=name, ms=ms)
                outs[variant] = (f(x), deep)
            ref, ref_deep = outs["plain"]
            diff = dict(shape=shape, ref_abs_max=ref.float().abs().max().item(),
                        block_max_abs_diff=_max_abs_diff(outs["block"][0], ref),
                        max_abs_diff=None, depth_max_abs_diff=None)
            if on_card:
                diff.update(max_abs_diff=_max_abs_diff(outs["cuda"][0], ref),
                            depth_max_abs_diff=_max_abs_diff(outs["cuda"][1], ref_deep))
            emit(**diff)
    return records


if __name__ == "__main__":
    main()
