"""Seeds, weights and the process's clock.

Weights are the benchmark's input: one N(0, 1) draw on the device from a
``torch.Generator`` seeded from ``--seed``, cut into the parameters a
configuration's reference names, each scaled by a rule of its name and
shape.  The program and the reference are handed the same tensors.  No
parameter is zero, so every block, gate and expert does work from the
first step (adaLN-Zero's zero gates would hide the DiT's blocks)."""
from __future__ import annotations

import math
import os
import time
from typing import Dict

import numpy as np


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent seeds for each input, from ``--seed`` (any whole number
    of up to 64 bits)."""
    words = np.random.SeedSequence(int(seed) & (2 ** 64 - 1)).generate_state(8, np.uint32)
    names = ("weights", "data", "order", "draws", "arrivals", "requests", "sample", "spare")
    return {k: int(v) for k, v in zip(names, words)}


def fan_in(shape) -> int:
    """A dense (out, in) or stacked expert (E, in, out) leaf's inputs, a
    convolution's (out, in, k, k) inputs times its window."""
    if len(shape) == 2 or len(shape) == 3:
        return int(shape[1])
    return int(np.prod(shape[1:]))


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, "torch.Tensor"]:
    """float32 weights: matrices and kernels N(0, 1/fan_in); a norm's scale
    (``scale``, ``.g``) 1 + 0.1 N(0, 1); every other vector 0.05 N(0, 1)."""
    import torch
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        z = flat[offset:offset + size].view(shape)
        offset += size
        if len(shape) >= 2:
            out[name] = z * (1.0 / math.sqrt(fan_in(shape)))
        elif name.endswith(".scale") or name.endswith(".g"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.05 * z
    return out


def train_images(n: int, shape, seed: int) -> np.ndarray:
    """A CIFAR-shaped uint8 train set of ``n`` images, uniform bytes."""
    return np.random.default_rng(seed).integers(0, 256, size=(n, *shape), dtype=np.uint8)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of its start
    against the boot clock, to 1/CLK_TCK)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)
