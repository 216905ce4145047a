"""What the profiling tools share: the card's name and power limit, and a
``torch.profiler`` run summarised as device time and launches by kernel
group."""
from __future__ import annotations

import subprocess
from collections import defaultdict

import torch

GROUPS = (("group_norm_mish_bwd", ("group_norm_mish_bwd", "sum_partials")),
          ("group_norm_mish", ("group_norm_mish",)),
          ("linear_attention_bwd", ("linear_attention_bwd",)),
          ("linear_attention", ("linear_attention",)),
          ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "sm90_",
                    "cutlass", "gemm", "nhwc", "nchw")),
          ("optimizer", ("adam", "foreach", "multi_tensor")),
          ("copy_cast", ("copy", "cast", "convert")),
          ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def device_summary(prof, steps: int, wall_unprofiled: float, wall: float) -> dict:
    """Per step: device busy time (the sum of kernel times; one stream, so
    they do not overlap), the idle share against the unprofiled and the
    profiled wall time, and launches and device time by group."""
    # device events, without the ranges that user annotations (such as
    # Optimizer.step) span on the device: they would count their kernels twice
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_group_us, by_group_n = defaultdict(float), defaultdict(int)
    for e in kernels:
        g = group_of(e.name)
        by_group_us[g] += e.time_range.elapsed_us()
        by_group_n[g] += 1
    return {
        "wall_ms_per_step": 1e3 * wall_unprofiled / steps,
        "wall_ms_per_step_profiled": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / 1e6 / wall_unprofiled,
        "idle_share_profiled": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step_by_group": {g: v / 1e3 / steps for g, v in by_group_us.items()},
        "launches_per_step_by_group": {g: v / steps for g, v in by_group_n.items()},
    }
