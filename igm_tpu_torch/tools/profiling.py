"""What the profiling tools share: the card's name and power limit, and a
``torch.profiler`` run summarised as device time and launches by kernel
group, with its longest idle gaps put down to the program's spans."""
from __future__ import annotations

import subprocess
from collections import defaultdict
from typing import List, Sequence, Tuple

import torch

from ..core import trace

GROUPS = (("group_norm_mish_bwd", ("group_norm_mish_bwd", "sum_partials")),
          ("group_norm_mish", ("group_norm_mish",)),
          ("linear_attention_bwd", ("linear_attention_bwd",)),
          ("linear_attention", ("linear_attention",)),
          ("nearest_codebook", ("nearest_codebook",)),
          ("dropout_attention_fwd", ("dropout_attention_fwd",)),
          ("dropout_attention_dq", ("dropout_attention_dq",)),
          ("dropout_attention_dkv", ("dropout_attention_dkv",)),
          ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "sm90_",
                    "cutlass", "gemm", "nhwc", "nchw")),
          ("optimizer", ("adam", "foreach", "multi_tensor")),
          ("copy_cast", ("copy", "cast", "convert")),
          ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))


# the DiT's device time (no hand kernel on its path): cuBLAS GEMMs (the
# attention products of attn=xla included), the attention core's own kernels
# (softmax; SDPA's fused kernels), LayerNorm, the MoE's routing and slot
# moves, casts and copies, the modulation and residual elementwise ops
DIT_GROUPS = (("attention_core", ("softmax", "flash", "fmha", "sdpa", "attention")),
              ("layer_norm", ("layer_norm", "gammabeta")),
              ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitk", "gemv")),
              ("optimizer", ("adam", "foreach", "multi_tensor")),
              ("moe_routing", ("index", "scatter", "gather", "cumsum", "scan", "argmax")),
              ("copy_cast", ("copy", "cast", "convert")),
              ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def idle_gaps(busy: Sequence[Tuple[float, float]], records: List[dict],
              top: int = 10) -> List[dict]:
    """The ``top`` longest gaps between the device's busy intervals
    (``(start_us, end_us)`` on the profiler's timeline), longest first,
    each put down to the innermost span open at its middle on any thread
    (``trace.on_timeline``'s records; ``none`` where the host was in no
    span) with every thread's innermost span beside it."""
    gaps = []
    reach = None
    for start, end in sorted(busy):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for start, end in gaps[:top]:
        mid = 0.5 * (start + end)
        inner = {}            # each thread's innermost record: the latest started
        for r in records:
            if r["start_us"] <= mid <= r["end_us"] and (
                    r["thread"] not in inner or r["start_us"] >= inner[r["thread"]]["start_us"]):
                inner[r["thread"]] = r
        inner = inner.values()
        label = max(inner, key=lambda r: r["start_us"])["name"] if inner else "none"
        out.append({"start_ms": start / 1e3, "ms": (end - start) / 1e3, "span": label,
                    "threads": sorted({r["name"] for r in inner})})
    return out


def device_summary(prof, steps: int, wall_unprofiled: float, wall: float,
                   groups=GROUPS) -> dict:
    """Per step: device busy time (the sum of kernel times; one stream, so
    they do not overlap), the idle share against the unprofiled and the
    profiled wall time, and launches and device time by group; and the
    ten longest idle gaps of the run (:func:`idle_gaps`)."""
    # device events, without the ranges that user annotations (such as
    # Optimizer.step) span on the device: they would count their kernels twice
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_group_us, by_group_n = defaultdict(float), defaultdict(int)
    for e in kernels:
        g = group_of(e.name, groups)
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
        "idle_gaps": idle_gaps([(e.time_range.start, e.time_range.end) for e in kernels],
                               trace.on_timeline(prof)),
    }


def print_idle_gaps(summary: dict) -> None:
    """:func:`device_summary`'s idle gaps, one line each."""
    print("longest idle gaps (ms, at ms, innermost span; every thread's):")
    for g in summary["idle_gaps"]:
        print(f"  {g['ms']:9.3f} at {g['start_ms']:10.3f}  {g['span']:<20} "
              f"{', '.join(g['threads'])}")
