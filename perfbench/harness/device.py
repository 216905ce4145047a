"""The yardstick of the device: the H100's published peaks, the hand
kernels' bounds, and a ``torch.profiler`` trace reduced to busy time,
time by kernel group, the idle gaps and what the host was doing in them.

The peaks, the kernels' operations and bytes, and the kernel groups are
frozen copies of the arithmetic the program's card checks use
(``chip_smoke.py`` ``HBM_BYTES_PER_S``, ``PEAK_OPS``,
``GN_OPS_PER_ELEMENT``, ``GN_BWD_OPS_PER_ELEMENT``, ``LA_BWD_PRODUCTS``,
``parity_gn``, ``parity_gn_bwd``, ``parity_la``, ``parity_la_bwd``;
``igm_tpu_torch/tools/profiling.py`` ``GROUPS``, ``DIT_GROUPS``,
``device_summary``), so a change to the program cannot move them."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12,      # dense bf16 tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
GN_OPS_PER_ELEMENT = 15
GN_BWD_OPS_PER_ELEMENT = 35
LA_BWD_PRODUCTS = 5
LA_HEADS, LA_DIM = 4, 32


def _bound(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def gn_fwd_bound(batch: int, h: int, w: int, c: int, elt: int = 2) -> float:
    """Seconds: x read, the output written, gamma and beta (f32) read."""
    elements = batch * h * w * c
    return _bound(2 * elements * elt + 2 * c * 4, GN_OPS_PER_ELEMENT * elements,
                  PEAK_OPS["float32"])


def gn_bwd_bound(batch: int, h: int, w: int, c: int, elt: int = 2) -> float:
    """Seconds: x and g read, dx written; gamma, beta in, dgamma, dbeta out."""
    elements = batch * h * w * c
    return _bound(3 * elements * elt + 4 * c * 4, GN_BWD_OPS_PER_ELEMENT * elements,
                  PEAK_OPS["float32"])


def la_fwd_bound(batch: int, n: int, elt: int = 2) -> float:
    """Seconds: q, k, v read, the output written; the context and the
    read-out 2 N D^2 a head each, the softmax 3 an element of k."""
    elements = batch * n * LA_HEADS * LA_DIM
    ops = 4 * batch * LA_HEADS * n * LA_DIM * LA_DIM + 3 * elements
    return _bound(4 * elements * elt, ops, PEAK_OPS["bfloat16" if elt == 2 else "float32"])


def la_bwd_bound(batch: int, n: int, elt: int = 2) -> float:
    """Seconds: q, k, v, g read, dq, dk, dv written; five D x D products a
    position and head, 8 operations an element besides."""
    elements = batch * n * LA_HEADS * LA_DIM
    ops = LA_BWD_PRODUCTS * 2 * batch * LA_HEADS * n * LA_DIM * LA_DIM + 8 * elements
    return _bound(7 * elements * elt, ops, PEAK_OPS["bfloat16" if elt == 2 else "float32"])


def unet_kernel_calls(cfg: dict) -> Tuple[List[Tuple[int, int, int]], List[int]]:
    """One UNet forward's GroupNorm+Mish calls (H, W, C) and linear-attention
    calls (N) for a configuration's sizes: two a ResnetBlock, one for the
    final block; one attention a level on the way down, one in the middle,
    one a level on the way up."""
    dims = [cfg["channels"]] + [cfg["hidden_dim"] * m for m in cfg["dim_mults"]]
    levels = len(dims) - 1
    side = cfg["width"]
    gn, la = [], []
    for ind in range(levels):
        s = side >> ind
        gn += [(s, s, dims[ind + 1])] * 4
        la.append(s * s)
    s = side >> (levels - 1)
    gn += [(s, s, dims[-1])] * 4
    la.append(s * s)
    for up in range(levels - 1):
        s = side >> (levels - 1 - up)
        gn += [(s, s, dims[levels - 1 - up])] * 4
        la.append(s * s)
    gn.append((side, side, dims[1]))
    return gn, la


def unet_bounds(cfg: dict, batch: int) -> Dict[str, float]:
    """Seconds of each hand kernel family's bound over one UNet pass at
    ``batch`` in bfloat16: the forward GroupNorm+Mish and linear attention
    (``gn``, ``la``) and their backwards (``gn_bwd``, ``la_bwd``)."""
    gn, la = unet_kernel_calls(cfg)
    return {"gn": sum(gn_fwd_bound(batch, *s) for s in gn),
            "gn_bwd": sum(gn_bwd_bound(batch, *s) for s in gn),
            "la": sum(la_fwd_bound(batch, n) for n in la),
            "la_bwd": sum(la_bwd_bound(batch, n) for n in la),
            "gn_calls": len(gn), "la_calls": len(la)}


def kernel_family(name: str) -> Optional[str]:
    """The hand kernel family of a device kernel's name, or None."""
    low = name.lower()
    if "group_norm_mish_bwd" in low or "sum_partials" in low:
        return "gn_bwd"
    if "group_norm_mish" in low:
        return "gn"
    if "linear_attention_bwd" in low:
        return "la_bwd"
    if "linear_attention" in low:
        return "la"
    return None


GROUPS = (("group_norm_mish_bwd", ("group_norm_mish_bwd", "sum_partials")),
          ("group_norm_mish", ("group_norm_mish",)),
          ("linear_attention_bwd", ("linear_attention_bwd",)),
          ("linear_attention", ("linear_attention",)),
          ("nccl", ("nccl",)),
          ("conv", ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "sm90_",
                    "cutlass", "gemm", "nhwc", "nchw")),
          ("optimizer", ("adam", "foreach", "multi_tensor")),
          ("copy_cast", ("copy", "cast", "convert", "memcpy", "memset")),
          ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))

DIT_GROUPS = (("nccl", ("nccl",)),
              ("attention_core", ("softmax", "flash", "fmha", "sdpa", "attention")),
              ("layer_norm", ("layer_norm", "gammabeta")),
              ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitk", "gemv")),
              ("optimizer", ("adam", "foreach", "multi_tensor")),
              ("moe_routing", ("index", "scatter", "gather", "cumsum", "scan", "argmax")),
              ("copy_cast", ("copy", "cast", "convert", "memcpy", "memset")),
              ("elementwise", ("elementwise", "vectorized", "reduce", "cat")))

KERNEL_GROUPS = {"unet": GROUPS, "dit": DIT_GROUPS}


def group_of(name: str, groups: Sequence = GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


SPAN_PREFIX = "perfbench."


def summarize(prof, window_s: float, groups: Sequence = GROUPS) -> dict:
    """A finished ``torch.profiler`` run over ``window_s`` seconds of wall
    time -> the device's busy seconds (the union of its kernels and copies,
    so overlapping streams count once), each kernel's name and device
    seconds, device seconds by group, and the ten longest idle gaps by the
    harness span (``perfbench.*``) the host was in at the gap's middle."""
    import torch
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
             for e in events if e.name.startswith(SPAN_PREFIX)
             and e.device_type == torch.autograd.DeviceType.CPU]
    busy = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_us = sum(b - a for a, b in busy)
    by_kernel: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    by_group: Dict[str, float] = defaultdict(float)
    for e in device:
        us = e.time_range.elapsed_us()
        by_kernel[e.name] += us / 1e6
        launches[e.name] += 1
        by_group[group_of(e.name, groups)] += us / 1e6
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
            for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    labelled: Dict[str, float] = defaultdict(float)
    for length, start, end in gaps[:10]:
        mid = 0.5 * (start + end)
        inside = [s for s in spans if s[0] <= mid <= s[1]]
        label = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "host"
        labelled[label] += length / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": dict(by_kernel), "launches": dict(launches), "groups": dict(by_group),
            "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1])}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten groups of device operations
    that took most time, and the longest idle gaps by what the host was
    doing, in seconds."""
    ops = sorted(summary["groups"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"][:10]]}


def roofline_share(summary: dict, cfg: dict, batch: int, families: Sequence[str]
                   ) -> Optional[float]:
    """Per cent: the hand kernels' bounds over their measured device time in
    a trace, for ``families`` of them.  Each family's launches count whole
    UNet passes at ``batch`` (its calls a pass, ``unet_kernel_calls``); the
    time is every kernel of the family (the backward's partial sums too).
    None where none of them ran."""
    bounds = unet_bounds(cfg, batch)
    calls = {"gn": bounds["gn_calls"], "gn_bwd": bounds["gn_calls"],
             "la": bounds["la_calls"], "la_bwd": bounds["la_calls"]}
    bound = spent = 0.0
    for name, seconds in summary["kernels"].items():
        family = kernel_family(name)
        if family not in families:
            continue
        spent += seconds
        if "sum_partials" not in name.lower():
            bound += bounds[family] * summary["launches"][name] / calls[family]
    if spent <= 0:
        return None
    return 100.0 * bound / spent


def mfu(r: dict) -> Optional[float]:
    """Per cent of one card's dense bf16 peak: the model FLOPs a card did
    in the window (``perfbench/flops/``) over the window's time."""
    if r["window_s"] <= 0 or r["device"].type != "cuda":
        return None
    return 100.0 * r["flops_per_card"] / r["window_s"] / PEAK_OPS["bfloat16"]


def idle(r: dict) -> Optional[float]:
    """Per cent of a profiled sub-window in which no kernel or copy ran on
    the card (the mean over the cards)."""
    summaries = r.get("summaries") or []
    if not summaries:
        return None
    busy = sum(s["busy_s"] for s in summaries) / len(summaries)
    window = sum(s["window_s"] for s in summaries) / len(summaries)
    return 100.0 * (1.0 - busy / window)
