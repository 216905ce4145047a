"""Fused UNet Block forward, conv3x3 + bias + GroupNorm + affine + Mish: the
CUDA kernel's wrapper and its plain version.

Counterpart of ``igm_tpu/ops/pallas_fused_block.py``: ``fused_block_fwd``
(the Pallas kernel) and ``xla_block_fwd`` (the path it competes with), for an
NHWC activation x (N, H, W, Cin), HWIO weights w (3, 3, Cin, Cout) and (Cout,)
conv bias, GroupNorm scale and bias: the conv accumulates in f32, the
GroupNorm statistics are one pass in f32 (``var = max(E[y^2] - E[y]^2, 0)``),
and the output is in x's dtype.  Forward only, as in ``igm_tpu``: no model
trains through it; ``igm_tpu_torch.tools.bench_fused_block`` measures it.
The kernels are in ``igm_tpu_torch/csrc/fused_block.cu``.

:func:`fused_block_fwd` takes every shape ``igm_tpu``'s kernel takes.  For a
CUDA tensor it launches a kernel by the route :func:`_route` chooses, or
raises; a CPU tensor takes the plain version.  Its ``launches`` attribute
counts calls that launched (a two-pass call launches two kernels and counts
once).  ``igm_tpu``'s ``nb`` (the samples per TPU grid step) has no
counterpart: the routes tile each sample themselves.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .groupnorm import mish

EPS = 1e-5
# the routes of csrc/fused_block.cu (see _route):
# the tensor-core kernel (bf16): 8 warps a CTA, each 64 positions x 64
# output channels, so a CTA tile holds 64 * 8 / (Cout / 64) positions x all
# Cout (several whole samples where a sample is one tile whose positions
# divide 64, or are a multiple of it, and divide the tile's); Cin in stages
# of 16 channels (a multiple of 8: 16-byte copies, zero past Cin); two
# stages, the tables and the epilogue's sums in at most 227 KB of shared
# memory
MMA_COUTS = (64, 128, 256)
MMA_WARPS, MMA_WARP_POSITIONS, MMA_WARP_CHANNELS, MMA_CHUNK = 8, 64, 64, 16
MMA_RED = MMA_WARPS * MMA_WARP_POSITIONS * MMA_WARP_CHANNELS // 16
MMA_SMEM_LIMIT = 232448
MMA_HALO_PITCH = 48                 # bytes a halo position's 16 channels take
MAX_CLUSTER = 8                     # CTAs of a sample in one cluster (portable)
MAX_INT = 2 ** 31 - 1
# the two-pass FMA conv: tiles of at most 64 positions x 32 output channels
FMA_POSITIONS, FMA_CHANNELS = 64, 32
# the two-pass finish keeps each group's statistics in shared memory
NORM_MAX_GROUPS = 16384
MAX_CTAS = MAX_INT                  # CUDA's grid limit (x dimension)
# the first kernel (the group route): each thread owns 8 positions x 4 channels
# of one group, at most 1024 threads; one input channel's (H+2)x(W+2) tile
# and its 9 x cg weights (cg rounded up to 4) fit in 46 KB of shared memory
# as f32 (the launch's 48 KB less the reduction buffer)
POSITIONS_PER_THREAD, CHANNELS_PER_THREAD, MAX_THREADS = 8, 4, 1024
SMEM_BYTES = 46 * 1024


def block_fwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, groups: int = 8,
                    eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version of the kernel, ``xla_block_fwd``'s arithmetic:
    the conv in f32 on the upcast operands (w first cast to x's dtype; products
    of bf16 values are exact in f32), the bias in f32, one-pass statistics,
    affine and Mish in f32, one cast to x's dtype.  On a card the caller turns
    TF32 off (``torch.backends.cudnn.allow_tf32 = False``)."""
    wt = w.to(x.dtype).float().permute(3, 2, 0, 1)              # HWIO -> OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)
    y = y + b.float()
    n, h, ww, c = y.shape
    g = y.reshape(n, h, ww, groups, c // groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = (g * g).mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    xhat = ((g - mean) * torch.rsqrt(var + eps)).reshape(y.shape)
    return mish(xhat * scale.float() + bias.float()).to(x.dtype)


@functools.cache
def _kernels() -> dict[str, ctypes._CFuncPtr]:
    lib = _build.library("fused_block")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # x, w, b, scale, bias, out, n, h, w, cin, cout, groups, eps, stream
        "igm_fused_block_f32": [ptr] * 6 + [i32] * 6 + [f32, ptr],
        "igm_fused_block_bf16": [ptr] * 6 + [i32] * 6 + [f32, ptr],
        "igm_fused_block_cluster_bf16": [ptr] * 6 + [i32] * 6 + [f32, ptr],
        # x, w, b, y, partials, n, h, w, cin, cout, groups, stream
        "igm_fused_block_conv_mma_bf16": [ptr] * 5 + [i32] * 6 + [ptr],
        "igm_fused_block_conv_fma_f32": [ptr] * 5 + [i32] * 6 + [ptr],
        "igm_fused_block_conv_fma_bf16": [ptr] * 5 + [i32] * 6 + [ptr],
        # y, partials, scale, bias, out, n, hw, cout, groups, tiles, eps, stream
        "igm_fused_block_norm_f32": [ptr] * 5 + [i32] * 5 + [f32, ptr],
        "igm_fused_block_norm_bf16": [ptr] * 5 + [i32] * 5 + [f32, ptr],
        # h, w, cin, cout, groups
        "igm_fused_block_mma_tiles": [i32] * 5,
        "igm_fused_block_fma_tiles": [i32] * 5,
    }
    out = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name.removeprefix("igm_fused_block_")] = fn
    return out


def _round_up(v: int, to: int) -> int:
    return (v + to - 1) // to * to


def _mma_tiles(h: int, w: int, cin: int, cout: int, groups: int) -> int | None:
    """The tensor-core kernel's tiles a sample (csrc ``make_mma_plan``), or
    None where it does not take the shape."""
    if cin <= 0 or cin % 8 or cout not in MMA_COUTS or cout % groups:
        return None
    positions = MMA_WARP_POSITIONS * (MMA_WARPS // (cout // MMA_WARP_CHANNELS))
    tw = min(w, positions)
    th = min(h, positions // tw)
    tiles = math.ceil(h / th) * math.ceil(w / tw)
    tile_pos = th * tw
    pack = (tiles == 1 and tile_pos % 16 == 0 and positions % tile_pos == 0
            and (MMA_WARP_POSITIONS % tile_pos == 0 or tile_pos % MMA_WARP_POSITIONS == 0))
    spc = positions // tile_pos if pack else 1
    halo = (th + 2) * (tw + 2)
    stage = _round_up(spc * halo * MMA_HALO_PITCH, 128) + 9 * MMA_CHUNK * (cout + 8) * 2
    smem = (2 * stage + _round_up((2 * spc * halo + positions) * 4, 128)
            + 4 * (2 * MMA_RED + 2 * spc * cout + 2 * spc * groups))
    return tiles if tiles <= 2 ** 30 and smem <= MMA_SMEM_LIMIT else None


def _fma_tiles(h: int, w: int, cout: int) -> int:
    """The two-pass FMA conv's tiles a sample, spatial x channel (csrc
    ``make_fma_plan``)."""
    tw = min(w, FMA_POSITIONS)
    th = min(h, FMA_POSITIONS // tw)
    return math.ceil(h / th) * math.ceil(w / tw) * math.ceil(cout / FMA_CHANNELS)


def _group_kernel_fits(h: int, w: int, cin: int, cout: int, groups: int) -> bool:
    """Whether one group fits the group kernel's block (csrc ``make_layout``)."""
    quads = math.ceil(cout // groups / CHANNELS_PER_THREAD)
    threads = quads * math.ceil(h * w / POSITIONS_PER_THREAD)
    smem = ((h + 2) * (w + 2) + 9 * quads * CHANNELS_PER_THREAD) * 4
    return cin > 0 and threads <= MAX_THREADS and smem <= SMEM_BYTES


def _route(n: int, h: int, w: int, cin: int, cout: int, groups: int,
           dtype: torch.dtype) -> str:
    """The kernels a CUDA call of this shape runs, by name:

    ``cluster``       bf16 on the tensor cores, a sample's tiles one cluster
                      (bf16, Cin % 8 == 0, Cout in MMA_COUTS, at most
                      MAX_CLUSTER tiles a sample, the plan within shared
                      memory: the flagship's levels);
    ``two_pass_mma``  the same conv with more tiles a sample, writing y in
                      f32 and partial sums, then the normalising kernel;
    ``group``         the first, FMA kernel, one CTA per (sample, group), where a
                      group fits its block (f32 at the flagship's levels);
    ``two_pass_fma``  any other shape, f32 or bf16: the FMA conv writes y and
                      partial sums, then the normalising kernel.

    Raises ValueError only for CUDA's limits: more than MAX_CTAS CTAs, or a
    two-pass shape with more than NORM_MAX_GROUPS groups."""
    route, ctas = None, None
    if dtype == torch.bfloat16 and n * h * w <= MAX_INT:
        tiles = _mma_tiles(h, w, cin, cout, groups)
        if tiles is not None:
            route = "cluster" if tiles <= MAX_CLUSTER else "two_pass_mma"
            # persistent CTAs: only the two-pass route's (sample, tile) units count
            ctas = 0 if route == "cluster" else n * tiles
    if route is None and _group_kernel_fits(h, w, cin, cout, groups):
        route, ctas = "group", n * groups
    if route is None:
        route, ctas = "two_pass_fma", n * _fma_tiles(h, w, cout)
    if ctas > MAX_CTAS:
        raise ValueError(f"fused_block_fwd: {n}x{h}x{w}x{cin}->{cout} needs {ctas} CTAs on "
                         f"the {route} route; CUDA's grid limit is {MAX_CTAS}")
    if route.startswith("two_pass") and groups > NORM_MAX_GROUPS:
        raise ValueError(f"fused_block_fwd: {groups} groups; the two-pass route keeps each "
                         f"group's statistics in shared memory, at most {NORM_MAX_GROUPS}")
    return route


def _check(x: torch.Tensor, w: torch.Tensor, vectors, groups: int) -> None:
    """Shape checks on every device, as ``fused_block_fwd`` asserts and
    ``xla_block_fwd``'s group reshape needs."""
    if x.ndim != 4:
        raise ValueError(f"fused_block_fwd expects NHWC x, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"fused_block_fwd expects HWIO w of shape (3, 3, {cin}, Cout), "
                         f"got {tuple(w.shape)}")
    cout = w.shape[-1]
    if cout % groups != 0:
        raise ValueError(f"channels {cout} not divisible by groups {groups}")
    if any(tuple(v.shape) != (cout,) for v in vectors):
        raise ValueError(f"b, scale and bias must be ({cout},), got "
                         f"{[tuple(v.shape) for v in vectors]}")


def fused_block_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, groups: int = 8,
                    eps: float = EPS) -> torch.Tensor:
    """mish(GroupNorm(conv3x3_same(x, w) + b) * scale + bias), fused.

    x: (N, H, W, Cin) bf16/f32, contiguous; w: (3, 3, Cin, Cout) HWIO, cast to
    x's dtype; b, scale, bias: (Cout,), taken as f32 -> (N, H, W, Cout) in x's
    dtype."""
    vectors = (b, scale, bias)
    _check(x, w, vectors, groups)
    if x.device.type == "cpu":
        return block_fwd_plain(x, w, b, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_fwd: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_block_fwd: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_block_fwd: x must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"fused_block_fwd: {x.device} is not the current device")
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty(n, h, ww, cout, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    route = _route(n, h, ww, cin, cout, groups, x.dtype)
    wt = w.to(x.dtype).contiguous()
    b, scale, bias = (v.float().contiguous() for v in vectors)
    if any(t.device != x.device for t in (wt, b, scale, bias)):
        raise ValueError("fused_block_fwd: inputs on different devices")
    if route in ("cluster", "two_pass_mma") and (x.data_ptr() % 16 or wt.data_ptr() % 16):
        raise ValueError("fused_block_fwd: bf16 x and w must lie on a 16-byte boundary "
                         "(the tensor-core kernel copies them by 16-byte cp.async)")
    k = _kernels()
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    stream = torch.cuda.current_stream().cuda_stream
    shape = (n, h, ww, cin, cout, groups)
    if route in ("cluster", "group"):
        fn = k["cluster_bf16"] if route == "cluster" else k[suffix]
        err = fn(x.data_ptr(), wt.data_ptr(), b.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), *shape, eps, stream)
    else:
        if route == "two_pass_mma":
            conv, tiles = k["conv_mma_bf16"], _mma_tiles(h, ww, cin, cout, groups)
        else:
            conv, tiles = k[f"conv_fma_{suffix}"], _fma_tiles(h, ww, cout)
        y = torch.empty(n, h, ww, cout, dtype=torch.float32, device=x.device)
        partials = torch.empty(n, tiles, groups, 2, dtype=torch.float32, device=x.device)
        err = conv(x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), *shape, stream)
        if err == 0:
            err = k[f"norm_{suffix}"](y.data_ptr(), partials.data_ptr(), scale.data_ptr(),
                                      bias.data_ptr(), out.data_ptr(), n, h * ww, cout,
                                      groups, tiles, eps, stream)
    if err != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed ({route}): CUDA error {err}")
    fused_block_fwd.launches += 1
    return out


fused_block_fwd.launches = 0
