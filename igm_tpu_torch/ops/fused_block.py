"""Fused UNet Block forward, conv3x3 + bias + GroupNorm + affine + Mish: the
CUDA kernel's wrapper and its plain version.

Counterpart of ``igm_tpu/ops/pallas_fused_block.py``: ``fused_block_fwd``
(the Pallas kernel) and ``xla_block_fwd`` (the path it competes with), for an
NHWC activation x (N, H, W, Cin), HWIO weights w (3, 3, Cin, Cout) and (Cout,)
conv bias, GroupNorm scale and bias: the conv accumulates in f32, the
GroupNorm statistics are one pass in f32 (``var = max(E[y^2] - E[y]^2, 0)``),
and the output is in x's dtype.  Forward only, as in ``igm_tpu``: no model
trains through it; ``igm_tpu_torch.tools.bench_fused_block`` measures it.
The kernel is in ``igm_tpu_torch/csrc/fused_block.cu``.

:func:`fused_block_fwd` launches the kernel for a CUDA tensor and raises if
it cannot; a CPU tensor takes the plain version.  Its ``launches`` attribute
counts kernel launches.  ``igm_tpu``'s ``nb`` (the samples per TPU grid step)
has no counterpart: the kernel takes one block per (sample, group).
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
# the kernel's layout (csrc/fused_block.cu): each thread owns 8 positions x 4
# channels of one group, at most 1024 threads; one input channel's
# (H+2)x(W+2) tile and its 9 x cg weights (cg rounded up to 4) fit in 46 KB
# of shared memory as f32 (the launch's 48 KB less the reduction buffer)
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
def _kernels() -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("fused_block")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"igm_fused_block_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


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


def _check_fits(h: int, w: int, cout: int, groups: int) -> None:
    """Raises where one group of the shape does not fit the kernel's block."""
    cg = cout // groups
    quads = math.ceil(cg / CHANNELS_PER_THREAD)
    threads = quads * math.ceil(h * w / POSITIONS_PER_THREAD)
    if threads > MAX_THREADS:
        raise ValueError(
            f"fused_block_fwd: a group of {h}x{w} positions x {cg} channels needs "
            f"{threads} threads of {POSITIONS_PER_THREAD} positions x "
            f"{CHANNELS_PER_THREAD} channels; the kernel's limit is {MAX_THREADS}")
    smem = ((h + 2) * (w + 2) + 9 * quads * CHANNELS_PER_THREAD) * 4
    if smem > SMEM_BYTES:
        raise ValueError(
            f"fused_block_fwd: one input channel's {h + 2}x{w + 2} tile and weights "
            f"need {smem} bytes of shared memory; the kernel's limit is {SMEM_BYTES}")


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
    _check_fits(h, ww, cout, groups)
    wt = w.to(x.dtype).contiguous()
    b, scale, bias = (v.float().contiguous() for v in vectors)
    if any(t.device != x.device for t in (wt, b, scale, bias)):
        raise ValueError("fused_block_fwd: inputs on different devices")
    out = torch.empty(n, h, ww, cout, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    err = _kernels()[x.dtype](
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, ww, cin, cout, groups, eps,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed: CUDA error {err}")
    fused_block_fwd.launches += 1
    return out


fused_block_fwd.launches = 0
