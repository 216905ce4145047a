"""Fused GroupNorm + Mish: the CUDA kernel's wrapper and its plain version.

Counterpart of ``igm_tpu/ops/pallas_groupnorm.py`` ``group_norm_mish``: per
sample of an NHWC activation, GroupNorm(groups, eps=1e-5) with one-pass f32
statistics, the per-channel affine, then Mish.  The kernel is
``igm_tpu_torch/csrc/group_norm_mish.cu``.

:func:`group_norm_mish` launches the kernel for a CUDA tensor and raises if
it cannot; a CPU tensor takes :func:`group_norm_mish_plain`.  Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

EPS = 1e-5


def mish(y: torch.Tensor) -> torch.Tensor:
    """y * tanh(softplus(y)) with softplus = max(y, 0) + log1p(exp(-|y|)),
    the form ``jax.nn.softplus`` evaluates."""
    return y * torch.tanh(torch.clamp(y, min=0) + torch.log1p(torch.exp(-y.abs())))


def group_norm_mish_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math), any device."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    xhat = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(n, h, w, c)
    y = xhat * gamma.float() + beta.float()
    return mish(y).to(x.dtype)


@functools.cache
def _kernels() -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("group_norm_mish")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"igm_group_norm_mish_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def group_norm_mish(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = 8) -> torch.Tensor:
    """x: (N, H, W, C) bf16/f32; gamma, beta: (C,) f32 -> x's shape and dtype."""
    if x.ndim != 4:
        raise ValueError(f"group_norm_mish expects NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},), got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if x.device.type == "cpu":
        return group_norm_mish_plain(x, gamma, beta, groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_mish: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_mish: unsupported dtype {x.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("group_norm_mish: gamma and beta must be float32")
    if not (x.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("group_norm_mish: inputs must be contiguous")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("group_norm_mish: inputs on different devices")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"group_norm_mish: {x.device} is not the current device")
    n, h, w, _ = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _kernels()[x.dtype](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        n, h * w, c, groups, EPS, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_mish kernel launch failed: CUDA error {err}")
    group_norm_mish.launches += 1
    return out


group_norm_mish.launches = 0
