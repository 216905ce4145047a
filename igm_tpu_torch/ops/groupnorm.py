"""Fused GroupNorm + Mish: the CUDA kernels' wrappers, their plain versions
and the autograd Function that joins them.

Counterpart of ``igm_tpu/ops/pallas_groupnorm.py`` ``group_norm_mish`` and
its custom VJP ``_gnm_bwd``: per sample of an NHWC activation,
GroupNorm(groups, eps=1e-5) with one-pass f32 statistics, the per-channel
affine, then Mish; the backward recomputes the statistics and gives dx (in
x's dtype) and the f32 dgamma/dbeta.  The kernels are in
``igm_tpu_torch/csrc/group_norm_mish.cu``.

:func:`group_norm_mish` and :func:`group_norm_mish_bwd` launch their kernel
for a CUDA tensor and raise if they cannot; a CPU tensor takes the plain
version.  Each has a ``launches`` attribute that counts kernel launches.
:class:`GroupNormMishFn` is what the UNet calls: forward and backward
through the two wrappers.
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


def mish_grad(y: torch.Tensor) -> torch.Tensor:
    """d mish / dy = tanh(sp) + y * sigmoid(y) * (1 - tanh(sp)^2), as
    ``_mish_grad`` (pallas_groupnorm.py:33-36)."""
    t = torch.tanh(torch.clamp(y, min=0) + torch.log1p(torch.exp(-y.abs())))
    return t + y * torch.sigmoid(y) * (1.0 - t * t)


def _normalised(x: torch.Tensor, groups: int):
    """(xhat, inv) of x (N, H, W, C) in the (N, HW, groups, C/groups) view,
    one-pass f32 statistics."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + EPS)
    return (xf - mean) * inv, inv


def group_norm_mish_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math), any device."""
    xhat, _ = _normalised(x, groups)
    y = xhat.reshape(x.shape) * gamma.float() + beta.float()
    return mish(y).to(x.dtype)


def group_norm_mish_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, g: torch.Tensor,
                              groups: int = 8):
    """Plain PyTorch version of the backward kernel, written out as
    ``_bwd_kernel`` (pallas_groupnorm.py:81-95) computes it: g is the
    output's gradient.  Returns (dx in x's dtype, dgamma f32, dbeta f32)."""
    c = x.shape[-1]
    xhat, inv = _normalised(x, groups)
    gam = gamma.float().reshape(groups, c // groups)
    y = xhat * gam + beta.float().reshape(groups, c // groups)
    dy = g.float().reshape(xhat.shape) * mish_grad(y)
    # per-sample partials, then the sum over the batch
    dgamma = (dy * xhat).sum(dim=1).sum(dim=0).reshape(c)
    dbeta = dy.sum(dim=1).sum(dim=0).reshape(c)
    dxhat = dy * gam
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = inv * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


@functools.cache
def _kernels(name: str, pointers: int) -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("group_norm_mish")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def _check(name: str, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           groups: int) -> None:
    """Shape checks on every device."""
    if x.ndim != 4:
        raise ValueError(f"{name} expects NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},), got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")


def _check_cuda(name: str, x: torch.Tensor, *others: torch.Tensor,
                params: tuple[torch.Tensor, ...]) -> None:
    """What the kernels take: x and ``others`` (same shape) in x's dtype,
    the f32 parameters, all contiguous on the current CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if any(t.dtype != x.dtype or t.shape != x.shape for t in others):
        raise TypeError(f"{name}: gradient must have x's shape and dtype")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError(f"{name}: gamma and beta must be float32")
    tensors = (x, *others, *params)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {x.device} is not the current device")


def group_norm_mish(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = 8) -> torch.Tensor:
    """x: (N, H, W, C) bf16/f32; gamma, beta: (C,) f32 -> x's shape and dtype."""
    _check("group_norm_mish", x, gamma, beta, groups)
    if x.device.type == "cpu":
        return group_norm_mish_plain(x, gamma, beta, groups)
    _check_cuda("group_norm_mish", x, params=(gamma, beta))
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _kernels("igm_group_norm_mish", 4)[x.dtype](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        n, h * w, c, groups, EPS, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_mish kernel launch failed: CUDA error {err}")
    group_norm_mish.launches += 1
    return out


group_norm_mish.launches = 0


def group_norm_mish_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        g: torch.Tensor, groups: int = 8):
    """Backward of :func:`group_norm_mish` for the output gradient ``g`` (x's
    shape and dtype, contiguous) -> (dx, dgamma f32, dbeta f32).

    On the card it launches the backward kernel and the fixed-order batch
    sum of its per-sample partials, counted as one launch."""
    _check("group_norm_mish_bwd", x, gamma, beta, groups)
    if x.device.type == "cpu":
        return group_norm_mish_bwd_plain(x, gamma, beta, g, groups)
    _check_cuda("group_norm_mish_bwd", x, g, params=(gamma, beta))
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return (dx, torch.zeros(c, dtype=torch.float32, device=x.device),
                torch.zeros(c, dtype=torch.float32, device=x.device))
    # the kernels write every entry: no fill launches
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    parts = torch.empty(2, n, c, dtype=torch.float32, device=x.device)
    err = _kernels("igm_group_norm_mish_bwd", 9)[x.dtype](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
        dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), n, h * w, c, groups, EPS,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_mish_bwd kernel launch failed: CUDA error {err}")
    group_norm_mish_bwd.launches += 1
    return dx, dgamma, dbeta


group_norm_mish_bwd.launches = 0


class GroupNormMishFn(torch.autograd.Function):
    """GroupNorm+Mish with its hand-written backward, the counterpart of the
    ``jax.custom_vjp`` around the Pallas kernels.  ``apply(x, gamma, beta,
    groups)``; saves the inputs, not the output."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups):
        ctx.groups = groups
        ctx.save_for_backward(x, gamma, beta)
        return group_norm_mish(x, gamma, beta, groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        # autograd may hand over a strided or differently typed gradient
        g = g.to(x.dtype).contiguous()
        dx, dgamma, dbeta = group_norm_mish_bwd(x, gamma, beta, g, ctx.groups)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None
