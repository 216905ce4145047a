"""Linear attention in the head-folded layout: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``igm_tpu/ops/attention.py`` ``linear_attention_flat`` (the
path the UNet's default ``wslice`` qkv mode calls) and of the Pallas kernel
``igm_tpu/ops/pallas_attention.py`` ``linear_attention_pallas``: q, k, v are
(B, N, H*D); per (batch, head) the keys are softmax-normalised over the N
positions, a (D x D) context ``k_sm^T v`` is accumulated in f32 and rounded
to the input dtype, and the unscaled queries read it out.  Head h is the
channel slice ``[h*D, (h+1)*D)``, so this is the block-diagonal flat form
exactly.  The kernel is ``igm_tpu_torch/csrc/linear_attention.cu``.

:func:`linear_attention_flat` launches the kernel for CUDA tensors and
raises if it cannot; CPU tensors take :func:`linear_attention_flat_plain`.
Its ``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIM = 32


def linear_attention_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math), any device."""
    b, n, c = q.shape
    d = c // heads
    qf, kf, vf = (t.float().reshape(b, n, heads, d) for t in (q, k, v))
    k_sm = torch.softmax(kf, dim=1)
    ctx = torch.einsum("bnhd,bnhe->bhde", k_sm, vf).to(q.dtype).float()
    out = torch.einsum("bnhd,bhde->bnhe", qf, ctx)
    return out.reshape(b, n, c).to(q.dtype)


@functools.cache
def _kernels() -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("linear_attention")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"igm_linear_attention_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def linear_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """q, k, v: (B, N, H*D) channel-flat -> (B, N, H*D)."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, N, H*D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] % heads != 0:
        raise ValueError(f"channels {q.shape[-1]} not divisible by heads {heads}")
    if q.device.type == "cpu":
        return linear_attention_flat_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"linear_attention_flat: unsupported device {q.device}")
    b, n, c = q.shape
    if c != heads * HEAD_DIM:
        raise ValueError(f"linear_attention_flat: the kernel takes head dim "
                         f"{HEAD_DIM}, got {c // heads}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"linear_attention_flat: unsupported dtypes "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("linear_attention_flat: inputs must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("linear_attention_flat: inputs on different devices")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"linear_attention_flat: {q.device} is not the current device")
    if b > 65535:
        raise ValueError(f"linear_attention_flat: batch {b} exceeds 65535")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _kernels()[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, heads,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_attention kernel launch failed: CUDA error {err}")
    linear_attention_flat.launches += 1
    return out


linear_attention_flat.launches = 0
