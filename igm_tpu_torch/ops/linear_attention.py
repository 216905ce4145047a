"""Linear attention in the head-folded layout: the CUDA kernels' wrappers,
their plain versions and the autograd Function that joins them.

Counterpart of ``igm_tpu/ops/attention.py`` ``linear_attention_flat`` (the
path the UNet's default ``wslice`` qkv mode calls), its custom VJP
``_flat_bwd``, and the Pallas kernel ``igm_tpu/ops/pallas_attention.py``
``linear_attention_pallas``: q, k, v are (B, N, H*D); per (batch, head) the
keys are softmax-normalised over the N positions, a (D x D) context
``k_sm^T v`` is accumulated in f32 and rounded to the input dtype, and the
unscaled queries read it out.  Head h is the channel slice
``[h*D, (h+1)*D)``, so this is the block-diagonal flat form exactly.  The
kernels are in ``igm_tpu_torch/csrc/linear_attention.cu``.

In bfloat16 the key softmax rounds where ``jax.nn.softmax`` rounds on a
bf16 array (:func:`key_softmax`); the backward recomputes it in f32 with no
rounding, as ``_flat_bwd`` does, but reads out ``dq`` against the context
as the forward rounded it.

:func:`linear_attention_flat` and :func:`linear_attention_flat_bwd` launch
their kernel for CUDA tensors and raise if they cannot; CPU tensors take the
plain versions.  Each has a ``launches`` attribute that counts kernel
launches.  :class:`LinearAttentionFlatFn` is what the UNet calls.  The bf16
forward runs its products on the tensor cores and stages rows with 16-byte
``cp.async``, up to N = ``BF16_TC_MAX_N``, and as f32 FMAs beyond (any N,
the same roundings); its q, k and v must start on a 16-byte boundary (every
fresh allocation does), else it raises ``ValueError``.  The bf16 backward
does the same on the tensor cores up to N = ``BF16_BWD_TC_MAX_N`` (and as
f32 FMAs beyond, any N), and raises for an unaligned input too.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIM = 32
# the bf16 tensor-core kernel stages a head's rows in shared memory, split
# over a cluster of at most 8 CTAs of at most 1408 rows each; beyond that
# the forward runs as f32 FMAs (csrc/linear_attention.cu mma_plan;
# fwd_on_tensor_cores asks the built kernel)
BF16_TC_MAX_N = 8 * 1408
# the bf16 backward stages four arrays a row: on the tensor cores up to 8
# CTAs of 672 rows, beyond that as f32 FMAs (csrc/linear_attention.cu
# bwd_mma_plan; bwd_on_tensor_cores asks the built kernel)
BF16_BWD_TC_MAX_N = 8 * 672


def key_softmax(k: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 1 of (B, N, H, D) keys, as ``jax.nn.softmax`` gives
    it for k's dtype, returned in f32.  float32: the plain softmax.
    bfloat16: the shifted logits, their exponentials, the column sum (taken
    in f32) and the quotient each rounded to bf16, against the exact column
    max."""
    kf = k.float()
    if k.dtype != torch.bfloat16:
        return torch.softmax(kf, dim=1)

    def rnd(t):
        return t.to(torch.bfloat16).float()

    e = rnd(torch.exp(rnd(kf - kf.amax(dim=1, keepdim=True))))
    return rnd(e / rnd(e.sum(dim=1, keepdim=True)))


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.float().reshape(b, n, heads, c // heads)


def _context(k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """The forward's (B, H, D, D) context in f32, rounded to k's dtype."""
    k4 = k.reshape(*k.shape[:2], heads, -1)
    ctx = torch.einsum("bnhd,bnhe->bhde", key_softmax(k4), _split(v, heads))
    return ctx.to(k.dtype).float()


def linear_attention_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math), any device."""
    out = torch.einsum("bnhd,bhde->bnhe", _split(q, heads), _context(k, v, heads))
    return out.reshape(q.shape).to(q.dtype)


def linear_attention_flat_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, g: torch.Tensor,
                                    heads: int):
    """Plain PyTorch version of the backward kernel, written out as
    ``_flat_bwd`` (attention.py:99-112) computes it per head: g is the
    output's gradient.  Returns (dq, dk, dv) in q's dtype."""
    qf, kf, vf, gf = (_split(t, heads) for t in (q, k, v, g))
    k_sm = torch.softmax(kf, dim=1)
    dq = torch.einsum("bnhe,bhde->bnhd", gf, _context(k, v, heads))
    dctx = torch.einsum("bnhd,bnhe->bhde", qf, gf)
    dv = torch.einsum("bnhd,bhde->bnhe", k_sm, dctx)
    dk_sm = torch.einsum("bhde,bnhe->bnhd", dctx, vf)
    inner = (k_sm * dk_sm).sum(dim=1, keepdim=True)
    dk = k_sm * (dk_sm - inner)
    return tuple(t.reshape(q.shape).to(q.dtype) for t in (dq, dk, dv))


@functools.cache
def _kernels(name: str, pointers: int) -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("linear_attention")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def _on_tensor_cores(symbol: str, n: int) -> bool:
    fn = getattr(_build.library("linear_attention"), symbol)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(n))


def fwd_on_tensor_cores(n: int) -> bool:
    """Whether the built bf16 forward runs on the tensor cores at this N
    (the kernel's own shape rule; builds the library, so the card's machine
    only)."""
    return _on_tensor_cores("igm_linear_attention_bf16_on_tensor_cores", n)


def bwd_on_tensor_cores(n: int) -> bool:
    """The same for the bf16 backward."""
    return _on_tensor_cores("igm_linear_attention_bwd_bf16_on_tensor_cores", n)


def _check(name: str, heads: int, *tensors: torch.Tensor) -> None:
    """Shape checks on every device."""
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: inputs must share one (B, N, H*D) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if shape[-1] % heads != 0:
        raise ValueError(f"channels {shape[-1]} not divisible by heads {heads}")


def _check_cuda(name: str, heads: int, *tensors: torch.Tensor) -> None:
    """What the kernels take: head dim 32, one dtype (f32/bf16), contiguous,
    on the current CUDA device, batch at most 65535; in bf16 (whose kernels
    stage rows with 16-byte ``cp.async``) tensors that start on a 16-byte
    boundary."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, n, c = q.shape
    if c != heads * HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, "
                         f"got {c // heads}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: unsupported dtypes {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {q.device} is not the current device")
    if b > 65535:
        raise ValueError(f"{name}: batch {b} exceeds 65535")
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"{name}: bf16 inputs must start on a 16-byte boundary, got "
                             f"addresses {[t.data_ptr() % 16 for t in tensors]} mod 16")


def linear_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """q, k, v: (B, N, H*D) channel-flat -> (B, N, H*D)."""
    _check("linear_attention_flat", heads, q, k, v)
    if q.device.type == "cpu":
        return linear_attention_flat_plain(q, k, v, heads)
    _check_cuda("linear_attention_flat", heads, q, k, v)
    b, n, _ = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _kernels("igm_linear_attention", 4)[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, heads,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_attention kernel launch failed: CUDA error {err}")
    linear_attention_flat.launches += 1
    return out


linear_attention_flat.launches = 0


def linear_attention_flat_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              g: torch.Tensor, heads: int):
    """Backward of :func:`linear_attention_flat` for the output gradient
    ``g`` (q's shape and dtype, contiguous) -> (dq, dk, dv).

    In bf16 it runs on the tensor cores up to N = ``BF16_BWD_TC_MAX_N`` and
    as f32 FMAs beyond (any N); its inputs must start on a 16-byte
    boundary."""
    _check("linear_attention_flat_bwd", heads, q, k, v, g)
    if q.device.type == "cpu":
        return linear_attention_flat_bwd_plain(q, k, v, g, heads)
    _check_cuda("linear_attention_flat_bwd", heads, q, k, v, g)
    b, n, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    err = _kernels("igm_linear_attention_bwd", 7)[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, n, heads,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_attention_bwd kernel launch failed: CUDA error {err}")
    linear_attention_flat_bwd.launches += 1
    return dq, dk, dv


linear_attention_flat_bwd.launches = 0


class LinearAttentionFlatFn(torch.autograd.Function):
    """Flat linear attention with its hand-written backward, the counterpart
    of ``jax.custom_vjp`` ``linear_attention_flat``.  ``apply(q, k, v,
    heads)``; saves q, k, v and recomputes the rest in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v)
        return linear_attention_flat(q, k, v, heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # autograd may hand over a strided or differently typed gradient
        g = g.to(q.dtype).contiguous()
        return (*linear_attention_flat_bwd(q, k, v, g, ctx.heads), None)
