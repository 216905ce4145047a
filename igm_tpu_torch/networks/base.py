"""NHWC building blocks with torch-parity init.

Counterparts of ``igm_tpu/networks/base.py`` ``Conv``, ``ConvTranspose`` and
``Dense``, and of Flax's ``nn.Embed`` and ``nn.LayerNorm`` (TAR's).  Activations are NHWC at every module boundary, as in the JAX
package; inside, a conv runs on ``x.permute(0, 3, 1, 2)``, an NCHW view with
channels-last strides that cuDNN takes without a copy.

``dtype`` is the compute dtype, as Flax's: inputs and parameters are cast
to it and the output comes out in it (bfloat16 on the card, parameters stay
float32).  ``dtype=None`` computes in the promotion of the input's and the
parameters' dtypes, as Flax infers it.

Initialisation reproduces ``igm_tpu``'s (torch's nn.Linear / nn.Conv2d
defaults): kernel and bias ~ U(+-1/sqrt(fan_in)).  ``reset_parameters``
takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


def compute_dtype(x: torch.Tensor, param: torch.Tensor,
                  dtype: torch.dtype | None) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Conv(nn.Module):
    """torch-Conv2d-parity conv on NHWC input: explicit symmetric padding.
    ``weight`` is OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.fan_in = in_features * k * k
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform(self.weight, self.fan_in, generator)
        if self.bias is not None:
            _uniform(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class ConvTranspose(nn.Module):
    """torch-ConvTranspose2d-parity transposed conv on NHWC input:
    out = (in - 1) * stride - 2 * padding + k.  ``weight`` is torch's
    (in, out, k, k) layout; ``igm_tpu_torch.interop`` derives it from the
    Flax kernel.  fan_in is in * k * k, as ``igm_tpu`` counts it."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.fan_in = in_features * k * k
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform(self.weight, self.fan_in, generator)
        if self.bias is not None:
            _uniform(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                               bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class Dense(nn.Module):
    """torch-Linear-parity dense layer; ``weight`` is (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        _uniform(self.weight, fan_in, generator)
        if self.bias is not None:
            _uniform(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """Flax ``nn.Embed`` as TAR builds it: an ``embedding`` table (num, dim)
    drawn from N(0, 1)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return _Rows.apply(idx.long(), self.embedding)


class _Rows(torch.autograd.Function):
    """``table[idx]`` whose table gradient sums each row's share in a fixed
    order, a masked sum a row (TAR's tables have 2 and at most 10 rows):
    ``F.embedding``'s CUDA backward adds in an order that changes from run
    to run, so no two TAR train steps would agree bit for bit."""

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        hit = idx.reshape(-1, 1)
        return None, torch.stack([torch.where(hit == k, g, 0.0).sum(dim=0)
                                  for k in range(ctx.rows)])


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis with ``scale`` and ``bias``:
    statistics and normalisation in float32, the output in ``dtype`` (the
    input's when None)."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, self.epsilon)
        return y.to(self.dtype or x.dtype)
