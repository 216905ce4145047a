"""NHWC building blocks with torch-parity init.

Counterparts of ``igm_tpu/networks/base.py`` ``Conv``, ``ConvTranspose`` and
``Dense``.  Activations are NHWC at every module boundary, as in the JAX
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
