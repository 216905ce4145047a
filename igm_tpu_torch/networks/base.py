"""NHWC building blocks with torch-parity init.

Counterparts of ``igm_tpu/networks/base.py`` ``Conv``, ``ConvTranspose``,
``Dense``, ``Norm``, ``get_act_function`` and ``BaseNetwork``, and of Flax's
``nn.Embed`` and ``nn.LayerNorm`` (TAR's).  Activations are NHWC at every module boundary, as in the JAX
package; inside, a conv runs on ``x.permute(0, 3, 1, 2)``, an NCHW view with
channels-last strides that cuDNN takes without a copy.

``dtype`` is the compute dtype, as Flax's: inputs and parameters are cast
to it and the output comes out in it (bfloat16 on the card, parameters stay
float32).  ``dtype=None`` computes in the promotion of the input's and the
parameters' dtypes, as Flax infers it.

Initialisation reproduces ``igm_tpu``'s (torch's nn.Linear / nn.Conv2d
defaults): kernel and bias ~ U(+-1/sqrt(fan_in)); ``FlaxDense`` is
``Dense`` with Flax's default init instead (lecun_normal kernel, zero
bias), as the DiT and its MoE build theirs.  ``reset_parameters``
takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum


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


def lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at 2 standard deviations,
    scaled to variance 1/fan_in."""
    with torch.no_grad():
        nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


class FlaxDense(Dense):
    """``Dense`` with Flax's default init: lecun_normal kernel (or zeros,
    ``zero_kernel``), zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype | None = None, zero_kernel: bool = False):
        super().__init__(in_features, features, use_bias, dtype)
        self.zero_kernel = zero_kernel

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.zero_kernel:
            with torch.no_grad():
                self.weight.zero_()
        else:
            lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


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


# ------------------------------------------------------------ the VAE/GAN zoo
def get_act_function(act: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``igm_tpu``'s activation factory (``networks/base.py:41-57``)."""
    acts = {"relu": F.relu, "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
            "identity": lambda x: x, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "elu": F.elu, "mish": lambda x: x * torch.tanh(F.softplus(x))}
    if act not in acts:
        raise NotImplementedError(f"act={act!r}")
    return acts[act]


def _canon_norm(norm_type) -> Optional[str]:
    """The configs write batch / instance / layer / null / False / "None"."""
    if norm_type in (None, "None", "none", False, "null"):
        return None
    return str(norm_type)


def _fast_stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax's ``_compute_stats`` (``use_fast_variance``): the mean and
    E[x^2] - E[x]^2 clipped at 0, in float32 (float64 for a float64 input)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


def _global_stats(x: torch.Tensor, dims, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_fast_stats` over the global batch of a data-axis mesh: the
    sums of x and x^2 over this rank's rows, summed over the ranks (one
    differentiable all-reduce), over the global count."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    count = x.numel() // x.shape[-1] * mesh.world
    sums = all_reduce_sum(mesh, torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]))
    mean, mean_sq = sums[0] / count, sums[1] / count
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def _normalize(x, mean, var, eps: float, scale=None, bias=None) -> torch.Tensor:
    """Flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = (x - mean) * mul
    return y if bias is None else y + bias


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis,
    not ``nn.BatchNorm2d``: in train mode it normalises with the batch's
    statistics over every axis but the channel axis (the variance the biased
    E[x^2] - E[x]^2, clipped at 0) and moves the ``mean`` and ``var`` buffers
    (Flax's ``batch_stats``) to ``0.9 * old + 0.1 * batch``, the biased
    variance where torch would take the unbiased one; in eval mode it reads
    the buffers.  ``update_stats = False`` keeps the train-mode output and
    leaves the buffers as they are.  Bound to a data-axis mesh
    (``bind_mesh``), train mode takes the global batch's statistics: the
    mean and E[x^2] summed over the ranks before the normalisation and the
    running-average update."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.update_stats = True
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.mesh = None

    def bind_mesh(self, mesh, blocks: int = 1) -> None:
        self.mesh = mesh

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not train:
            return _normalize(x, self.mean, self.var, self.epsilon, self.scale, self.bias)
        dims = tuple(range(x.ndim - 1))
        mean, var = (_fast_stats(x, dims) if self.mesh is None
                     else _global_stats(x, dims, self.mesh))
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        return _normalize(x, mean, var, self.epsilon, self.scale, self.bias)


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm(num_groups=1, epsilon=1e-5)``: per sample, the
    statistics over every non-batch axis ((C,) or (H, W, C)), a per-channel
    ``scale`` and ``bias``.  Not ``nn.LayerNorm`` over the last axis."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mean, var = _fast_stats(x, tuple(range(1, x.ndim)))
        return _normalize(x, mean.reshape(shape), var.reshape(shape), self.epsilon,
                          self.scale, self.bias)


class Norm(nn.Module):
    """``igm_tpu``'s config-selected normalisation over the channel axis
    (``networks/base.py:67-96``): ``batch`` (:class:`BatchNorm`, held as
    ``BatchNorm_0``), ``layer`` (:class:`GroupNorm` with one group, held as
    ``GroupNorm_0``), ``instance`` (per sample and channel over the spatial
    axes, no affine) or None (the identity).  The submodule names are
    Flax's, so ``interop`` maps a path onto the ``state_dict``."""

    def __init__(self, norm_type, features: int):
        super().__init__()
        self.norm_type = _canon_norm(norm_type)
        if self.norm_type == "batch":
            self.BatchNorm_0 = BatchNorm(features)
        elif self.norm_type == "layer":
            self.GroupNorm_0 = GroupNorm(features)
        elif self.norm_type not in (None, "instance"):
            raise NotImplementedError(f"norm_type={self.norm_type!r}")

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.norm_type is None:
            return x
        if self.norm_type == "batch":
            return self.BatchNorm_0(x, train)
        if self.norm_type == "layer":
            return self.GroupNorm_0(x, train)
        if x.ndim < 3:
            raise ValueError("instance norm needs spatial dims (NHWC)")
        axes = tuple(range(1, x.ndim - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


@contextlib.contextmanager
def frozen_stats(module: nn.Module) -> Iterator[None]:
    """Within: ``module``'s BatchNorms normalise as their mode says but move
    no running statistic (``igm_tpu`` applies a module and drops the
    ``batch_stats`` it returns: FactorVAE's critic)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(norms, saved):
            m.update_stats = s


class BaseNetwork(nn.Module):
    """The zoo's networks: ``input_channel`` and ``output_channel`` are
    given by the model, as ``igm_tpu``'s models inject them
    (``networks/base.py:170-179``)."""

    def __init__(self, input_channel: int, output_channel: int):
        super().__init__()
        self.input_channel, self.output_channel = int(input_channel), int(output_channel)
