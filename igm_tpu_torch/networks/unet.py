"""DDPM UNet denoiser, NHWC: counterpart of ``igm_tpu/networks/unet.py``.

Per resolution: two ResnetBlocks (time-FiLM add), residual pre-normed linear
attention, then down/up-sampling; middle block-attention-block; the first
skip connection is unused (ups iterate ``in_out[1:]``, as in ``igm_tpu``).

Submodules carry the names Flax gives the same modules (``ResnetBlock_3``,
``Block_0``, ``GroupNormMish_0``, ...), so a Flax param path maps onto the
torch ``state_dict`` key by dropping the wrappers' inner ``<Type>_0`` level
(``igm_tpu_torch.interop``).

Every Block's GroupNorm+Mish goes through ``ops.groupnorm.GroupNormMishFn``
and every AttnBlock's attention through
``ops.linear_attention.LinearAttentionFlatFn``: on the card their forwards
and backwards launch the hand-written CUDA kernels.  The convolutions and
the Dense/qkv/out projections, which XLA computes outside any Pallas kernel
in ``igm_tpu``, stay ``F.conv2d`` / ``F.conv_transpose2d`` / ``F.linear``.

``remat=True`` recomputes each ResnetBlock in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``): its
GroupNorm+Mish forwards then run twice per training step.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.groupnorm import GroupNormMishFn, mish
from ..ops.linear_attention import LinearAttentionFlatFn
from .base import Conv, ConvTranspose, Dense


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Timestep embedding; the frequency step divides by ``half - 1``."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels with an ``(std + eps)`` denominator; statistics
    in f32, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.g.fill_(1.0)
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        std = torch.sqrt(xf.var(dim=-1, keepdim=True, unbiased=False))
        return (((xf - mean) / (std + self.eps)) * self.g + self.b).to(x.dtype)


class LinearAttention(nn.Module):
    """qkv projection + linear attention + 1x1-conv out, in ``igm_tpu``'s
    default ``wslice`` form: the (1, 1, in, 3*hidden) qkv kernel
    (``Conv_0``, never run as a conv) is sliced into three projections, so
    the fused 3*hidden activation never exists."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.hidden = heads * dim_head
        self.Conv_0 = Conv(dim, self.hidden * 3, 1, use_bias=False)
        self.Conv_1 = Conv(self.hidden, dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c_in = x.shape
        hidden = self.hidden
        w3 = self.Conv_0.weight.reshape(3 * hidden, c_in)
        x_flat = x.reshape(b, h * w, c_in)
        if self.dtype is not None:
            w3, x_flat = w3.to(self.dtype), x_flat.to(self.dtype)
        q = F.linear(x_flat, w3[:hidden])
        k = F.linear(x_flat, w3[hidden:2 * hidden])
        v = F.linear(x_flat, w3[2 * hidden:])
        out = LinearAttentionFlatFn.apply(q, k, v, self.heads).reshape(b, h, w, hidden)
        return self.Conv_1(out)


class AttnBlock(nn.Module):
    """Residual(PreNorm(LinearAttention))."""

    def __init__(self, dim: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.LinearAttention_0 = LinearAttention(dim, dtype=dtype)
        self.ChannelLayerNorm_0 = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.LinearAttention_0(self.ChannelLayerNorm_0(x))


class GroupNormMish(nn.Module):
    """GroupNorm(eps=1e-5) + Mish through the fused kernel's wrapper; the
    parameter names match Flax's nn.GroupNorm (``scale``/``bias``)."""

    def __init__(self, dim: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return GroupNormMishFn.apply(x, self.scale, self.bias, self.groups)


class Block(nn.Module):
    """conv3x3 -> GroupNorm(8) -> Mish.  The conv runs in ``dtype``; the
    norm's statistics are f32; the output stays in the conv's dtype."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.Conv_0 = Conv(dim, dim_out, 3, 1, 1, dtype=dtype)
        self.GroupNormMish_0 = GroupNormMish(dim_out, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNormMish_0(self.Conv_0(x))


class ResnetBlock(nn.Module):
    """Two Blocks with the time-embedding add between them."""

    def __init__(self, dim: int, dim_out: int, time_dim: Optional[int],
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.Block_0 = Block(dim, dim_out, dtype=dtype)
        self.Dense_0 = (Dense(time_dim, dim_out, dtype=dtype)
                        if time_dim is not None else None)
        self.Block_1 = Block(dim_out, dim_out, dtype=dtype)
        self.Conv_0 = Conv(dim, dim_out, 1, dtype=dtype) if dim != dim_out else None

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.Block_0(x)
        if self.Dense_0 is not None and t is not None:
            h = h + self.Dense_0(mish(t))[:, None, None, :]
        h = self.Block_1(h)
        if self.Conv_0 is not None:
            x = self.Conv_0(x)
        return h + x


class Embed(nn.Module):
    """Embedding table (``embedding``: (num, dim)), Flax nn.Embed's init:
    N(0, 1/dim)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
                                   generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return F.embedding(y.long(), self.embedding)


class _FlaxNames:
    """Registers submodules under Flax's auto-names: ``<Type>_<i>``, counted
    per type in construction order, which is the order Flax's compact
    ``Unet.__call__`` creates them in."""

    def __init__(self, parent: nn.Module):
        self.parent, self.count = parent, {}

    def __call__(self, kind: str, module: nn.Module) -> nn.Module:
        i = self.count.get(kind, 0)
        self.count[kind] = i + 1
        self.parent.add_module(f"{kind}_{i}", module)
        return module


class Unet(nn.Module):
    """Input/output NHWC; ``time`` is (B,) int/float.

    ``num_classes > 0`` adds class conditioning: an embedding table of
    ``num_classes + 1`` rows added to the time embedding, where row
    ``num_classes`` is the null token for classifier-free guidance.  ``y``
    is then a (B,) int label batch and required.  ``remat`` recomputes each
    ResnetBlock in the backward when gradients are being recorded.
    """

    def __init__(self, dim: int, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), groups: int = 8,
                 channels: int = 3, with_time_emb: bool = True,
                 num_classes: int = 0, dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        name = _FlaxNames(self)
        self.dim, self.num_classes, self.remat = dim, num_classes, remat
        dims = [channels] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.time_mlp = None
        if with_time_emb:
            self.time_mlp = (name("Dense", Dense(dim, dim * 4)),
                             name("Dense", Dense(dim * 4, dim)))
        if num_classes:
            self.class_emb = Embed(num_classes + 1, dim)
        time_dim = dim if (with_time_emb or num_classes) else None

        def rb(d_in: int, d_out: int) -> nn.Module:
            return name("ResnetBlock", ResnetBlock(d_in, d_out, time_dim, dtype))

        self.downs = []
        d_in = channels
        for ind, (_, d_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append((
                rb(d_in, d_out), rb(d_out, d_out),
                name("AttnBlock", AttnBlock(d_out, dtype)),
                None if is_last else name("Conv", Conv(d_out, d_out, 3, 2, 1,
                                                       dtype=dtype))))
            d_in = d_out
        mid = dims[-1]
        self.mid = (rb(mid, mid), name("AttnBlock", AttnBlock(mid, dtype)),
                    rb(mid, mid))
        self.ups = []
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append((
                rb(d_out * 2, d_in), rb(d_in, d_in),
                name("AttnBlock", AttnBlock(d_in, dtype)),
                name("ConvTranspose", ConvTranspose(d_in, d_in, 4, 2, 1,
                                                    dtype=dtype))))
        self.final = (name("Block", Block(dims[1], dims[1], groups, dtype)),
                      name("Conv", Conv(dims[1], out_dim or channels, 1)))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = None
        if self.time_mlp is not None:
            dense0, dense1 = self.time_mlp
            t = dense1(mish(dense0(sinusoidal_pos_emb(time, self.dim))))
        if self.num_classes:
            if y is None:
                raise ValueError("conditional Unet (num_classes>0) needs y")
            cls = self.class_emb(y)
            t = cls if t is None else t + cls

        def rb(block, x):
            if self.remat and torch.is_grad_enabled():
                # no random draws inside a block: nothing to replay
                return checkpoint(block, x, t, use_reentrant=False,
                                  preserve_rng_state=False)
            return block(x, t)

        skips = []
        for rb1, rb2, attn, down in self.downs:
            x = attn(rb(rb2, rb(rb1, x)))
            skips.append(x)
            if down is not None:
                x = down(x)
        rb1, attn, rb2 = self.mid
        x = rb(rb2, attn(rb(rb1, x)))
        for rb1, rb2, attn, up in self.ups:
            x = torch.cat([x, skips.pop()], dim=-1)
            x = up(attn(rb(rb2, rb(rb1, x))))
        block, conv = self.final
        return conv(block(x)).float()
