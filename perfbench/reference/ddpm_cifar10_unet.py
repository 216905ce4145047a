"""Plain reference of ``ddpm_cifar10_unet``: the DDPM conv UNet denoiser
(Ho et al. 2020, arXiv:2006.11239, in the widely used form of
github.com/lucidrains/denoising-diffusion-pytorch) at the configuration's
sizes, NHWC, in float32 and plain ``torch`` operations.

Per resolution two ResnetBlocks (conv3x3 -> GroupNorm(8) -> Mish, the
time embedding's Mish and Dense added between the two), a residual
pre-normed linear attention (4 heads of 32; the keys' softmax over the
positions, the context ``softmax(k)^T v``, the output ``q . context``; the
norm divides by the standard deviation plus 1e-5), then a strided conv
down; the middle block, attention, block; the way up concatenates the
skip of the level below and ends in a transposed conv; a final block and
a 1x1 conv.  The first level's skip is not used.  Parameter names are the
Flax auto-names the configuration's checkpoints use.

``q`` rounds the operands of every product (convolutions, dense layers,
the attention's two products) to the precision under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

GROUPS = 8
HEADS, DIM_HEAD = 4, 32


def _levels(cfg: dict) -> Tuple[List[int], List[Tuple[int, int]]]:
    dims = [cfg["channels"]] + [cfg["hidden_dim"] * m for m in cfg["dim_mults"]]
    return dims, list(zip(dims[:-1], dims[1:]))


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape, in the network's order."""
    dim, ch = cfg["hidden_dim"], cfg["channels"]
    dims, in_out = _levels(cfg)
    shapes: Dict[str, tuple] = {}
    count: Dict[str, int] = {}

    def name(kind):
        i = count.get(kind, 0)
        count[kind] = i + 1
        return f"{kind}_{i}"

    def dense(prefix, i, o, bias=True):
        shapes[f"{prefix}.weight"] = (o, i)
        if bias:
            shapes[f"{prefix}.bias"] = (o,)

    def conv(prefix, i, o, k, bias=True):
        shapes[f"{prefix}.weight"] = (o, i, k, k)
        if bias:
            shapes[f"{prefix}.bias"] = (o,)

    def block(prefix, i, o):
        conv(f"{prefix}.Conv_0", i, o, 3)
        shapes[f"{prefix}.GroupNormMish_0.scale"] = (o,)
        shapes[f"{prefix}.GroupNormMish_0.bias"] = (o,)

    def rb(i, o):
        p = name("ResnetBlock")
        block(f"{p}.Block_0", i, o)
        dense(f"{p}.Dense_0", dim, o)
        block(f"{p}.Block_1", o, o)
        if i != o:
            conv(f"{p}.Conv_0", i, o, 1)

    def attn(d):
        p = name("AttnBlock")
        shapes[f"{p}.LinearAttention_0.Conv_0.weight"] = (3 * HEADS * DIM_HEAD, d, 1, 1)
        conv(f"{p}.LinearAttention_0.Conv_1", HEADS * DIM_HEAD, d, 1)
        shapes[f"{p}.ChannelLayerNorm_0.g"] = (d,)
        shapes[f"{p}.ChannelLayerNorm_0.b"] = (d,)

    dense(name("Dense"), dim, dim * 4)
    dense(name("Dense"), dim * 4, dim)
    d_in = ch
    for ind, (_, d_out) in enumerate(in_out):
        rb(d_in, d_out)
        rb(d_out, d_out)
        attn(d_out)
        if ind < len(in_out) - 1:
            conv(name("Conv"), d_out, d_out, 3)
        d_in = d_out
    mid = dims[-1]
    rb(mid, mid)
    attn(mid)
    rb(mid, mid)
    for d_in, d_out in reversed(in_out[1:]):
        rb(d_out * 2, d_in)
        rb(d_in, d_in)
        attn(d_in)
        p = name("ConvTranspose")
        shapes[f"{p}.weight"] = (d_in, d_in, 4, 4)
        shapes[f"{p}.bias"] = (d_in,)
    block(name("Block"), dims[1], dims[1])
    conv(name("Conv"), dims[1], ch, 1)
    return shapes


def _conv(p, name, x, q, stride=1, pad=0):
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(p[f"{name}.weight"]), p.get(f"{name}.bias"),
                 stride, pad)
    return y.permute(0, 2, 3, 1)


def _conv_t(p, name, x, q):
    y = F.conv_transpose2d(q(x.permute(0, 3, 1, 2)), q(p[f"{name}.weight"]),
                           p[f"{name}.bias"], 2, 1)
    return y.permute(0, 2, 3, 1)


def _dense(p, name, x, q):
    return F.linear(q(x), q(p[f"{name}.weight"]), p.get(f"{name}.bias"))


def _block(p, name, x, q):
    y = _conv(p, f"{name}.Conv_0", x, q, 1, 1)
    y = F.group_norm(y.permute(0, 3, 1, 2), GROUPS, p[f"{name}.GroupNormMish_0.scale"],
                     p[f"{name}.GroupNormMish_0.bias"], 1e-5)
    return F.mish(y).permute(0, 2, 3, 1)


def _resnet(p, name, x, t, q):
    h = _block(p, f"{name}.Block_0", x, q)
    h = h + _dense(p, f"{name}.Dense_0", F.mish(t), q)[:, None, None, :]
    h = _block(p, f"{name}.Block_1", h, q)
    if f"{name}.Conv_0.weight" in p:
        x = _conv(p, f"{name}.Conv_0", x, q)
    return h + x


def _attn(p, name, x, q):
    b, hh, ww, c = x.shape
    mean = x.mean(dim=-1, keepdim=True)
    std = x.var(dim=-1, keepdim=True, unbiased=False).sqrt()
    a = (x - mean) / (std + 1e-5) * p[f"{name}.ChannelLayerNorm_0.g"] \
        + p[f"{name}.ChannelLayerNorm_0.b"]
    hidden = HEADS * DIM_HEAD
    w3 = p[f"{name}.LinearAttention_0.Conv_0.weight"].reshape(3 * hidden, c)
    flat = a.reshape(b, hh * ww, c)
    qh, kh, vh = (F.linear(q(flat), q(w)).reshape(b, hh * ww, HEADS, DIM_HEAD)
                  for w in w3.split(hidden))
    context = torch.einsum("bnhd,bnhe->bhde", q(torch.softmax(kh, dim=1)), q(vh))
    out = torch.einsum("bnhd,bhde->bnhe", q(qh), q(context)).reshape(b, hh, ww, hidden)
    return x + _conv(p, f"{name}.LinearAttention_0.Conv_1", out, q)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """sin | cos of t times exp(-i ln(10000) / (dim/2 - 1))."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def make_forward(cfg: dict):
    """``forward(params, x, t, q)`` -> (eps prediction (B, H, W, C), 0)."""
    dims, in_out = _levels(cfg)
    n_levels = len(in_out)

    def forward(p, x, t, q):
        emb = _dense(p, "Dense_1", F.mish(_dense(p, "Dense_0",
                                                 time_embedding(t, cfg["hidden_dim"]), q)), q)
        rbs = iter(range(10 ** 6))
        attns = iter(range(10 ** 6))
        convs = iter(range(10 ** 6))
        skips = []
        for ind in range(n_levels):
            x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
            x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
            x = _attn(p, f"AttnBlock_{next(attns)}", x, q)
            skips.append(x)
            if ind < n_levels - 1:
                x = _conv(p, f"Conv_{next(convs)}", x, q, 2, 1)
        x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
        x = _attn(p, f"AttnBlock_{next(attns)}", x, q)
        x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
        for up in range(n_levels - 1):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
            x = _resnet(p, f"ResnetBlock_{next(rbs)}", x, emb, q)
            x = _attn(p, f"AttnBlock_{next(attns)}", x, q)
            x = _conv_t(p, f"ConvTranspose_{up}", x, q)
        x = _block(p, "Block_0", x, q)
        return _conv(p, f"Conv_{next(convs)}", x, q), 0.0

    return forward
