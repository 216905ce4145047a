"""Multi-head attention: the counterpart of Flax 0.12's
``nn.MultiHeadDotProductAttention`` as ``igm_tpu/models/tar.py:66-94`` builds
it (``qkv_features = d_model``, self-attention, bias on every projection).

Parameters carry Flax's names: ``query``, ``key`` and ``value`` are
DenseGeneral (d -> (H, D)) projections, stored as (H*D, d) weights and (H*D,)
biases; ``out`` is DenseGeneral ((H, D) -> d), stored as a (d, H*D) weight
(``igm_tpu_torch.interop`` converts Flax's rank-3 kernels).  Their init is
Flax's: LeCun-normal kernels (truncated normal, fan-in), zero biases.

The attention function follows the layer's ``flash`` mode, as ``igm_tpu``'s
TransformerEncoderLayer picks its ``attention_fn``:

- ``off``: Flax's own attention under the causal mask, with probs dropout
  whose keep mask is broadcast over batch and heads (Flax's default
  ``broadcast_dropout``), drawn from the caller's generator;
- ``hashdrop``: Flax's probabilities with the counter-hash dropout
  (``ops/causal_attention.py`` ``hash_dropout_attention``);
- ``dropout``: the hand-written CUDA kernels with in-kernel dropout
  (``ops/dropout_attention.py``); eval runs them at rate 0;
- ``always``: exact causal attention without probs dropout (SDPA);
  ``eval``: that where dropout is inactive, else ``off``.

``dropout`` and ``hashdrop`` take one uint32 seed per call: given by the
caller, or drawn from its generator on the device.

Decode mode (``init_cache``, then ``forward(x, decode=True)`` one token at a
time) keeps a KV cache, as Flax's ``decode=True``: ``cached_key``,
``cached_value`` (N, S_max, H, D) in the compute dtype and ``cache_index``;
the token at ``cache_index`` attends over the cache up to itself.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.causal_attention import (causal_mask, dot_product_attention,
                                    dropout_flash_attention, flash_causal_attention,
                                    hash_dropout_attention)
from .base import Dense

MODES = ("off", "hashdrop", "dropout", "always", "eval")


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class _Projection(Dense):
    """A DenseGeneral projection with Flax's default init."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One uint32 seed as an int64 scalar on ``device``, from ``generator``."""
    return torch.randint(0, 2 ** 32, (), generator=generator, device=device,
                         dtype=torch.int64)


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, features: int, num_heads: int, dropout_rate: float = 0.0,
                 mode: str = "off", dtype: torch.dtype | None = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"attention mode must be one of {MODES}, got {mode!r}")
        if features % num_heads:
            raise ValueError(f"features {features} not divisible by {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, features // num_heads
        self.dropout_rate, self.mode, self.dtype = float(dropout_rate), mode, dtype
        for name in ("query", "key", "value", "out"):
            setattr(self, name, _Projection(features, features, dtype=dtype))
        self.cached_key: Optional[torch.Tensor] = None
        self.cached_value: Optional[torch.Tensor] = None
        self.cache_index = 0
        self.mesh = None

    def bind_mesh(self, mesh) -> None:
        """A data-axis mesh: x then holds this rank's rows of the global
        batch (None: one process)."""
        self.mesh = mesh

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.num_heads, self.head_dim)

    def init_cache(self, n: int, max_length: int, device) -> None:
        dtype = self.dtype or self.key.weight.dtype
        shape = (n, max_length, self.num_heads, self.head_dim)
        self.cached_key = torch.zeros(shape, dtype=dtype, device=device)
        self.cached_value = torch.zeros(shape, dtype=dtype, device=device)
        self.cache_index = 0

    def clear_cache(self) -> None:
        self.cached_key = self.cached_value = None
        self.cache_index = 0

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                seed: Optional[torch.Tensor] = None, decode: bool = False) -> torch.Tensor:
        """x: (N, S, d) -> (N, S, d).  ``seed`` replaces the draw of the
        ``dropout``/``hashdrop`` modes.  On a data-axis mesh (``bind_mesh``) x holds
        this rank's rows of the global batch: the hash's per-(b, h) seed
        ``seed + b*H + h`` takes the global b, by passing the kernels
        ``seed + rank * N * H`` (mod 2**32, as they reduce it)."""
        q, k, v = (self._heads(getattr(self, n)(x)) for n in ("query", "key", "value"))
        dtype = q.dtype
        if decode:
            return self.out(self._decode(q, k, v).flatten(-2))
        active = train and self.dropout_rate > 0.0
        mode = self.mode
        if mode == "eval":
            mode = "off" if active else "always"
        if mode == "always":
            y = flash_causal_attention(q, k, v)
        elif mode in ("dropout", "hashdrop"):
            if active and seed is None:
                seed = draw_seed(generator, x.device)
            if active and self.mesh is not None:
                seed = seed + self.mesh.rank * x.shape[0] * self.num_heads
            fn = dropout_flash_attention if mode == "dropout" else hash_dropout_attention
            kwargs = {} if mode == "dropout" else {"mask": causal_mask(q.shape[1], x.device),
                                                   "dtype": dtype}
            y = fn(q, k, v, seed=seed if active else 0, rate=self.dropout_rate,
                   deterministic=not active, **kwargs)
        else:
            keep = None
            if active:
                s = q.shape[1]
                keep = torch.rand((1, 1, s, s), generator=generator,
                                  device=x.device) < 1.0 - self.dropout_rate
            y = dot_product_attention(q, k, v, causal_mask(q.shape[1], x.device), keep,
                                      self.dropout_rate, dtype)
        return self.out(y.flatten(-2))

    def _decode(self, q, k, v) -> torch.Tensor:
        if self.cached_key is None:
            raise RuntimeError("decode before init_cache")
        if q.shape[1] != 1 or q.shape[0] != self.cached_key.shape[0]:
            raise ValueError(f"decode takes (N, 1) tokens against a cache of "
                             f"{tuple(self.cached_key.shape)}, got {tuple(q.shape)}")
        i = self.cache_index
        self.cached_key[:, i] = k[:, 0]
        self.cached_value[:, i] = v[:, 0]
        self.cache_index = i + 1
        return dot_product_attention(q, self.cached_key[:, :i + 1],
                                     self.cached_value[:, :i + 1], dtype=q.dtype)
