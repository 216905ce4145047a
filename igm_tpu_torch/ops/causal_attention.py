"""Causal self-attention functions for the TAR transformer.

Counterpart of ``igm_tpu/ops/causal_attention.py``: q, k, v are
(B, S, H, D) (the Flax layout) at every function here.

- :func:`dot_product_attention_weights` and :func:`dot_product_attention`:
  Flax 0.12's functions of the same names, as ``nn.MultiHeadDotProductAttention``
  calls them: the query divided by sqrt(D) in the compute dtype, masked
  logits set to that dtype's lowest value, the softmax, and dropout with a
  keep mask given by the caller (Flax broadcasts it over batch and heads).
- :func:`dropout_flash_attention`: the counterpart of
  ``dropout_flash_attention_fn`` (``:117-137``): the hand-written CUDA
  kernels of ``ops/dropout_attention.py`` with one uint32 seed per call; at
  rate 0 (eval) the same kernel is exact causal attention.
- :func:`hash_dropout_attention`: the counterpart of
  ``hash_dropout_attention_fn`` (``:140-190``): Flax's probabilities with the
  same counter hash as the kernel applied as an elementwise factor,
  ``probs / keep`` in the probabilities' dtype where kept.  Torch ops, not a
  kernel (it is XLA in ``igm_tpu``).
- :func:`flash_causal_attention`: exact causal attention without dropout for
  the ``true``/``eval`` modes.  ``torch.nn.functional.scaled_dot_product_attention``
  stands in for JAX's stock Pallas flash kernel there, which is not one of
  this repo's kernels.
- :func:`flash_full_attention`: the bidirectional counterpart for the DiT's
  ``attn=flash`` (``:67-89``), SDPA again, with ``igm_tpu``'s refusal of a
  sequence not divisible by the kernel's 128-row block kept as it is (a
  mirrored rule: SDPA itself takes any length).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .dropout_attention import Seed, bh_chunks, flash_causal_attention_dropout, keep_mask


def dot_product_attention_weights(query: torch.Tensor, key: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None,
                                  keep: Optional[torch.Tensor] = None,
                                  rate: float = 0.0,
                                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, H, Sq, Sk) attention weights as Flax computes them.  ``mask``
    (broadcastable, True = attend) and ``keep`` (a bool mask broadcastable to
    the weights, True = kept, applied as ``keep / (1 - rate)`` in the
    compute dtype) are optional."""
    dtype = dtype or torch.promote_types(query.dtype, key.dtype)
    query, key = query.to(dtype), key.to(dtype)
    depth = query.shape[-1]
    query = query / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(dtype)
    weights = torch.einsum("bqhd,bkhd->bhqk", query, key)
    if mask is not None:
        weights = weights.masked_fill(~mask, torch.finfo(dtype).min)
    weights = torch.softmax(weights, dim=-1).to(dtype)
    if keep is not None and rate > 0.0:
        keep_prob = 1.0 - rate
        weights = weights * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype))
    return weights


def dot_product_attention(query, key, value, mask=None, keep=None, rate: float = 0.0,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, Sq, H, D) output of Flax's ``dot_product_attention``."""
    dtype = dtype or torch.promote_types(query.dtype, key.dtype)
    weights = dot_product_attention_weights(query, key, mask, keep, rate, dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, value.to(dtype))


def causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def dropout_flash_attention(query, key, value, seed: Seed = 0, rate: float = 0.0,
                            deterministic: bool = True) -> torch.Tensor:
    """Causal attention with in-kernel probs dropout.  ``seed`` is one
    uint32 value (an int or an int64 device tensor) per call; deterministic
    runs the same kernel at rate 0."""
    rate = 0.0 if deterministic else float(rate)
    return flash_causal_attention_dropout(query, key, value, seed if rate > 0.0 else 0,
                                          rate)


def hash_keep_mask(seed: Seed, b: int, h: int, s: int, rate: float,
                   device) -> torch.Tensor:
    """(B, H, S, S) bool: the hash keeps (q, k) of head (b, h) where
    ``hash_bits(seed + b*H + h, q, k) >= threshold(rate)``, built in b*h
    chunks to bound the int64 temporaries."""
    keep = torch.empty(b * h, s, s, dtype=torch.bool, device=device)
    for c0, n in bh_chunks(b * h, s):
        keep[c0:c0 + n] = keep_mask(seed, c0, n, s, s, rate, device)
    return keep.reshape(b, h, s, s)


def hash_dropout_attention(query, key, value, mask=None, seed: Seed = 0,
                           rate: float = 0.0, deterministic: bool = True,
                           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flax's attention weights (dropout off), then the hash factor
    ``where(kept, probs / keep, 0)`` in the probabilities' dtype, then
    ``einsum(probs, value)``."""
    dtype = dtype or torch.promote_types(query.dtype, key.dtype)
    probs = dot_product_attention_weights(query, key, mask, dtype=dtype)
    if not deterministic and rate > 0.0:
        b, s, h, _ = query.shape
        keep = hash_keep_mask(seed, b, h, s, rate, query.device)
        probs = torch.where(keep, probs / torch.tensor(1.0 - rate, dtype=probs.dtype),
                            torch.zeros((), dtype=probs.dtype, device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, value.to(dtype))


FLASH_BLOCK = 128


def flash_full_attention(query, key, value,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact bidirectional attention, (B, S, H, D) -> same, through
    ``F.scaled_dot_product_attention``; S must be a multiple of 128, as
    ``igm_tpu`` requires."""
    s = query.shape[1]
    if s % FLASH_BLOCK:
        raise ValueError(f"flash_full_attention needs seq % {FLASH_BLOCK} == 0, got {s} "
                         "(padded keys would receive softmax mass)")
    q, k, v = (x.transpose(1, 2) for x in (query, key, value))
    out = F.scaled_dot_product_attention(q, k, v, scale=sm_scale)
    return out.transpose(1, 2)


def flash_causal_attention(query, key, value,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact causal attention, (B, S, H, D) -> same, through
    ``F.scaled_dot_product_attention`` (no dropout)."""
    q, k, v = (x.transpose(1, 2) for x in (query, key, value))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=sm_scale)
    return out.transpose(1, 2)
