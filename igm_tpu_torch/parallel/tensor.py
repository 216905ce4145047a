"""Megatron tensor parallelism on the DiT blocks (``mesh.mode=tensor``):
the collectives ``igm_tpu``'s GSPMD derives from its column and row specs
(``parallel/mesh.py:130-203``), written by hand.

Within a block the residual stream, and its gradient, are the same on
every rank of the model group.  A column-parallel layer (``qkv``, the MLP's
``Dense_0``, the adaLN ``_Modulation_0/Dense_0``) keeps its shard of the
output features; a row-parallel one (``proj``, the MLP's ``Dense_1``) its
shard of the input features, its bias added once after the sum.  Two
autograd functions carry Megatron's rule (Shoeybi et al. 2019):

- :func:`copy_to_model` before a column layer: the identity, its backward
  the all-reduce of the input's partial gradients;
- :func:`reduce_from_model` after a row layer: the all-reduce of the
  partial outputs, its backward the identity.

:func:`gather_features` all-gathers a column layer's output features where
a whole tensor is needed: the adaLN modulation (whose gradient is then the
same on every rank: its backward takes the rank's slice), and ``qkv``
when the model axis does not divide the heads (the head-grouped packing
then splits a head between ranks: every rank computes the attention of all
heads and keeps its features' slice for ``proj``, so the gradient is
partial: its backward is a reduce-scatter).

Sequence parallelism (Megatron-SP, Korthikanti et al. 2022) splits the
tokens between the model group's ranks between the GEMMs: rank r holds
tokens ``[r*k, (r+1)*k)`` of the sequence padded with zero rows to ``m*k``
(``k = ceil(N/m)``; the padding lives in the split storage alone).

- :func:`split_tokens` keeps the rank's part of a tensor every rank holds
  whole; its backward all-gathers the parts' gradients (the whole
  tensor's gradient on every rank);
- :func:`gather_tokens` all-gathers the parts into the N tokens; its
  backward takes the rank's part of the gradient, summed over the ranks
  first (``partial``: a column layer's input, each rank's gradient from
  its features alone: a reduce-scatter);
- :func:`scatter_tokens` sums a row layer's partial outputs over the ranks
  and keeps the rank's tokens (a reduce-scatter, in place of
  :func:`reduce_from_model`'s all-reduce); its backward all-gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, Mesh, all_gather_into, counted, reduce_scatter


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """A DiT block's share of the model axis: ``size`` ranks, this one
    ``rank``, their ``group``; ``whole_heads`` whether each holds whole
    heads of ``qkv``."""
    size: int
    rank: int
    group: Any
    whole_heads: bool

    @classmethod
    def of(cls, mesh: Mesh, heads: int) -> "TensorParallel":
        m = mesh.size(MODEL_AXIS)
        return cls(m, mesh.coord(MODEL_AXIS), mesh.group_of(MODEL_AXIS), heads % m == 0)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        counted(grad)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        counted(out)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel, partial: bool):
        ctx.tp, ctx.partial = tp, partial
        x = x.contiguous()
        out = torch.empty((tp.size * x.numel(),), dtype=x.dtype, device=x.device)
        all_gather_into(out, x.reshape(-1), tp.group)
        parts = out.view(tp.size, *x.shape)
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        chunks = grad.chunk(tp.size, dim=-1)
        if not ctx.partial:
            return chunks[tp.rank].contiguous(), None, None
        flat = torch.stack(chunks).contiguous()
        mine = torch.empty(chunks[0].shape, dtype=grad.dtype, device=grad.device)
        reduce_scatter(mine.view(-1), flat.view(-1), tp.group)
        return mine, None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


def gather_features(x: torch.Tensor, tp: TensorParallel, partial: bool) -> torch.Tensor:
    """The model group's ``x`` concatenated along the last axis in rank
    order; ``partial``: the gradient is summed over the ranks (else each
    already holds the whole)."""
    return _GatherFeatures.apply(x, tp, partial)


# ------------------------------------------------------------- sequence
def _tokens(n: int, size: int) -> int:
    """The tokens a rank holds of ``n`` split over ``size`` ranks."""
    return -(-n // size)


def _pad_tokens(x: torch.Tensor, total: int) -> torch.Tensor:
    if x.shape[1] == total:
        return x
    pad = x.new_zeros((x.shape[0], total - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _all_gather_tokens(x: torch.Tensor, tp: TensorParallel, n: int) -> torch.Tensor:
    """(B, k, ...) parts -> (B, n, ...), the ranks' parts in order, the
    padding dropped."""
    x = x.contiguous()
    out = torch.empty((tp.size * x.numel(),), dtype=x.dtype, device=x.device)
    all_gather_into(out, x.reshape(-1), tp.group)
    parts = out.view(tp.size, *x.shape)
    return torch.cat(parts.unbind(0), dim=1)[:, :n]


def _reduce_scatter_tokens(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """(B, n, ...) partial sums -> the rank's (B, k, ...) of their sum."""
    k = _tokens(x.shape[1], tp.size)
    x = _pad_tokens(x, k * tp.size)
    parts = torch.stack(x.split(k, dim=1)).contiguous()        # (m, B, k, ...)
    mine = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    reduce_scatter(mine.view(-1), parts.view(-1), tp.group)
    return mine


def _my_tokens(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    k = _tokens(x.shape[1], tp.size)
    return _pad_tokens(x, k * tp.size)[:, tp.rank * k:(tp.rank + 1) * k].contiguous()


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel):
        ctx.tp, ctx.n = tp, x.shape[1]
        return _my_tokens(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_tokens(grad, ctx.tp, ctx.n), None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel, n: int, partial: bool):
        ctx.tp, ctx.partial = tp, partial
        return _all_gather_tokens(x, tp, n)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        mine = _reduce_scatter_tokens(grad, tp) if ctx.partial else _my_tokens(grad, tp)
        return mine, None, None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel):
        ctx.tp, ctx.n = tp, x.shape[1]
        return _reduce_scatter_tokens(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_tokens(grad, ctx.tp, ctx.n), None


def split_tokens(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The rank's part of the tokens (axis 1) of ``x``, which every rank of
    the model group holds whole."""
    return _SplitTokens.apply(x, tp)


def gather_tokens(x: torch.Tensor, tp: TensorParallel, n: int,
                  partial: bool) -> torch.Tensor:
    """The ``n`` tokens from the ranks' parts; ``partial``: each rank's
    gradient is its part of the whole (summed in the backward)."""
    return _GatherTokens.apply(x, tp, n, partial)


def scatter_tokens(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The rank's part of the tokens of ``x`` summed over the model group."""
    return _ScatterTokens.apply(x, tp)
