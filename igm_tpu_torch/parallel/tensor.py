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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, Mesh, all_gather_into, reduce_scatter


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
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
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
