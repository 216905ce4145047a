"""GPipe pipeline parallelism over a ``stage`` mesh axis: counterpart of
``igm_tpu/parallel/pipeline.py`` (``STAGE_AXIS``, ``make_pipeline_mesh``,
``gpipe_apply``, ``pipeline_state_sharding``; its ``shard_pipeline_state``
is ``parallel.shard_state`` on the pipeline mesh).

The DiT's block stack is split into S contiguous stages laid out along
the ``stage`` axis of a ``(data, stage)`` mesh, one process a stage:
stage ``s`` holds blocks ``[s*D/S, (s+1)*D/S)`` and, in a model's train
state, only their parameters, Adam moments and EMA shadow
(``parallel/sharding.py`` keeps an empty tensor in place of another
stage's leaf).  The ranks of a stage group hold the same rows (their data
rank's) and compute everything outside the blocks, replicated, as
``igm_tpu``'s single SPMD program does.

:func:`gpipe_apply` runs the blocks GPipe's way.  The local batch is cut
into M microbatches; stage 0 runs its blocks on each in turn and sends
the result to stage 1 (``isend``, so that it goes on to the next
microbatch meanwhile), stage s receives from s-1, runs its blocks and
sends to s+1, and the last stage keeps the outputs, which it then
broadcasts to its stage group.  The result equals the sequential stack:
the schedule changes the order of work, not the math.

Where ``igm_tpu`` lets ``jax.grad`` transpose the schedule, here the whole
schedule is one autograd function (``_GPipe``) whose backward drives the
backward pass itself, one microbatch at a time in a fixed order that both
neighbours of every hop share (the last microbatch first): the last stage
takes the output's gradient, every stage runs its blocks' backward on the
microbatch's saved graph (``torch.autograd.grad``) and sends the gradient
of its input back to the stage before.  A single ``loss.backward()`` over
hops that were themselves autograd nodes would leave the order of the
backward hops to each rank's autograd engine, and blocking point-to-point
calls in two orders deadlock.

Gradients of the replicated leaves: each stage returns the gradient of
``c`` through its own blocks' modulation, stage 0 alone that of the
tokens (``patch_embed``), and the last stage alone runs the head's
backward (the DiT detaches the head's parameters and ``c`` on the other
stages, which compute the same loss for their metrics).  So their sum over
the stage group is one process's gradient, which the optimizer takes
(``core/optim.py``: a replicated leaf's gradient is summed over ``stage``
and averaged over ``data``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, STAGE_AXIS, Mesh, _gloo_cuda, _one_device, broadcast, build_mesh

__all__ = ["STAGE_AXIS", "make_pipeline_mesh", "gpipe_apply", "pipeline_state_sharding"]


def make_pipeline_mesh(stage: int, data: int = 1, devices=None) -> Mesh:
    """This rank's ``(data, stage)`` mesh: the batch splits over ``data``,
    the block stack over ``stage``, the inner axis (a stage group's ranks
    are neighbours).  ``igm_tpu``'s error where there are too few ranks
    (devices, there); every rank of the process group is on the mesh."""
    device = _one_device(devices)
    stage, data = int(stage), int(data)
    size = dist.get_world_size() if dist.is_initialized() else 1
    if data * stage > size:
        raise ValueError(f"mesh ({data},{stage}) needs {data * stage} devices, have {size}")
    if data * stage < size:
        raise ValueError(f"mesh ({data},{stage}) takes {data * stage} ranks, but the launch "
                         f"made {size}: launch them with trainer.devices={data * stage}")
    if not dist.is_initialized():
        return Mesh(1, 0, device, mode="pipeline")
    return build_mesh([(DATA_AXIS, data), (STAGE_AXIS, stage)], device, "pipeline")


# ------------------------------------------------------------------ hops
def _peer(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


def _send(x: torch.Tensor, group, to: int):
    """Start sending ``x`` to stage ``to``: (the work, what it reads)."""
    x = x.detach().contiguous()
    if _gloo_cuda(x, group):          # gloo's point-to-point calls read host memory
        x = x.cpu()
    return dist.isend(x, dst=_peer(group, to), group=group), x


def _recv(like: torch.Tensor, group, frm: int) -> torch.Tensor:
    """A tensor shaped as ``like`` received from stage ``frm``."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _gloo_cuda(like, group) else like.device)
    dist.irecv(buf, src=_peer(group, frm), group=group).wait()
    return buf.to(like.device)


def _wait(sends) -> None:
    for work, _ in sends:
        work.wait()


class _Schedule:
    """One call's plan: this rank's stage ``s`` of ``S``, its group, its
    blocks as ``stage_fn(x, c) -> x``, the M microbatches' rows."""

    def __init__(self, stage_fn, mesh: Mesh, n_micro: int, rows: int):
        self.stage_fn = stage_fn
        self.S, self.s = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS)
        self.group = mesh.group_of(STAGE_AXIS) if mesh.grouped else None
        self.M = n_micro
        self.mb = rows // n_micro

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def forward(self, tok: torch.Tensor, c: torch.Tensor, grad: bool):
        """The forward schedule -> (the output, on every rank of the stage
        group; each microbatch's (input, c, output) when ``grad``, their
        graphs built)."""
        saved, outs, sends = [], [], []
        for m in range(self.M):
            rows = slice(m * self.mb, (m + 1) * self.mb)
            x = tok[rows] if self.first else _recv(tok[rows], self.group, self.s - 1)
            cc = c[rows]
            if grad:
                x, cc = x.detach().requires_grad_(), cc.detach().requires_grad_()
                with torch.enable_grad():
                    y = self.stage_fn(x, cc)
                saved.append((x, cc, y))
            else:
                y = self.stage_fn(x, cc)
            if self.last:
                outs.append(y.detach())
            else:
                sends.append(_send(y, self.group, self.s + 1))
        _wait(sends)
        if self.last:
            out = torch.cat(outs)
        else:
            out = torch.empty(tok.shape, dtype=tok.dtype, device=tok.device)
        if self.S > 1:
            broadcast(out, self.group, self.S - 1)
        return out, saved

    def backward(self, saved, grad_out: torch.Tensor, params: List[torch.Tensor]):
        """The backward schedule, the last microbatch first -> the
        gradients of the tokens (stage 0; None elsewhere), of ``c`` (through
        this stage's blocks) and of ``params``."""
        g_params: List[Optional[torch.Tensor]] = [None] * len(params)
        g_tok: List[torch.Tensor] = [None] * self.M     # type: ignore[list-item]
        g_c: List[torch.Tensor] = [None] * self.M       # type: ignore[list-item]
        sends = []
        for m in reversed(range(self.M)):
            x, cc, y = saved[m]
            if self.last:
                g = grad_out[m * self.mb:(m + 1) * self.mb]
            else:
                g = _recv(y, self.group, self.s + 1)
            inputs = [x, cc, *params]
            grads = torch.autograd.grad(y, inputs, g.to(y.dtype), allow_unused=True)
            saved[m] = None                  # this microbatch's graph is freed
            gx = torch.zeros_like(x) if grads[0] is None else grads[0]
            gc = grads[1]
            if self.first:
                g_tok[m] = gx
            else:
                sends.append(_send(gx, self.group, self.s - 1))
            g_c[m] = torch.zeros_like(cc) if gc is None else gc
            for i, gp in enumerate(grads[2:]):
                if gp is not None:
                    g_params[i] = gp if g_params[i] is None else g_params[i] + gp
        _wait(sends)
        return (torch.cat(g_tok) if self.first else None), torch.cat(g_c), g_params


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node over (tokens, c, this stage's
    parameters); its backward is the backward schedule."""

    @staticmethod
    def forward(ctx, plan: _Schedule, tok, c, *params):
        out, saved = plan.forward(tok, c, grad=True)
        ctx.plan, ctx.saved, ctx.params = plan, saved, params
        return out

    @staticmethod
    def backward(ctx, grad_out):
        plan = ctx.plan
        g_tok, g_c, g_params = plan.backward(ctx.saved, grad_out, list(ctx.params))
        ctx.saved = None
        return (None, g_tok, g_c, *g_params)


def gpipe_apply(block_apply: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
                blocks: Sequence[Any], tok: torch.Tensor, c: torch.Tensor, mesh: Mesh,
                n_micro: int = 1) -> torch.Tensor:
    """Run the ``depth`` blocks over ``tok`` through the S-stage pipeline
    of ``mesh``: ``block_apply(block, x, c) -> x`` one block; ``blocks``
    every block in order (``nn.Module``s; this rank runs its stage's);
    ``tok`` ``[B, n, d]`` and ``c`` ``[B, ...]`` this rank's rows (its data
    rank's).  The global batch ``B * data`` must divide by ``data *
    n_micro`` (``igm_tpu``'s errors).

    Semantics are exactly ``for each block: tok = block(tok, c)``, on every
    rank of the stage group."""
    S = mesh.size(STAGE_AXIS)
    depth = len(blocks)
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    n_data = mesh.size(DATA_AXIS)
    B, M = int(tok.shape[0]), int(n_micro)
    if M < 1 or B % M:
        raise ValueError(f"batch {B * n_data} not divisible by data axis {n_data} "
                         f"x {M} microbatches")
    per = depth // S
    s = mesh.coord(STAGE_AXIS)
    mine = list(blocks[s * per:(s + 1) * per])

    def stage_fn(x, cc):
        for block in mine:
            x = block_apply(block, x, cc)
        return x

    plan = _Schedule(stage_fn, mesh, M, B)
    params = [p for b in mine for p in b.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (tok.requires_grad or c.requires_grad or params):
        return _GPipe.apply(plan, tok, c, *params)
    return plan.forward(tok, c, grad=False)[0]


# ------------------------------------------------------------- the state
def block_stage(index: int, depth: int, stages: int) -> Optional[int]:
    """The stage that holds block ``index`` of ``depth`` (None where the
    stages do not divide the depth: ``gpipe_apply`` then raises)."""
    if stages < 1 or depth % stages:
        return None
    return index // (depth // stages)


def pipeline_state_sharding(model, mesh: Mesh) -> dict:
    """``igm_tpu``'s ``pipeline_state_sharding`` on the port's layout:
    every leaf of ``model.modules`` by ``state_dict`` key, ``(STAGE_AXIS,)``
    for one under a pipelined block (its parameters, and so its Adam
    moments and EMA shadow, live on its stage alone), ``()`` (replicated)
    for every other."""
    from .sharding import module_leaves
    return {leaf.key: ((STAGE_AXIS,) if leaf.staged else ())
            for leaf in module_leaves(model.modules, mesh)}

