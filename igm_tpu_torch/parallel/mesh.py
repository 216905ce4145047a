"""The data axis: counterpart of ``igm_tpu/parallel/mesh.py``'s
``make_mesh``, ``shard_batch``, ``replicate``, ``pad_to_multiple`` and
``sample_sharded`` on a one-axis mesh.

``igm_tpu`` shards the batch over the ``data`` axis of a device mesh and
GSPMD makes its data-parallel step the one-device step on the whole global
batch: every random draw is made at the global shape from the replicated
key, batch statistics are taken over the global batch, and one gradient
all-reduce follows.  Here the axis is one process per card over
``torch.distributed`` (NCCL on CUDA; gloo on the CPU, and for several ranks
sharing one card), and the same equality is built by hand:

- a rank holds its rows of each global batch (:meth:`Mesh.local_rows`,
  :func:`shard_batch`): rank r the r-th of ``world`` equal slices, or of
  each of ``blocks`` equal blocks for a step that splits its batch into
  blocks (FactorVAE's two halves);
- a training draw with a batch axis is made at the global batch size from
  the training generator, which has the same seed and so the same state on
  every rank, and the rank keeps its rows (:func:`batch_draw`);
- batch statistics are summed over the ranks by :func:`all_reduce_sum`,
  whose backward is the same all-reduce, so that gradients flow through
  the other ranks' rows as they do through one process's global batch;
- every optimizer update averages its gradients over the ranks, one
  flattened buffer a dtype (:func:`all_reduce_`), before gradient clipping.

With every loss a mean over the batch (the inventory is in
``core/optim.py``), the mean of the ranks' losses is the global batch's
loss, and the mean of their gradients its gradient.

:class:`Mesh` without a process group is one process: nothing is reduced
and every draw is made at the local (= global) batch size, exactly as
before the data axis existed.  A mesh of one NCCL rank runs every
collective (each a copy) and gives the one-process step bit for bit.

The model axes (``model > 1``, ``fsdp > 1``: FSDP and tensor parallelism,
ROADMAP slice 7b) raise ``NotImplementedError``; ``_fsdp_spec``,
``_tp_spec``, ``shard_state``, ``state_shardings`` and
``init_state_sharded`` come with that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
FSDP_AXIS = "fsdp"

MODEL_AXES_REFUSED = ("a model axis (FSDP and tensor parallelism) is ROADMAP Queue 1 "
                      "slice 7b, not ported yet")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the data axis: ``world`` ranks, this one
    ``rank``, computing on ``device``; ``backend`` and ``group`` are the
    process group's (None for one process without a group)."""
    world: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world}

    @property
    def grouped(self) -> bool:
        """Whether the mesh has a process group (collectives run)."""
        return self.group is not None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the mesh's collectives: NCCL's
        can, gloo's run on the host and cannot."""
        return self.backend != "gloo"

    def local_rows(self, n: int, blocks: int = 1) -> np.ndarray:
        """The positions of this rank's rows in a global batch of ``n``:
        the rank's slice of each of ``blocks`` equal blocks, in order."""
        if n % (blocks * self.world):
            raise ValueError(f"a batch of {n} does not split into {blocks} block(s) "
                             f"over {self.world} ranks")
        size = n // blocks
        per = size // self.world
        return np.concatenate([np.arange(b * size + self.rank * per,
                                         b * size + (self.rank + 1) * per)
                               for b in range(blocks)])


def _one_device(devices) -> torch.device:
    from ..utils.platform import resolve_device
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError(f"a rank computes on one device, got {devices}")
        devices = devices[0]
    return resolve_device(devices)


def make_mesh(data: int = -1, devices=None, model: int = 1, fsdp: int = 1) -> Mesh:
    """This rank's data-axis mesh.  ``data=-1`` (or None) takes every rank
    of the process group (one process when there is none); another value
    must equal that count.  ``devices`` is the device this rank computes on
    (a device, its name, or a list of one; None: the card).  ``model > 1``
    or ``fsdp > 1`` raise ``NotImplementedError`` (slice 7b).

    Under NCCL the communicator is made here by one eager all-reduce, so
    that the first captured step finds it."""
    if int(model or 1) > 1 or int(fsdp or 1) > 1:
        raise NotImplementedError(f"make_mesh(model={model}, fsdp={fsdp}): "
                                  f"{MODEL_AXES_REFUSED}")
    device = _one_device(devices)
    data = -1 if data is None else int(data)
    if not dist.is_initialized():
        if data not in (-1, 1):
            raise ValueError(f"mesh data={data} needs {data} ranks: launch them with "
                             f"trainer.devices={data}")
        return Mesh(1, 0, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data not in (-1, world):
        raise ValueError(f"mesh data={data}, but the launch made {world} ranks")
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL rank computes on a CUDA device, got {device}")
    mesh = Mesh(world, rank, device, backend, dist.group.WORLD)
    dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
    return mesh


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# ------------------------------------------------------------------ draws
def batch_draw(mesh: Optional[Mesh], fn: Callable[..., torch.Tensor], shape: Sequence[int],
               generator: Optional[torch.Generator], device, axis: int = 0,
               **kwargs) -> torch.Tensor:
    """``fn(shape, generator=, device=, **kwargs)``, a draw whose ``axis`` is
    the batch (the first, or a later one, as the autoregressive samplers'
    Gumbel draws have it): on a mesh of ``world`` ranks drawn at ``world``
    times the rows (the global batch) and this rank's rows kept, so that the
    ranks together hold the one-process draw and their generators stay in
    step."""
    shape = tuple(int(s) for s in shape)
    if mesh is None or mesh.world == 1:
        return fn(shape, generator=generator, device=device, **kwargs)
    n = shape[axis]
    full = fn(shape[:axis] + (n * mesh.world,) + shape[axis + 1:], generator=generator,
              device=device, **kwargs)
    return full.narrow(axis, mesh.rank * n, n)


def take_rows(mesh: Optional[Mesh], full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor over the global batch."""
    if mesh is None or mesh.world == 1:
        return full
    n = full.shape[0] // mesh.world
    return full[mesh.rank * n:(mesh.rank + 1) * n]


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the
    gradients (each rank's loss reaches every rank's rows through it), and
    so on for a gradient of a gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable."""
    return _AllReduceSum.apply(x, mesh.group)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


@torch.no_grad()
def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor], mean: bool = True
                ) -> List[torch.Tensor]:
    """The tensors summed (``mean``: averaged) over the ranks, one
    flattened buffer a dtype and one collective a buffer; returned as views
    of the buffers, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        if mean:
            flat.div_(mesh.world)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


@torch.no_grad()
def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the first axis in rank order:
    the global batch of a per-rank one."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _state_tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors of a module, a train state (modules, optimizer states,
    the EMA shadow), an optimizer, or a dict of them."""
    from ..core.state import TrainState
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, TrainState):
        yield from _state_tensors(obj.modules)
        for name in sorted(obj.opt_states):
            yield from _state_tensors(obj.opt_states[name])
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                for key in sorted(obj.state.get(p, {})):
                    value = obj.state[p][key]
                    if isinstance(value, torch.Tensor):
                        yield value
    elif isinstance(obj, dict):
        for key in sorted(obj):
            yield from _state_tensors(obj[key])


@torch.no_grad()
def replicate(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's tensors of ``obj`` (a module, a train state, an optimizer,
    or a dict of them) broadcast to every rank, in place, one
    flattened buffer a dtype and device; returns ``obj``."""
    if not mesh.grouped:
        return obj
    tensors = list(_state_tensors(obj))
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset:offset + n].view(tensors[i].shape))
            offset += n
    return obj


# ------------------------------------------------------------------- data
def shard_batch(mesh: Mesh, batch: Sequence[Any], blocks: int = 1) -> tuple:
    """This rank's rows (:meth:`Mesh.local_rows`) of a host batch (numpy
    arrays or CPU tensors, every one with the global batch's rows), as
    tensors on the rank's device."""
    def put(a) -> torch.Tensor:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        rows = mesh.local_rows(len(a), blocks)
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(mesh.device)

    return tuple(put(a) for a in batch)


# --------------------------------------------------------------- sampling
def sample_sharded(model, mesh: Mesh, state, generator: Optional[torch.Generator], n: int,
                   sampler: str = "sample", **kwargs) -> torch.Tensor:
    """Multi-card inference: the images ``model.<sampler>(n, generator=...,
    **kwargs)`` draws in one process, made by the ranks together.  Every
    rank draws the global noise for ``n`` images from ``generator`` (the
    same seed on every rank), keeps its ``n / world`` rows and runs the
    sampler on them; the parts are all-gathered in rank order.  Tensor
    keywords with ``n`` rows (``y``, ``x_T``) are split the same way.
    ``state`` is accepted as ``igm_tpu``'s (the model samples from its own
    modules and EMA shadow).  ``n`` must divide by the ranks, as there."""
    del state
    if n % mesh.world:
        raise ValueError(f"sample batch {n} not divisible by data axes {mesh.world}")
    local = n // mesh.world
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    kwargs = {k: (v[rows] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n
                  else v) for k, v in kwargs.items()}
    with model.sharded(mesh):
        part = getattr(model, sampler)(local, generator=generator, **kwargs)
    return all_gather_rows(mesh, part) if mesh.grouped else part


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank waits here for the others (after rank 0's saves and
    validation); nothing without a process group."""
    if mesh is None or not mesh.grouped:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
