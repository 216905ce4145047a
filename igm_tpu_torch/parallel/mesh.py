"""The mesh: counterpart of ``igm_tpu/parallel/mesh.py``'s ``make_mesh``,
``shard_batch``, ``replicate``, ``pad_to_multiple``, ``sample_sharded``
and its sharding specs (``_fsdp_spec``, ``_tp_spec``, ``state_shardings``).

``igm_tpu`` lays its devices out as a ``(data)``, ``(data, model)`` or
``(data, fsdp, model)`` mesh and GSPMD makes every step on it the
one-device step on the whole global batch: every random draw is made at
the global shape from the replicated key, batch statistics are taken over
the global batch, and the collectives follow from the shardings.  Here
each device is one process over ``torch.distributed`` (NCCL on CUDA; gloo
on the CPU, and for several ranks sharing one card), laid out with
``model`` the innermost axis (a model group's ranks are neighbours: one
host, one NVLink domain), and the same equality is built by hand.

The batch axes are ``data`` (times ``fsdp`` on the 3-D mesh,
``_batch_axes``): :attr:`Mesh.world` and :attr:`Mesh.rank` are their size
and this rank's place on them, and :attr:`Mesh.group` their process group.
Ranks that differ only in their ``model`` coordinate hold the same rows.
Every data-axis collective runs on the batch group:

- a rank holds its rows of each global batch (:meth:`Mesh.local_rows`,
  :func:`shard_batch`): batch rank r the r-th of ``world`` equal slices, or
  of each of ``blocks`` equal blocks for a step that splits its batch into
  blocks (FactorVAE's two halves);
- a training draw with a batch axis is made at the global batch size from
  the training generator, which has the same seed and so the same state on
  every rank, and the rank keeps its rows (:func:`batch_draw`);
- batch statistics are summed over the batch ranks by
  :func:`all_reduce_sum`, whose backward is the same all-reduce, so that
  gradients flow through the other ranks' rows as they do through one
  process's global batch;
- every optimizer update averages its gradients over the batch ranks, one
  flattened buffer a dtype (:func:`all_reduce_`), before gradient
  clipping.

With every loss a mean over the batch (the inventory is in
``core/optim.py``), the mean of the ranks' losses is the global batch's
loss, and the mean of their gradients its gradient.

Every collective issued here and in ``parallel/tensor.py`` is counted in
the tracing registry's work counters (``core/trace.py``):
``mesh.collectives`` the calls, ``mesh.collective_bytes`` the bytes of
the collective's whole buffer on this rank (an all-reduce's or a
broadcast's tensor, an all-gather's output, a reduce-scatter's input).  A
replayed graph counts the collectives it captured again.

The model axis (``model > 1``) shards the train state (``parallel/
sharding.py``): each leaf's spec is ``igm_tpu``'s, computed here on the
leaf's Flax layout (:func:`_fsdp_spec`, :func:`_tp_spec`,
:func:`leaf_spec`).  :attr:`Mesh.mode` is ``fsdp`` (every large leaf
sharded over ``model``, gathered before use: ZeRO-3) or ``tensor``
(Megatron column and row layers in the DiT blocks, FSDP elsewhere); on the
3-D mesh the FSDP leaves shard over ``fsdp`` instead.  The pipeline mesh
``(data, stage)`` (``mode=pipeline``, ``parallel/pipeline.py``) splits
the DiT's blocks and their state over ``stage``; its batch axis is
``data``.  Every rank creates the process groups of the sets of axes that
collectives run over (:meth:`Mesh.group_of`), all in the same order.

:class:`Mesh` without a process group is one process: nothing is reduced
and every draw is made at the local (= global) batch size, exactly as
before the data axis existed.  A mesh of one NCCL rank runs every
collective (each a copy) and gives the one-process step bit for bit.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import trace

DATA_AXIS = "data"
MODEL_AXIS = "model"
FSDP_AXIS = "fsdp"
STAGE_AXIS = "stage"
MODES = ("fsdp", "tensor", "pipeline")

# Leaves smaller than this stay replicated under FSDP (igm_tpu's rule):
# sharding tiny tensors trades an all-gather for negligible memory.
FSDP_MIN_SIZE = 2 ** 11


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh.  ``world`` and ``rank`` are the batch
    axes' size and this rank's place on them, ``group`` their process group
    (None for one process without a group); ``axes`` the mesh's
    ``(name, size)`` in order and ``coords`` this rank's coordinate on
    each (empty: the 1-D data mesh of ``world`` ranks); ``groups`` this
    rank's process group of each set of axes collectives run over
    (:func:`_new_groups`); ``mode`` how a model axis shards the state
    (``fsdp``, ``tensor``), or ``pipeline`` for the ``(data, stage)``
    mesh."""
    world: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    axes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[Tuple[str, int], ...] = ()
    groups: Any = None
    mode: str = "fsdp"

    @property
    def shape(self) -> Dict[str, int]:
        """Every axis's size, in the mesh's order."""
        return dict(self.axes) if self.axes else {DATA_AXIS: self.world}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (its batch rank on a 1-D mesh)."""
        if not self.coords:
            return self.rank if axis == DATA_AXIS else 0
        return dict(self.coords).get(axis, 0)

    @property
    def ranks(self) -> int:
        """Every rank of the mesh."""
        return int(np.prod(list(self.shape.values())))

    @property
    def sharded(self) -> bool:
        """Whether a model axis shards the train state."""
        return self.size(MODEL_AXIS) > 1

    @property
    def staged(self) -> bool:
        """Whether a stage axis splits the DiT's blocks (and their state)
        between ranks (``parallel/pipeline.py``)."""
        return self.size(STAGE_AXIS) > 1

    def group_of(self, *axes: str) -> Any:
        """The process group of this rank and the ranks that differ from it
        only on ``axes``."""
        key = tuple(a for a in self.axis_names if a in axes)
        if self.groups is None:
            return self.group
        return self.groups[key]

    @property
    def world_group(self) -> Any:
        """Every rank's group (None without one)."""
        return self.group_of(*self.axis_names) if self.grouped else None

    @property
    def grouped(self) -> bool:
        """Whether the mesh has a process group (collectives run)."""
        return self.group is not None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph captures a train step on the mesh: NCCL's
        collectives can be captured, gloo's run on the host and cannot.  A
        pipelined step (a stage axis) is eager by rule: its point-to-point
        hops are driven from the host, one microbatch at a time, inside
        the autograd engine's backward pass (``parallel/pipeline.py``)."""
        return self.backend != "gloo" and not self.staged

    def local_rows(self, n: int, blocks: int = 1) -> np.ndarray:
        """The positions of this rank's rows in a global batch of ``n``:
        the batch rank's slice of each of ``blocks`` equal blocks, in
        order."""
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


def _axes(size: int, data, model: int, fsdp: int, grouped: bool) -> List[Tuple[str, int]]:
    """The mesh's ``(name, size)`` over ``size`` ranks, with
    ``igm_tpu``'s errors (``make_mesh``, ``parallel/mesh.py:37-73``)."""
    if fsdp > 1:
        if model < 2:
            raise ValueError("fsdp axis requires a model axis (use the 2-D "
                             "(data, model) mesh for FSDP-only sharding)")
        if size % (fsdp * model):
            raise ValueError(f"fsdp*model {fsdp}*{model} does not divide {size} devices")
    elif model > 1 and size % model:
        raise ValueError(f"model axis {model} does not divide {size} devices")
    n = size // (fsdp * model)
    if data not in (-1, n):
        raise ValueError(f"mesh data={data} needs {data * fsdp * model} ranks: launch them "
                         f"with trainer.devices={data * fsdp * model}"
                         if not grouped else
                         f"mesh data={data}, but the launch made {size} ranks "
                         f"({n} a model{'/fsdp' if fsdp > 1 else ''} group)")
    axes = [(DATA_AXIS, n)]
    if fsdp > 1:
        axes.append((FSDP_AXIS, fsdp))
    if model > 1:
        axes.append((MODEL_AXIS, model))
    return axes


def _coords(axes, rank: int) -> Dict[str, int]:
    """A rank's coordinates, the last axis innermost."""
    out = {}
    for name, size in reversed(axes):
        out[name] = rank % size
        rank //= size
    return {name: out[name] for name, _ in axes}


def _new_groups(axes, rank: int, backend: str) -> Dict[Tuple[str, ...], Any]:
    """The process groups :meth:`Mesh.group_of` is asked for: each axis
    (``stage`` the pipeline's hops), the batch axes, the model axes
    (``fsdp`` and ``model``: a leaf's shard spans them) where the mesh has
    one, and every axis; each holds the ranks that differ only on those
    axes.  Every rank creates every group, in the same order, and
    keeps those it belongs to."""
    names = [name for name, _ in axes]
    coords = [_coords(axes, g) for g in range(int(np.prod([s for _, s in axes])))]
    wanted = [(name,) for name in names]
    wanted += [tuple(a for a in names if a in sets)
               for sets in ((DATA_AXIS, FSDP_AXIS), (FSDP_AXIS, MODEL_AXIS), names)]
    groups = {}
    for subset in dict.fromkeys(w for w in wanted if w):
        others = [n for n in names if n not in subset]
        for key in sorted({tuple(c[n] for n in others) for c in coords}):
            members = [g for g, c in enumerate(coords) if tuple(c[n] for n in others) == key]
            group = (dist.group.WORLD if len(members) == len(coords)
                     else dist.new_group(members, backend=backend))
            if tuple(coords[rank][n] for n in others) == key:
                groups[subset] = group
    return groups


def make_mesh(data: int = -1, devices=None, model: int = 1, fsdp: int = 1,
              mode: str = "fsdp", stage: int = 1) -> Mesh:
    """This rank's mesh.  ``data=-1`` (or None) takes every rank of the
    process group over ``fsdp * model`` (one process when there is none);
    another value must equal that count.  ``model > 1`` builds the 2-D
    ``(data, model)`` mesh, ``fsdp > 1`` (with ``model > 1``) the 3-D
    ``(data, fsdp, model)`` one, with ``igm_tpu``'s errors.  ``mode=
    pipeline`` or ``stage > 1`` builds the ``(data, stage)`` pipeline mesh
    instead (``parallel.pipeline.make_pipeline_mesh``; ``data=-1``: the
    ranks over ``stage``), as ``igm_tpu``'s trainer does.  ``devices`` is
    the device this rank computes on (a device, its name, or a list of
    one; None: the card).  ``mode``: ``fsdp``, ``tensor`` or ``pipeline``.

    Under NCCL each communicator is made here by one eager all-reduce, so
    that the first captured step finds it."""
    if mode not in MODES:
        raise ValueError(f"mesh mode must be {'|'.join(MODES)}, got {mode!r}")
    data = -1 if data is None else int(data)
    model, fsdp = max(1, int(model or 1)), max(1, int(fsdp or 1))
    stage = max(1, int(stage or 1))
    if mode == "pipeline" or stage > 1:
        if stage <= 1:
            raise ValueError("mesh.mode=pipeline needs mesh.stage > 1")
        if model > 1 or fsdp > 1:
            raise ValueError(f"the pipeline mesh is (data, stage): mesh.model={model} and "
                             f"mesh.fsdp={fsdp} do not compose with it")
        from .pipeline import make_pipeline_mesh
        size = dist.get_world_size() if dist.is_initialized() else 1
        return make_pipeline_mesh(stage, max(1, size // stage) if data == -1 else data,
                                  devices)
    device = _one_device(devices)
    size = dist.get_world_size() if dist.is_initialized() else 1
    axes = _axes(size, data, model, fsdp, dist.is_initialized())
    if not dist.is_initialized():
        return Mesh(1, 0, device, mode=mode)
    return build_mesh(axes, device, mode)


def build_mesh(axes: Sequence[Tuple[str, int]], device: torch.device, mode: str) -> Mesh:
    """This rank's :class:`Mesh` of ``axes`` (the last innermost) over the
    process group's ranks: its coordinates and groups; the batch axes are
    ``data`` (times ``fsdp``)."""
    rank = dist.get_rank()
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL rank computes on a CUDA device, got {device}")
    axes = list(axes)
    coords = _coords(axes, rank)
    if len(axes) == 1:
        groups = {(DATA_AXIS,): dist.group.WORLD}
    else:
        groups = _new_groups(axes, rank, backend)
    f = dict(axes).get(FSDP_AXIS, 1)
    batch = tuple(a for a in (DATA_AXIS, FSDP_AXIS) if a in dict(axes))
    mesh = Mesh(dict(axes)[DATA_AXIS] * f, coords[DATA_AXIS] * f + coords.get(FSDP_AXIS, 0),
                device, backend, groups[batch], tuple(axes), tuple(coords.items()), groups,
                mode)
    for group in groups.values():
        warm = torch.zeros(1, device=device)
        counted(warm)
        dist.all_reduce(warm, group=group)
    return mesh


# ------------------------------------------------------------------ specs
# igm_tpu's PartitionSpecs (parallel/mesh.py:111-214) on a leaf's Flax
# layout: a tuple with one entry a dimension, an axis name or None; () is
# replicated.  The port's leaves are stated in that layout through
# interop.FlaxLayout, so that a shard holds the elements igm_tpu's holds.
def _fsdp_spec(mesh: Mesh, shape: Sequence[int], axis: str = MODEL_AXIS) -> tuple:
    """``shape``'s largest ``axis``-divisible dimension over ``axis``
    (ties to the later one); leaves under FSDP_MIN_SIZE replicated."""
    m = mesh.size(axis)
    shape = tuple(int(d) for d in shape)
    if not shape or int(np.prod(shape)) < FSDP_MIN_SIZE:
        return ()
    best, best_dim = -1, None
    for i, d in enumerate(shape):
        if d % m == 0 and d >= best:
            best, best_dim = d, i
    if best_dim is None:
        return ()
    spec = [None] * len(shape)
    spec[best_dim] = axis
    return tuple(spec)


# Megatron tensor parallelism on the DiT blocks: column-parallel matrices
# (qkv, MLP-up, and by its parent name the adaLN modulation's Dense_0)
# shard their output features over ``model``, row-parallel ones (proj,
# MLP-down) their input features
_TP_COLUMN = ("qkv", "Dense_0")
_TP_ROW = ("proj", "Dense_1")


def _tp_spec(mesh: Mesh, names: Sequence[str], shape: Sequence[int]) -> Optional[tuple]:
    """The Megatron spec of a DiT-block leaf by its module-path ``names``
    (Flax's); None where no rule applies (the caller falls back to FSDP).
    Switch-MoE leaves shard their expert axis (expert parallelism)."""
    names = list(names)
    if not any(n.startswith("DiTBlock") for n in names) or len(names) < 2:
        return None
    m = mesh.size(MODEL_AXIS)
    shape = tuple(int(d) for d in shape)
    leaf, parent = names[-1], names[-2]
    if "moe" in names:
        if leaf in ("w_up", "w_dn", "b_up", "b_dn") and shape and shape[0] % m == 0:
            return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
        return ()
    col, row = parent in _TP_COLUMN, parent in _TP_ROW
    if not (col or row):
        return None
    if leaf == "kernel" and len(shape) == 2:
        dim = 1 if col else 0
        if shape[dim] % m:
            return None
        spec = [None, None]
        spec[dim] = MODEL_AXIS
        f = mesh.size(FSDP_AXIS)
        other = 1 - dim
        if f > 1 and shape[other] % f == 0 and int(np.prod(shape)) >= FSDP_MIN_SIZE:
            spec[other] = FSDP_AXIS
        return tuple(spec)
    if leaf == "bias" and len(shape) == 1:
        if col and shape[0] % m == 0:
            return (MODEL_AXIS,)
        return ()               # a row layer's bias: added once, after the all-reduce
    return None


def leaf_spec(mesh: Mesh, names: Sequence[str], shape: Sequence[int]) -> tuple:
    """``igm_tpu``'s spec of a train-state leaf (a parameter, its optimizer
    moments and EMA shadow, a mutable) with Flax path ``names`` and Flax
    ``shape`` on ``mesh`` (``state_shardings``/``_spec_for``): replicated
    without a model axis; under ``tensor`` the Megatron rule where one
    applies; else FSDP over ``model`` (over ``fsdp`` on the 3-D mesh)."""
    if not mesh.sharded:
        return ()
    if mesh.mode == "tensor":
        spec = _tp_spec(mesh, names, shape)
        if spec is not None:
            return spec
    axis = FSDP_AXIS if FSDP_AXIS in mesh.shape else MODEL_AXIS
    return _fsdp_spec(mesh, shape, axis)


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
def counted(buffer: torch.Tensor, parts: int = 1) -> None:
    """One collective over ``parts`` times ``buffer`` (its whole buffer on
    this rank), in the registry's work counters."""
    trace.count("mesh.collectives", 1, work=True)
    trace.count("mesh.collective_bytes", parts * buffer.numel() * buffer.element_size(),
                work=True)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the
    gradients (each rank's loss reaches every rank's rows through it), and
    so on for a gradient of a gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        counted(out)
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
def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor], mean: bool = True,
                group: Any = None) -> List[torch.Tensor]:
    """The tensors summed over the batch ranks (or ``group``'s), one
    flattened buffer a dtype and one collective a buffer; ``mean``: divided
    by the batch ranks.  Returned as views of the buffers, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        counted(flat)
        dist.all_reduce(flat, group=mesh.group if group is None else group)
        if mean:
            flat.div_(mesh.world)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def _gloo_cuda(x: torch.Tensor, group: Any) -> bool:
    """gloo ranks sharing a card: gloo's collectives on CUDA tensors are the
    list forms (all_gather, all_reduce), not the flat ones."""
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group: Any) -> None:
    """``dist.all_gather_into_tensor`` (the ranks' ``x`` one after the
    other in ``out``), its rename warning of newer torch silenced."""
    counted(out)
    if _gloo_cuda(x, group):
        dist.all_gather(list(out.chunk(dist.get_world_size(group))), x, group=group)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group: Any) -> None:
    """``dist.reduce_scatter_tensor``: ``x`` summed over the ranks, rank i
    keeping the i-th of its equal parts in ``out``."""
    counted(x)
    if _gloo_cuda(x, group):
        whole = x.clone()
        dist.all_reduce(whole, group=group)
        rank = dist.get_group_rank(group, dist.get_rank())
        out.copy_(whole.chunk(dist.get_world_size(group))[rank])
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)


def broadcast(x: torch.Tensor, group: Any, src: int) -> None:
    """``x`` from ``group``'s rank ``src`` on every rank of the group, in
    place (gloo ranks sharing a card: through host memory)."""
    counted(x)
    if _gloo_cuda(x, group):
        host = x.cpu()
        dist.broadcast(host, group=group, group_src=src)
        x.copy_(host)
        return
    dist.broadcast(x, group=group, group_src=src)


@torch.no_grad()
def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the first axis in rank order:
    the global batch of a per-rank one."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    counted(x, mesh.world)
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
        counted(flat)
        dist.broadcast(flat, group=mesh.group, group_src=0)
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
    modules and EMA shadow; on a model or stage axis every rank gathers
    them whole first, and the whole DiT runs its blocks in order).  ``n``
    must divide by the batch ranks, as there."""
    del state
    if n % mesh.world:
        raise ValueError(f"sample batch {n} not divisible by data axes {mesh.world}")
    local = n // mesh.world
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    kwargs = {k: (v[rows] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n
                  else v) for k, v in kwargs.items()}
    with model.unsharded(), model.sharded(mesh):
        part = getattr(model, sampler)(local, generator=generator, **kwargs)
    return all_gather_rows(mesh, part) if mesh.grouped else part


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh waits here for the others (after rank 0's
    saves and validation); nothing without a process group."""
    if mesh is None or not mesh.grouped:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.world_group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.world_group)
