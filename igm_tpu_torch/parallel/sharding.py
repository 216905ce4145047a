"""The model axis's sharded train state: counterpart of ``igm_tpu``'s
``shard_state``, ``state_shardings`` and ``init_state_sharded``
(``parallel/mesh.py:206-250``) and of the collectives GSPMD derives from
them.

Every parameter and persistent buffer of a model's ``modules`` is a leaf
with ``igm_tpu``'s spec (``mesh.leaf_spec``), stated on its Flax layout
(``interop.flax_layout``): a rank keeps, of a sharded leaf, the elements
``igm_tpu``'s shard on that device holds, in the Flax layout, as the
module's parameter (or buffer).  So the optimizers (the Adam moments,
``CastAdam``'s bfloat16 ones) and the EMA shadow, built over the modules'
parameters, hold shards too: ZeRO-3.

- A leaf sharded over the FSDP axis (``model`` on the 2-D mesh, ``fsdp``
  on the 3-D one) is all-gathered before use and put back after: a
  forward pre-hook on every module that holds a sharded leaf, itself or
  below, gathers those of its leaves that no caller has (one
  ``all_gather_into_tensor`` a dtype over the flattened shards).  So the
  outermost call, an entry of ``modules``, gathers them all at once, and
  a block that activation checkpointing (``model.remat``) runs again in
  the backward pass gathers its own again.  A buffer the forward changed
  (BatchNorm's statistics) keeps its shard of the new value.  The
  gather's backward gives the shard its gradient: on the 2-D mesh the
  model group's ranks computed the same rows, so it is the rank's slice;
  on the 3-D mesh ``fsdp`` is a batch axis, so it is a reduce-scatter over
  ``fsdp``.  The optimizer then averages it over the rest of the batch
  axes (``core/optim.py``).
- A leaf with a Megatron spec (``mesh.mode=tensor``: the DiT blocks'
  column and row layers, and a Switch-MoE's stacked experts) keeps its
  ``model`` shard in the computation (``parallel/tensor.py``,
  ``networks/moe.py``; the blocks learn the mesh through ``bind_mesh``);
  on the 3-D mesh its other dimension is gathered over ``fsdp`` as above.
- Replicated leaves are as in one process.
- On a pipeline mesh (``parallel/pipeline.py``) a leaf of a pipelined DiT
  block lives on its block's stage alone (``Leaf.stage``): that stage's
  ranks keep it whole, in the torch layout, and the others an empty
  tensor, so their optimizer moments and EMA shadow are empty too.  Such
  a leaf is never gathered for a forward (only its stage runs its block);
  the whole-state paths broadcast it from its stage.

:func:`shard_modules` shards a model's freshly drawn (full) modules on
the host, before they reach the device, so the device never holds the
whole state (``init_state_sharded``).  Unlike ``igm_tpu``'s jit with
``out_shardings``, the host draws the whole modules once (every rank,
from the same seed) and keeps its shards.  :class:`Sharding` gathers the whole
state for a checkpoint or a rank-0 validation and slices a whole state
(a checkpoint, a one-process state) onto the shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..interop import FlaxLayout, flax_layout, flax_names
from .mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, all_gather_into,
                   broadcast, leaf_spec, reduce_scatter)

@dataclasses.dataclass(eq=False)
class Leaf:
    """One parameter or persistent buffer of a model's ``modules``: its
    ``state_dict`` key, the module ``owner`` that holds it as ``name``,
    its torch shape, Flax layout and spec (one entry a Flax dimension) on
    ``mesh``; ``stage``: the stage that holds it on a pipeline mesh (None:
    every stage)."""
    key: str
    owner: nn.Module
    name: str
    buffer: bool
    shape: torch.Size
    layout: FlaxLayout
    spec: tuple
    mesh: Mesh
    stage: Optional[int] = None

    @property
    def top(self) -> str:
        return self.key.split(".", 1)[0]

    @property
    def axes(self) -> List[Tuple[int, str]]:
        """(Flax dimension, axis) of every sharded dimension."""
        return [(d, a) for d, a in enumerate(self.spec) if a is not None]

    @property
    def staged(self) -> bool:
        """Whether the leaf lives on one stage of a pipeline mesh."""
        return self.stage is not None

    @property
    def sharded(self) -> bool:
        """Whether a rank holds less than the whole leaf."""
        return bool(self.axes) or self.staged

    def mine(self, mesh: Mesh) -> bool:
        """Whether this rank's stage holds the (staged) leaf."""
        return self.stage == mesh.coord(STAGE_AXIS)

    def kept(self, mesh: Mesh) -> Optional[Tuple[int, str]]:
        """The dimension a tensor-parallel leaf keeps sharded in its
        computation: a DiT block's column layer its output features, a row
        layer its input features (None: gathered whole before use)."""
        dim = _megatron_dim(self.key) if mesh.mode == "tensor" else None
        if dim is None or len(self.spec) <= dim or self.spec[dim] != MODEL_AXIS:
            return None
        return dim, MODEL_AXIS

    def gathered(self, mesh: Mesh) -> Optional[Tuple[int, str]]:
        """The dimension gathered before each forward (None: none)."""
        kept = self.kept(mesh)
        return next(((d, a) for d, a in self.axes if (d, a) != kept), None)

    def shard_of(self, full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """This rank's shard of a whole torch-layout tensor: the Flax view
        narrowed on every sharded dimension, contiguous; of a staged leaf
        the whole tensor on its stage, an empty one elsewhere."""
        if self.staged:
            return full.contiguous() if self.mine(mesh) else full.new_empty((0,))
        t = self.layout.to_flax(full)
        for d, a in self.axes:
            size = t.shape[d] // mesh.size(a)
            t = t.narrow(d, mesh.coord(a) * size, size)
        return t.contiguous()


def _megatron_dim(key: str) -> Optional[int]:
    """The Flax dimension a DiT block's column (``qkv``, ``Dense_0``) or
    row (``proj``, ``Dense_1``) layer splits over ``model``: a column
    kernel's output features (1) and its bias (0), a row kernel's input
    features (0); a Switch-MoE's stacked expert leaf its expert axis (0,
    expert parallelism); None for any other leaf."""
    names = flax_names(key)
    if not any(n.startswith("DiTBlock") for n in names) or len(names) < 2:
        return None
    if names[-2] == "moe" and names[-1] in ("w_up", "w_dn", "b_up", "b_dn"):
        return 0
    col, row = names[-2] in ("qkv", "Dense_0"), names[-2] in ("proj", "Dense_1")
    if names[-1] == "kernel" and (col or row):
        return 1 if col else 0
    return 0 if names[-1] == "bias" and col else None


def module_leaves(modules: nn.ModuleDict, mesh: Mesh) -> List[Leaf]:
    """Every parameter and persistent buffer of ``modules`` with its spec
    on ``mesh``, in ``state_dict`` order; on a pipeline mesh the leaves of
    a module with a ``pipe_stage`` (a pipelined DiT block), itself or
    above, are that stage's."""
    leaves = []
    parents: Dict[str, nn.Module] = {}
    stages: Dict[str, Optional[int]] = {}
    for prefix, module in modules.named_modules():
        for child_name, child in module.named_children():
            parents[f"{prefix}.{child_name}" if prefix else child_name] = module
        stage = getattr(module, "pipe_stage", None) if mesh.staged else None
        stages[prefix] = stage if stage is not None else stages.get(prefix.rpartition(".")[0])
        items = [(n, t, False) for n, t in module._parameters.items() if t is not None]
        items += [(n, t, True) for n, t in module._buffers.items()
                  if t is not None and n not in module._non_persistent_buffers_set]
        for name, tensor, buffer in items:
            key = f"{prefix}.{name}" if prefix else name
            layout = flax_layout(key, tensor, module, parents.get(prefix))
            spec = leaf_spec(mesh, flax_names(key), layout.flax_shape(tensor.shape))
            leaves.append(Leaf(key, module, name, buffer, tensor.shape, layout, spec, mesh,
                               stages[prefix]))
    return leaves


def state_shardings(modules: nn.ModuleDict, mesh: Mesh) -> Dict[str, tuple]:
    """``igm_tpu``'s ``state_shardings`` of a model's leaves: the spec of
    every parameter and persistent buffer by ``state_dict`` key, stated on
    its Flax leaf (an optimizer's moments and the EMA shadow have their
    parameter's)."""
    return {leaf.key: leaf.spec for leaf in module_leaves(modules, mesh)}


def _assemble(parts: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``parts`` of shape (s_1, ..., s_k, *shard), the shards of ``k``
    gathered axes in rank order (the last innermost), concatenated along
    each axis's Flax dimension ``dims[i]``."""
    k = len(dims)
    for i in reversed(range(k)):
        parts = torch.cat(parts.unbind(i), dim=dims[i] + i)
    return parts


def gather_whole(mesh: Mesh, leaf: Leaf, shard: torch.Tensor) -> torch.Tensor:
    """The whole torch-layout tensor of a leaf from its shards on every
    rank (a collective over the leaf's axes, or a broadcast from its stage
    over the stage group; no gradient)."""
    if not leaf.sharded:
        return shard
    if leaf.staged:
        whole = (shard.detach().clone() if leaf.mine(mesh) else
                 torch.empty(leaf.shape, dtype=shard.dtype, device=shard.device))
        broadcast(whole, mesh.group_of(STAGE_AXIS), leaf.stage)
        return whole
    axes = [a for a in mesh.axis_names if a in leaf.spec]
    dims = [leaf.spec.index(a) for a in axes]
    sizes = [mesh.size(a) for a in axes]
    shard = shard.detach().contiguous()
    out = torch.empty((math.prod(sizes) * shard.numel(),), dtype=shard.dtype,
                      device=shard.device)
    all_gather_into(out, shard.reshape(-1), mesh.group_of(*axes))
    whole = _assemble(out.view(*sizes, *shard.shape), dims)
    return leaf.layout.from_flax(whole).contiguous()


class _Gather(torch.autograd.Function):
    """The compute tensors of a module's leaves from their shards: each
    gathered over its FSDP axis (one all-gather a dtype), then in the
    torch layout.  Backward: each gradient's shard, sliced (2-D mesh) or
    reduce-scattered over ``fsdp`` (3-D mesh), one collective a dtype."""

    @staticmethod
    def forward(ctx, plan: "_Plan", *shards: torch.Tensor):
        ctx.plan = plan
        outs = tuple(t.contiguous() for t in plan.gather(shards))
        ctx.like = [(t.shape, t.dtype, t.device) for t in outs]
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, *ctx.plan.scatter(grads))


@dataclasses.dataclass(eq=False)
class _Plan:
    """The leaves one forward pre-hook gathers, with their gathered
    dimension and the group it runs over."""
    mesh: Mesh
    leaves: List[Leaf]

    def _buckets(self, items) -> Dict[Any, List[int]]:
        out: Dict[Any, List[int]] = {}
        for i, (leaf, t) in enumerate(items):
            out.setdefault((leaf.gathered(self.mesh)[1], t.dtype), []).append(i)
        return out

    def gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        mesh, out = self.mesh, [None] * len(shards)
        for (axis, dtype), idx in self._buckets(list(zip(self.leaves, shards))).items():
            m = mesh.size(axis)
            flat = torch.cat([shards[i].reshape(-1) for i in idx])
            whole = torch.empty((m * flat.numel(),), dtype=dtype, device=flat.device)
            all_gather_into(whole, flat, mesh.group_of(axis))
            whole = whole.view(m, -1)
            offset = 0
            for i in idx:
                n = shards[i].numel()
                parts = whole[:, offset:offset + n].reshape(m, *shards[i].shape)
                gathered = torch.cat(parts.unbind(0), dim=self.leaves[i].gathered(mesh)[0])
                out[i] = self.leaves[i].layout.from_flax(gathered)
                offset += n
        return out

    def scatter(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        mesh, out = self.mesh, [None] * len(grads)
        chunks = []
        for leaf, g in zip(self.leaves, grads):
            d, axis = leaf.gathered(mesh)
            chunks.append(torch.stack(leaf.layout.to_flax(g).chunk(mesh.size(axis), dim=d)))
        for (axis, dtype), idx in self._buckets(list(zip(self.leaves, chunks))).items():
            if axis == MODEL_AXIS:
                # the model group's ranks computed the same rows: the rank's slice
                for i in idx:
                    out[i] = chunks[i][mesh.coord(axis)].contiguous()
                continue
            m = mesh.size(axis)
            flat = torch.cat([chunks[i].reshape(m, -1) for i in idx], dim=1)
            mine = torch.empty((flat.shape[1],), dtype=dtype, device=flat.device)
            reduce_scatter(mine, flat.reshape(-1), mesh.group_of(axis))
            offset = 0
            for i in idx:
                n = chunks[i][0].numel()
                out[i] = mine[offset:offset + n].view(chunks[i].shape[1:])
                offset += n
        return out


class Sharding:
    """A model's sharded modules on ``mesh``: their leaves, the forward
    hooks that gather the FSDP leaves, and the whole-state gathers and
    slices of checkpoints and validation.  ``active``: the shards are in
    place (not within :meth:`whole`)."""

    def __init__(self, model, mesh: Mesh):
        self.model, self.mesh = model, mesh
        self.leaves = module_leaves(model.modules, mesh)
        self.by_key = {leaf.key: leaf for leaf in self.leaves}
        self.active = True
        self._handles: list = []
        self._stack: list = []
        self._open: set = set()         # the leaves a hook has put in place

    # ------------------------------------------------------------ install
    def shard(self) -> None:
        """Replace every sharded leaf of the (whole, host) modules by this
        rank's shard, and hook the gathers into the forward of every module
        that holds a sharded leaf, itself or below."""
        with torch.no_grad():
            for leaf in self.leaves:
                if not leaf.sharded:
                    continue
                full = getattr(leaf.owner, leaf.name)
                shard = leaf.shard_of(full, self.mesh)
                if leaf.buffer:
                    leaf.owner._buffers[leaf.name] = shard
                else:
                    p = nn.Parameter(shard, requires_grad=full.requires_grad)
                    p._igm_leaf = leaf
                    leaf.owner._parameters[leaf.name] = p
        sharded = [leaf for leaf in self.leaves if leaf.axes]     # a staged leaf stays
        for prefix, module in self.model.modules.named_modules():
            mine = [leaf for leaf in sharded if leaf.key.startswith(prefix + ".")]
            if not prefix or not mine:
                continue
            self._handles.append(module.register_forward_pre_hook(
                lambda mod, args, leaves=mine: self._enter(leaves)))
            self._handles.append(module.register_forward_hook(
                lambda mod, args, out: self._exit(), always_call=True))

    def remove(self) -> None:
        """Undo the hooks (the leaves stay what they are: a new draw
        replaces them)."""
        for h in self._handles:
            h.remove()
        self._handles = []

    def whole_modules(self) -> None:
        """Put empty whole-shaped host parameters in place of the shards,
        for a new draw (``BaseModel.init_params``)."""
        for leaf in self.leaves:
            if leaf.sharded:
                t = torch.empty(leaf.shape, dtype=getattr(leaf.owner, leaf.name).dtype)
                if leaf.buffer:
                    leaf.owner._buffers[leaf.name] = t
                else:
                    leaf.owner._parameters[leaf.name] = nn.Parameter(t)

    # ------------------------------------------------------------- hooks
    def _enter(self, leaves: List[Leaf]) -> None:
        """Put in place those of ``leaves`` that no caller has: a gathered
        leaf gathered, a kept one in the torch layout."""
        pending = [leaf for leaf in leaves if leaf not in self._open] if self.active else []
        if not pending:
            self._stack.append(None)
            return
        mesh = self.mesh
        saved = [(leaf, (leaf.owner._buffers if leaf.buffer else leaf.owner._parameters)
                  [leaf.name]) for leaf in pending]
        gathered = [(leaf, v) for leaf, v in saved if leaf.gathered(mesh) is not None]
        kept = [(leaf, v) for leaf, v in saved if leaf.gathered(mesh) is None]
        params = [(leaf, v) for leaf, v in gathered if not leaf.buffer]
        buffers = [(leaf, v) for leaf, v in gathered if leaf.buffer]
        installed = []
        if params:
            plan = _Plan(mesh, [leaf for leaf, _ in params])
            outs = _Gather.apply(plan, *[v for _, v in params])
            installed += list(zip([leaf for leaf, _ in params], outs))
        if buffers:
            with torch.no_grad():
                outs = _Plan(mesh, [leaf for leaf, _ in buffers]).gather(
                    [v for _, v in buffers])
            installed += list(zip([leaf for leaf, _ in buffers], outs))
        installed += [(leaf, leaf.layout.from_flax(v)) for leaf, v in kept]
        for leaf, t in installed:
            (leaf.owner._buffers if leaf.buffer else leaf.owner._parameters)[leaf.name] = t
        self._open.update(pending)
        self._stack.append(saved)

    def _exit(self) -> None:
        saved = self._stack.pop()
        if saved is None:
            return
        self._open.difference_update(leaf for leaf, _ in saved)
        with torch.no_grad():
            for leaf, shard in saved:
                if leaf.buffer:
                    now = leaf.owner._buffers[leaf.name]
                    shard.copy_(leaf.shard_of(now, self.mesh))
                    leaf.owner._buffers[leaf.name] = shard
                else:
                    leaf.owner._parameters[leaf.name] = shard

    # -------------------------------------------------------- whole state
    def _ema_leaves(self) -> Dict[str, Leaf]:
        top = getattr(self.model, "_ema_of", None)
        return {leaf.key[len(top) + 1:]: leaf for leaf in self.leaves
                if top is not None and leaf.top == top}

    def _opt_leaves(self, opt) -> List[Optional[Leaf]]:
        return [getattr(p, "_igm_leaf", None) for group in opt.param_groups
                for p in group["params"]]

    def _map_state(self, saved: Dict[str, Any], opt_states: Dict[str, Any],
                   fn) -> Dict[str, Any]:
        """``saved`` (a ``TrainState.state_dict``) with ``fn(leaf, t)``
        applied to every sharded leaf's tensor: the parameters and buffers,
        the optimizers' per-parameter tensors (``opt_states``' optimizers
        say whose), the EMA shadow."""
        out = dict(saved)
        out["params"] = {k: (fn(self.by_key[k], v) if k in self.by_key
                             and self.by_key[k].sharded else v)
                         for k, v in saved["params"].items()}
        opts = {}
        ema = self._ema_leaves()
        for name, value in saved["opt_states"].items():
            current = opt_states.get(name)
            if isinstance(current, torch.optim.Optimizer):
                leaves = self._opt_leaves(current)
                value = {"state": {i: {k: (fn(leaves[i], t) if leaves[i] is not None
                                           and t.ndim and leaves[i].sharded else t)
                                       for k, t in st.items()}
                                   for i, st in value["state"].items()},
                         "param_groups": value["param_groups"]}
            elif name == "ema":
                value = {k: (fn(ema[k], t) if k in ema and ema[k].sharded else t)
                         for k, t in value.items()}
            opts[name] = value
        out["opt_states"] = opts
        return out

    def gather_state_dict(self, saved: Dict[str, Any],
                          opt_states: Dict[str, Any]) -> Dict[str, Any]:
        """The whole ``state_dict`` from every rank's shards (a collective:
        every rank calls it); replicated leaves as they are."""
        return self._map_state(saved, opt_states,
                               lambda leaf, t: gather_whole(self.mesh, leaf, t))

    def shard_state_dict(self, saved: Dict[str, Any],
                         opt_states: Dict[str, Any]) -> Dict[str, Any]:
        """``saved`` with every whole sharded tensor sliced to this rank's
        shard (a tensor already of the shard's shape is kept)."""
        def slice_(leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
            if tuple(t.shape) == tuple(leaf.shape):
                return leaf.shard_of(t, self.mesh)
            return t
        return self._map_state(saved, opt_states, slice_)

    @contextlib.contextmanager
    def whole(self):
        """Within: every rank holds the whole modules and EMA shadow (each
        gathered; the hooks off, the model rebound so that no block is
        tensor-parallel), as one process does, for a rank-0 validation or
        sampler; the shards after.  Every rank enters it."""
        model, mesh = self.model, self.mesh
        ema = model.state.opt_states.get("ema") if model.state is not None else None
        kept_ema = dict(ema) if ema is not None else None
        saved = []
        with torch.no_grad():
            for leaf in self.leaves:
                if not leaf.sharded:
                    continue
                table = leaf.owner._buffers if leaf.buffer else leaf.owner._parameters
                saved.append((leaf, table[leaf.name]))
                whole = gather_whole(mesh, leaf, table[leaf.name])
                table[leaf.name] = whole if leaf.buffer else nn.Parameter(whole)
            if ema is not None:
                for k, leaf in self._ema_leaves().items():
                    if leaf.sharded and k in ema:
                        ema[k] = gather_whole(mesh, leaf, ema[k])
        self.active = False
        model._bind_mesh()
        model._graphs.clear()
        try:
            yield
        finally:
            model._graphs.clear()
            self.active = True
            model._bind_mesh()
            for leaf, shard in saved:
                table = leaf.owner._buffers if leaf.buffer else leaf.owner._parameters
                if leaf.buffer:
                    shard.copy_(leaf.shard_of(table[leaf.name], mesh))
                table[leaf.name] = shard
            if ema is not None:
                ema.update(kept_ema)


def element_index(p: torch.Tensor) -> Optional[torch.Tensor]:
    """Of a shard parameter, each element's linear index in the whole
    torch-layout tensor (row-major), int32, in the shard's order; None for
    a parameter that is not a shard.  ``CastAdam``'s stochastic rounding
    hashes it, as one process hashes the whole parameter's."""
    leaf = getattr(p, "_igm_leaf", None)
    if leaf is None:
        return None
    mesh = leaf.mesh
    n = 1
    for d in leaf.shape:
        n *= int(d)
    index = torch.arange(n, dtype=torch.int32, device=p.device).view(leaf.shape)
    return leaf.shard_of(index, mesh)


def grad_axes(p: torch.Tensor, mesh: Mesh) -> Tuple[str, ...]:
    """The axes over which an update still sums a parameter's gradient on
    ``mesh``: ``data`` alone for a leaf gathered over ``fsdp`` (its
    backward reduce-scattered it there); ``data`` and ``stage`` for a leaf
    every stage of a pipeline mesh holds (each stage's gradient is its
    part of the whole, ``parallel/pipeline.py``); () for the batch axes
    (every other leaf)."""
    leaf = getattr(p, "_igm_leaf", None)
    if mesh.staged and (leaf is None or not leaf.staged):
        return (DATA_AXIS, STAGE_AXIS)
    if leaf is not None and leaf.mesh.size(FSDP_AXIS) > 1:
        gathered = leaf.gathered(leaf.mesh)
        if gathered is not None and gathered[1] == FSDP_AXIS:
            return (DATA_AXIS,)
    return ()


def shard_axes(p: torch.Tensor) -> Tuple[str, ...]:
    """The axes a parameter's shard spans (its gradient's too): () for a
    replicated one, ``stage`` for one that lives on one stage."""
    leaf = getattr(p, "_igm_leaf", None)
    if leaf is None:
        return ()
    if leaf.staged:
        return (STAGE_AXIS,)
    return tuple(a for a in leaf.mesh.axis_names if a in leaf.spec)


def shard_modules(model, mesh: Mesh) -> Sharding:
    """Shard ``model.modules`` (whole, on the host, freshly drawn) onto
    ``mesh``: the model axis's ``init_state_sharded``."""
    sharding = Sharding(model, mesh)
    sharding.shard()
    return sharding


def init_state_sharded(model, mesh: Mesh, seed: int = 0):
    """``igm_tpu``'s ``init_state_sharded``: the model's train state built
    on ``mesh``, born sharded (``model.init_state`` after binding it)."""
    model.set_mesh(mesh)
    return model.init_state(seed)


def shard_state(model, mesh: Mesh, state):
    """``igm_tpu``'s ``shard_state``: a one-process train state placed on
    ``mesh`` (each rank keeps its shards of it): a state built there
    (:func:`init_state_sharded`), then ``state``'s values loaded into it,
    every whole tensor sliced to the rank's shard."""
    saved = state.snapshot()
    sharded = init_state_sharded(model, mesh)
    sharded.load_state_dict(saved)
    return sharded
