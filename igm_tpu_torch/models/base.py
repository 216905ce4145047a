"""BaseModel and ValidationResult: the model <-> trainer/callbacks contract.

Counterpart of ``igm_tpu/models/base.py``.  A model holds its networks in
``self.modules`` (a ``torch.nn.ModuleDict`` on ``self.device``) with the
parameters inside them, where ``igm_tpu`` keeps them in a TrainState; the
port's :class:`~igm_tpu_torch.core.state.TrainState` holds the rest (step,
optimizer states, the training generator).  ``hparams`` and ``preprocess``
are as there.

Interface the Trainer calls:
  init_state(seed)                               -> TrainState
  train_step(state, batch)                       -> (TrainState, metrics)
  train_step_n(state, batches, graph=True)       -> (TrainState, metrics)
  validation_step(state, batch, generator,
                  sample=False)                  -> (ValidationResult, metrics)
  on_fit_start(state, train_arrays), on_restore(state),
  on_train_epoch_end(trainer)
Metrics are dicts of scalar tensors, fetched by the trainer when it logs.

``network(name, x, t, y)`` calls the diffusion-style network
``modules[name]`` for the samplers (DDPM's denoiser, EDM's ``F``, flow
matching's velocity): with the EMA shadow's weights when the train state
keeps one (``opt_states["ema"]``, updated in place by ``update_ema``, as
``igm_tpu`` samples from the shadow), and on a CUDA device, outside
autograd, as a CUDA graph per input signature (batch, dtype, with or
without labels, the shadow or the network's own weights): the inputs are
copied into the graph's static buffers and it is replayed.  The graph
reads the weights where they lie, so it follows the parameters and the
shadow, both updated in place.

The zoo's defaults (``igm_tpu/models/base.py:81-110``): ``forward(state,
z)`` decodes latents with ``modules[decoder_module_name]`` in eval mode
(on the card outside autograd, a CUDA graph per batch), ``sample(n,
generator)`` decodes N(0, I) latents of ``latent_dim``, and
``dummy_image_batch`` is a zero image batch; the traversal callbacks and
the sampling CLI call them.  A model without a decoder module or a
``latent_dim`` has no default sampler (:meth:`BaseModel.has_sampler`).

``train_step_n`` is the counterpart of ``igm_tpu``'s (``base.py:111-128``,
K steps in one ``lax.scan``): K train steps on ``[k, ...]`` batches, the
metrics the per-key nan-mean over the chunk.  On a CUDA device with
``use_graphs`` (the default) one execution is one CUDA graph launch: the K
steps are captured together into one graph (``core.graphs.StepGraph``),
one per chunk length, batch layout and starting phase (``state.step %
phase_period``: a model whose step picks its branch by the step, as GAN's
G/D alternation does, replays the branches of the steps it stands at),
kept in ``state.graphs``.  The first execution of a signature runs
eagerly and is then captured from the same step; later ones replay it.  A
scheduled learning rate is written for each update of the chunk into a
device vector before each launch (one ``fill_`` a value), from its
optimizer's own update count (``state.counts``).  On the CPU, or with
``graph=False`` or ``use_graphs = False``, it runs the K steps eagerly.  A
model's ``train_step`` must therefore make every draw from
``state.generator``, touch device state only in place, change nothing on
the host but ``state.step`` and ``state.counts``, and take its branch from
``state.step % phase_period`` alone; every branch returns the same metric
keys (NaN for what it does not compute).

Parallelism (``igm_tpu_torch.parallel``): :meth:`BaseModel.set_mesh`
binds a mesh of several ranks (or of one NCCL rank) to the model, its
optimizers and the modules that take batch statistics (Flax's BatchNorm,
the EMA codebook) or route over the batch (the Switch-MoE).
A train step then runs on this rank's rows of the global batch, and every
training draw with a batch axis goes through :meth:`BaseModel.batch_draw`:
made at the global batch size from ``state.generator`` (the same on every
rank), this rank's rows kept.  ``train_step_n`` averages each step's
metrics over the ranks, so every rank holds the global batch's; under
gloo, which a CUDA graph cannot capture, it runs the steps eagerly.
:meth:`BaseModel.sharded` binds a mesh for a block (``sample_sharded``) or,
with None, unbinds it (validation on rank 0 alone).  Without a mesh (one
process) every draw is made as before, at the batch it is given.  On a
mesh with a model axis, ``init_params`` shards the freshly drawn modules
on the host (``parallel.sharding``: ``self.sharding``), so every state
``make_state`` builds is born sharded; :meth:`BaseModel.unsharded` gives
every rank the whole modules for a block (rank 0's validation, a
sampler).  On a pipeline mesh (a ``stage`` axis, ``parallel/pipeline.py``)
the same sharding keeps each pipelined DiT block's leaves on its stage
alone, and :meth:`BaseModel.unsharded` broadcasts them to every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config.node import ConfigNode
from ..core.graphs import StepGraph
from ..core.optim import OptimizerSet
from ..core.state import TrainState
from ..parallel.mesh import Mesh, all_reduce_, batch_draw, take_rows
from ..utils.platform import resolve_device


def merge_metrics(per_step):
    """The per-key nan-mean of a list of metric dicts (scalar tensors), as
    ``igm_tpu`` merges a chunk's metrics: a key that is NaN on some steps
    (a phase that did not run) averages over the others."""
    if len(per_step) == 1:
        return dict(per_step[0])
    return {k: torch.stack([m[k] for m in per_step]).nanmean(dim=0) for k in per_step[0]}


def draw_labels(model: "BaseModel", labels, n: int, gen, drop) -> Optional[torch.Tensor]:
    """Conditional models: the labels with the drop mask (drawn from
    ``gen`` with ``cond_drop_prob`` when not given, a batch draw) set to the
    null token; None for unconditional ones."""
    if not model.num_classes:
        return None
    if drop is None:
        drop = (model.batch_draw(torch.rand, (n,), gen)
                < float(model.hparams.cond_drop_prob))
    labels = labels.to(model.device, non_blocking=True).long()
    return torch.where(drop, torch.full_like(labels, model.num_classes), labels)


def noise_source(model: "BaseModel", shape, generator: Optional[torch.Generator], noises):
    """A sampler's N(0, I) draws of ``shape``: the next of ``noises`` (given
    in the order the sampler draws) when given, else a batch draw from
    ``generator`` (``model.batch_draw``)."""
    given = iter(noises) if noises is not None else None

    def draw() -> torch.Tensor:
        if given is not None:
            return next(given)
        return model.batch_draw(torch.randn, shape, generator)

    return draw


def gumbel_noise(shape, generator: Optional[torch.Generator], device,
                 mesh: Optional[Mesh] = None, axis: int = 0) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1): a
    categorical draw ``jax.random.categorical(key, logits)`` is
    ``argmax(logits + gumbel)``.  ``axis`` is the batch's: on a data-axis
    ``mesh`` the draw is made at the global batch and this rank's rows kept
    (``parallel.mesh.batch_draw``)."""
    u = batch_draw(mesh, torch.rand, shape, generator, device, axis=axis)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


@dataclasses.dataclass
class _ChunkGraph:
    """A captured chunk of train steps: the graph, each scheduled
    optimizer's learning-rate slots (one an update, filled before a
    launch) and each optimizer's updates in the chunk."""
    graph: Optional[StepGraph] = None
    slots: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    updates: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ValidationResult:
    others: Dict[str, Any] = dataclasses.field(default_factory=dict)
    real_image: Any = None
    fake_image: Any = None
    recon_image: Any = None
    label: Any = None
    encode_latent: Any = None


class BaseModel:
    #: the module ``--weights`` loads into (the sampling CLI)
    weights_module: str = "denoise"
    #: the steps after which the branch a train step takes repeats (the
    #: GANs' alternating phases); a chunk's graph is kept per starting phase
    phase_period: int = 1
    #: the equal blocks a train step splits its batch into (FactorVAE's
    #: halves): under data parallelism a rank holds its rows of each block
    batch_blocks: int = 1

    def __init__(self, datamodule: Any, device: str | torch.device | None = None):
        self.width = int(datamodule["width"])
        self.height = int(datamodule["height"])
        self.channels = int(datamodule["channels"])
        transforms = datamodule.get("transforms") or {}
        self.input_normalize = bool(transforms.get("normalize", False))
        self.input_convert = bool(transforms.get("convert", False))
        self.output_act = "tanh" if self.input_normalize else "sigmoid"
        self.device = resolve_device(device)
        self.hparams = ConfigNode()
        self.modules = nn.ModuleDict()
        self.optimizers = OptimizerSet()
        self.steps_per_epoch: int = 1     # set by the Trainer before init_state
        self.state: Optional[TrainState] = None   # the state init_state made
        # on a CUDA device: train steps and the samplers' denoiser as CUDA
        # graphs (False: eager, for comparison and profiling)
        self.use_graphs = True
        # the model's own captured graphs (the samplers' denoiser), valid
        # while its parameters stay where they are
        self._graphs: dict = {}
        # the mesh of several ranks (set_mesh); None: one process
        self.mesh: Optional[Mesh] = None
        # the model axis's sharded modules (parallel.sharding); None: whole
        self.sharding = None

    def save_hyperparameters(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            self.hparams[k] = v

    def init_params(self, seed: int) -> None:
        """Draw every parameter afresh from ``seed`` (torch-parity init).
        The draws run on the CPU, so a seed gives the same weights on every
        device."""
        generator = torch.Generator().manual_seed(int(seed))
        self._graphs.clear()            # the move below gives new tensors
        if self.sharding is not None:   # a new draw of the whole modules
            self.sharding.remove()
            self.sharding.whole_modules()
            self.sharding = None
        self.modules.to("cpu")
        for module in self.modules.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        if self.mesh is not None and (self.mesh.sharded or self.mesh.staged):
            from ..parallel.sharding import shard_modules
            self.sharding = shard_modules(self, self.mesh)   # on the host
        self.modules.to(self.device)

    # ------------------------------------------------------- data parallel
    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Bind a mesh (``parallel.make_mesh``) to the model, its
        optimizers and the modules that take batch statistics; a mesh
        without a process group (one process) binds nothing.  The modules
        and optimizers ``init_state`` makes are bound when it makes them,
        and on a model or stage axis sharded."""
        self.mesh = mesh if mesh is not None and mesh.grouped else None
        self._bind_mesh()

    def _bind_mesh(self) -> None:
        """Every module with a ``bind_mesh(mesh, blocks)`` learns the mesh
        (None: one process) and the row blocks a step splits its batch
        into (``batch_blocks``).  While the modules are whole on a model
        or stage axis (``unsharded``), they see the mesh in ``fsdp`` mode:
        no layer is tensor-parallel and no block stack pipelined then."""
        self.optimizers.mesh = mesh = self.mesh
        if mesh is not None and self.sharding is not None and not self.sharding.active:
            mesh = dataclasses.replace(mesh, mode="fsdp")
        for module in self.modules.modules():
            if hasattr(module, "bind_mesh"):
                module.bind_mesh(mesh, self.batch_blocks)

    def unsharded(self):
        """Within: the whole modules and EMA shadow on every rank (a
        collective: every rank enters it), as one process holds them; the
        model axis's shards after.  Nothing without a model axis."""
        if self.sharding is None:
            return contextlib.nullcontext()
        return self.sharding.whole()

    @contextlib.contextmanager
    def sharded(self, mesh: Optional[Mesh]):
        """Within: the model bound to ``mesh`` (None: one process, as rank
        0 validates the whole batch alone); the mesh it had after."""
        saved = self.mesh
        self.set_mesh(mesh)
        try:
            yield
        finally:
            self.set_mesh(saved)

    def batch_draw(self, fn, shape, generator: Optional[torch.Generator], **kwargs
                   ) -> torch.Tensor:
        """``fn(shape, generator=, device=, **kwargs)`` (``torch.randn``,
        ``torch.rand``, a ``functools.partial`` of ``torch.randint``), a draw
        whose first axis is the batch: on a mesh, drawn at the global batch
        and this rank's rows kept (``parallel.mesh.batch_draw``)."""
        return batch_draw(self.mesh, fn, shape, generator, self.device, **kwargs)

    def batch_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the global batch."""
        return take_rows(self.mesh, full)

    def _default_labels(self, n: int) -> torch.Tensor:
        """Conditional samplers' labels: contiguous class blocks, so that
        with n a multiple of the grid row the sample grid shows one class
        per row (on a mesh, this rank's rows of the global batch's)."""
        full = n * (1 if self.mesh is None else self.mesh.world)
        return self.batch_rows(torch.arange(full, device=self.device) * self.num_classes // full)

    def make_state(self, seed: int) -> TrainState:
        """Parameters drawn from ``seed``, fresh optimizer states, and the
        training generator on the model's device seeded with ``seed + 1``."""
        self.init_params(seed)
        self._bind_mesh()
        generator = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        return TrainState(modules=self.modules,
                          opt_states=self.optimizers.init(self.modules),
                          generator=generator, sharding=self.sharding)

    def preprocess(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> float in [0,1] (convert) or [-1,1] (normalize), on
        the model's device."""
        x = imgs.to(self.device, non_blocking=True).float()
        if self.input_convert:
            x = x / 255.0
        if self.input_normalize:
            x = x * 2.0 - 1.0
        return x

    def dummy_image_batch(self, n: int = 2) -> torch.Tensor:
        return torch.zeros((n, self.height, self.width, self.channels), device=self.device)

    # ------------------------------------------------------- default sampling
    #: the module that decodes latents (``forward``, the default ``sample``)
    decoder_module_name: str = "decoder"

    def has_sampler(self) -> bool:
        """Whether ``sample`` draws images: a model's own sampler, or the
        default one where there is a decoder of ``latent_dim`` latents."""
        return (type(self).sample is not BaseModel.sample
                or (self.decoder_module_name in self.modules
                    and "latent_dim" in self.hparams))

    def graphed(self, key, fn, *inputs: torch.Tensor) -> torch.Tensor:
        """``fn(*inputs)``, called outside autograd; on the card (with
        ``use_graphs``) as a CUDA graph kept under ``key`` and the inputs'
        shapes."""
        if not (self.use_graphs and inputs[0].is_cuda):
            return fn(*inputs)
        key = (key, tuple((tuple(t.shape), t.dtype) for t in inputs))
        if key not in self._graphs:
            self._graphs[key] = StepGraph(fn)
        return self._graphs[key](*inputs)

    @torch.no_grad()
    def forward(self, state: Optional[TrainState], z: torch.Tensor) -> torch.Tensor:
        """Latents (n, ...) -> images (n, H, W, C): the decoder in eval mode
        (the parameters and buffers where they lie; ``state`` is accepted
        as ``igm_tpu``'s)."""
        net = self.modules[self.decoder_module_name]
        shape = (z.shape[0], self.height, self.width, self.channels)
        return self.graphed("forward", lambda z: net(z, train=False).reshape(shape), z)

    def latent_noise(self, n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(n, latent_dim) N(0, I) draws on the model's device (a batch
        draw)."""
        return self.batch_draw(torch.randn, (n, int(self.hparams["latent_dim"])), generator)

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n images decoded from N(0, I) latents of ``latent_dim``."""
        if not self.has_sampler():
            raise NotImplementedError(f"{type(self).__name__} has no default sampler")
        return self.forward(self.state, self.latent_noise(n, generator))

    # ------------------------------------------------------------------ hooks
    def init_state(self, seed: int) -> TrainState:  # pragma: no cover
        raise NotImplementedError

    def train_step(self, state: TrainState, batch):  # pragma: no cover
        raise NotImplementedError

    def validation_step(self, state: TrainState, batch,
                        generator: torch.Generator,
                        sample: bool = False):  # pragma: no cover
        raise NotImplementedError

    def _steps(self, state: TrainState, batches):
        """The K eager train steps of a chunk and their merged metrics (on a
        mesh each step's averaged over the ranks)."""
        per_step = []
        for i in range(len(batches[0])):
            state, metrics = self.train_step(state, tuple(b[i] for b in batches))
            if self.mesh is not None:
                metrics = dict(zip(metrics, all_reduce_(self.mesh, list(metrics.values()))))
            per_step.append(metrics)
        return state, merge_metrics(per_step)

    def train_step_n(self, state: TrainState, batches, graph: bool = True):
        """K train steps on ``batches``, a tuple of ``[k, B, ...]`` tensors
        on the model's device -> (state, the nan-mean of their metrics)."""
        k = len(batches[0])
        if not self._graphed(graph):
            return self._steps(state, batches)
        phase = state.step % self.phase_period
        key = ("train_step_n", k, phase, tuple((tuple(b.shape), b.dtype) for b in batches))
        chunk = state.graphs.get(key)
        if chunk is None:
            chunk = state.graphs[key] = self._capture_chunk(state)
        else:
            for name, slot in chunk.slots.items():   # one fill a value: no host memory to wait for
                tx, count = self.optimizers.tx(name), state.counts.get(name, 0)
                for i in range(len(slot)):
                    slot[i].fill_(tx.lr_at(count + i))
        first, counts = state.step, dict(state.counts)
        metrics = chunk.graph(*batches)
        state.step = first + k
        state.counts = {name: counts.get(name, 0) + n for name, n in chunk.updates.items()}
        return state, metrics

    def _graphed(self, graph: bool) -> bool:
        """Whether ``train_step_n`` runs its chunk as a CUDA graph: not
        under gloo, whose collectives a graph cannot capture."""
        return (graph and self.use_graphs and self.device.type == "cuda"
                and (self.mesh is None or self.mesh.capturable))

    def _capture_chunk(self, state: TrainState) -> "_ChunkGraph":
        """The graph of a chunk that starts at ``state.step``, to be run
        once: its warm-up and its capture both run the chunk's steps from
        that step and from the optimizers' counts there, so the capture
        records the branches the warm-up took.  The warm-up's updates of
        each optimizer size the learning-rate slots of the capture."""
        chunk = _ChunkGraph()
        first, counts = state.step, dict(state.counts)

        def run(*batches):
            state.step, state.counts = first, dict(counts)
            return self._steps(state, batches)[1]

        @contextlib.contextmanager
        def capture_context():
            chunk.updates = {name: state.counts.get(name, 0) - counts.get(name, 0)
                             for name in self.optimizers.names()}
            chunk.slots = {name: torch.empty(chunk.updates[name], device=self.device)
                           for name in self.optimizers.scheduled() if chunk.updates[name]}
            self.optimizers.capture_lr_slots(chunk.slots)
            try:
                yield
            finally:
                self.optimizers.capture_lr_slots({})

        chunk.graph = StepGraph(run, (state.generator,), capture_context)
        return chunk

    # ------------------------------------------- the samplers' network call
    @property
    def ema_decay(self) -> float:
        return float(self.hparams.get("ema_decay") or 0.0)

    def ema_shadow(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA shadow of the network's parameters, by name, when the
        model keeps one (``ema_decay > 0``) and ``init_state`` made it."""
        if self.ema_decay > 0 and self.state is not None and "ema" in self.state.opt_states:
            return self.state.opt_states["ema"]
        return None

    def init_ema(self, state: TrainState, name: str) -> None:
        """With ``ema_decay > 0``: the shadow of ``modules[name]``'s
        parameters under ``state.opt_states["ema"]``, a copy of them."""
        if self.ema_decay > 0:
            self._ema_of = name
            state.opt_states["ema"] = {
                k: p.detach().clone() for k, p in self.modules[name].named_parameters()}

    def update_ema(self, state: TrainState, name: str) -> None:
        """``shadow = d * shadow + (1 - d) * params``, in place."""
        d = self.ema_decay
        if d <= 0:
            return
        ema = state.opt_states["ema"]
        params = dict(self.modules[name].named_parameters())
        with torch.no_grad():
            shadow = list(ema.values())
            torch._foreach_mul_(shadow, d)
            torch._foreach_add_(shadow, [params[k] for k in ema], alpha=1.0 - d)

    def network(self, name: str, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``modules[name](x, t, y)`` with the EMA shadow's weights when
        there is one; on the card outside autograd a CUDA graph per input
        signature."""
        ema = self.ema_shadow()
        if not (self.use_graphs and x.is_cuda and not torch.is_grad_enabled()):
            return self._network_eager(name, ema, x, t, y)
        inputs = (x, t) if y is None else (x, t, y)
        key = (name, id(ema), tuple((tuple(a.shape), a.dtype) for a in inputs))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(
                lambda x, t, y=None: self._network_eager(name, ema, x, t, y))
        return graph(*inputs)

    def _network_eager(self, name: str, ema, x, t, y) -> torch.Tensor:
        net = self.modules[name]
        if ema is not None:
            return torch.func.functional_call(net, ema, (x, t, y))
        return net(x, t, y)

    def on_fit_start(self, state: TrainState, train_arrays) -> TrainState:
        """Run once after ``init_state``, before a resume restores a
        checkpoint (so a checkpointed value wins), with the training split's
        host arrays.  Default: identity."""
        return state

    def on_restore(self, state: TrainState) -> TrainState:
        """Run after a checkpoint restore, before training resumes.
        Default: identity."""
        return state

    def on_train_epoch_end(self, trainer) -> None:
        """Host-side hook, called after each training epoch."""
