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

``train_step_n`` is the counterpart of ``igm_tpu``'s (``base.py:111-128``,
K steps in one ``lax.scan``): K train steps on ``[k, ...]`` batches, the
metrics the per-key nan-mean over the chunk.  On a CUDA device with
``use_graphs`` (the default) one execution is one CUDA graph launch: the K
steps are captured together into one graph (``core.graphs.StepGraph``),
one per chunk length and batch layout, kept in ``state.graphs``.  The
first execution of a signature runs eagerly and is then captured; later
ones replay it.  A scheduled learning rate is written for the K steps into
a device vector before each launch (one ``fill_`` a value).  On the CPU, or with ``graph=False``
or ``use_graphs = False``, it runs the K steps eagerly.  A model's
``train_step`` must therefore make every draw from ``state.generator``,
touch device state only in place, and change nothing on the host but
``state.step``.
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
from ..utils.platform import resolve_device


def merge_metrics(per_step):
    """The per-key nan-mean of a list of metric dicts (scalar tensors), as
    ``igm_tpu`` merges a chunk's metrics: a key that is NaN on some steps
    (a phase that did not run) averages over the others."""
    if len(per_step) == 1:
        return dict(per_step[0])
    return {k: torch.stack([m[k] for m in per_step]).nanmean(dim=0) for k in per_step[0]}


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

    def __init__(self, datamodule: Any, device: str | torch.device | None = None):
        self.width = int(datamodule["width"])
        self.height = int(datamodule["height"])
        self.channels = int(datamodule["channels"])
        transforms = datamodule.get("transforms") or {}
        self.input_normalize = bool(transforms.get("normalize", False))
        self.input_convert = bool(transforms.get("convert", False))
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

    def save_hyperparameters(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            self.hparams[k] = v

    def init_params(self, seed: int) -> None:
        """Draw every parameter afresh from ``seed`` (torch-parity init).
        The draws run on the CPU, so a seed gives the same weights on every
        device."""
        generator = torch.Generator().manual_seed(int(seed))
        self._graphs.clear()            # the move below gives new tensors
        self.modules.to("cpu")
        for module in self.modules.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.modules.to(self.device)

    def make_state(self, seed: int) -> TrainState:
        """Parameters drawn from ``seed``, fresh optimizer states, and the
        training generator on the model's device seeded with ``seed + 1``."""
        self.init_params(seed)
        generator = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        return TrainState(modules=self.modules,
                          opt_states=self.optimizers.init(self.modules),
                          generator=generator)

    def preprocess(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> float in [0,1] (convert) or [-1,1] (normalize), on
        the model's device."""
        x = imgs.to(self.device, non_blocking=True).float()
        if self.input_convert:
            x = x / 255.0
        if self.input_normalize:
            x = x * 2.0 - 1.0
        return x

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
        """The K eager train steps of a chunk and their merged metrics."""
        per_step = []
        for i in range(len(batches[0])):
            state, metrics = self.train_step(state, tuple(b[i] for b in batches))
            per_step.append(metrics)
        return state, merge_metrics(per_step)

    def train_step_n(self, state: TrainState, batches, graph: bool = True):
        """K train steps on ``batches``, a tuple of ``[k, B, ...]`` tensors
        on the model's device -> (state, the nan-mean of their metrics)."""
        k = len(batches[0])
        if not (graph and self.use_graphs and self.device.type == "cuda"):
            return self._steps(state, batches)
        key = ("train_step_n", k, tuple((tuple(b.shape), b.dtype) for b in batches))
        if key not in state.graphs:
            slots = {name: torch.empty(k, device=self.device)
                     for name in self.optimizers.scheduled()}

            @contextlib.contextmanager
            def capture_context():
                self.optimizers.capture_lr_slots(slots)
                try:
                    yield
                finally:
                    self.optimizers.capture_lr_slots({})

            state.graphs[key] = (StepGraph(lambda *b: self._steps(state, b)[1],
                                           (state.generator,), capture_context), slots)
        step_graph, slots = state.graphs[key]
        for name, slot in slots.items():     # one fill a value: no host memory to wait for
            tx = self.optimizers.tx(name)
            for i in range(k):
                slot[i].fill_(tx.lr_at(state.step + i))
        first = state.step
        metrics = step_graph(*batches)
        state.step = first + k
        return state, metrics

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
