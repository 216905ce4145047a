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
  validation_step(state, batch, generator,
                  sample=False)                  -> (ValidationResult, metrics)
  on_restore(state), on_train_epoch_end(trainer)
Metrics are dicts of scalar tensors, fetched by the trainer when it logs.

``train_step_n`` (the ``lax.scan`` chain of ``igm_tpu``) is not ported: the
trainer runs one step per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config.node import ConfigNode
from ..core.optim import OptimizerSet
from ..core.state import TrainState
from ..utils.platform import resolve_device


@dataclasses.dataclass
class ValidationResult:
    others: Dict[str, Any] = dataclasses.field(default_factory=dict)
    real_image: Any = None
    fake_image: Any = None
    recon_image: Any = None
    label: Any = None
    encode_latent: Any = None


class BaseModel:
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

    def save_hyperparameters(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            self.hparams[k] = v

    def init_params(self, seed: int) -> None:
        """Draw every parameter afresh from ``seed`` (torch-parity init).
        The draws run on the CPU, so a seed gives the same weights on every
        device."""
        generator = torch.Generator().manual_seed(int(seed))
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

    def on_restore(self, state: TrainState) -> TrainState:
        """Run after a checkpoint restore, before training resumes.
        Default: identity."""
        return state

    def on_train_epoch_end(self, trainer) -> None:
        """Host-side hook, called after each training epoch."""
