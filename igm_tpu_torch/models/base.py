"""BaseModel: the part of ``igm_tpu/models/base.py`` the sampling path needs.

A model holds its networks in ``self.modules`` (a ``torch.nn.ModuleDict``
on ``self.device``) with the parameters inside them, where ``igm_tpu``
keeps them in a TrainState; ``hparams`` and ``preprocess`` are as there.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..config.node import ConfigNode
from ..utils.platform import resolve_device


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

    def preprocess(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> float in [0,1] (convert) or [-1,1] (normalize), on
        the model's device."""
        x = imgs.to(self.device, non_blocking=True).float()
        if self.input_convert:
            x = x / 255.0
        if self.input_normalize:
            x = x * 2.0 - 1.0
        return x
