"""32x32 DCGAN decoder and encoder, NHWC: counterpart of
``igm_tpu/networks/conv32.py`` (Flax's submodule names, as
``networks/basic.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .base import BaseNetwork, Conv, Norm
from .basic import build_decoder, decode


class Decoder(BaseNetwork):
    """latent -> 2x2 -> 4 -> 8 -> 16 -> 32."""

    LAYERS = ((8, 2, 1, 0), (4, 4, 2, 1), (2, 4, 2, 1), (1, 4, 2, 1))

    def __init__(self, input_channel: int, output_channel: int, ngf: int = 32,
                 norm_type: Optional[str] = "batch", output_act: str = "tanh"):
        super().__init__(input_channel, output_channel)
        self.output_act = output_act
        build_decoder(self, input_channel, output_channel, ngf, norm_type, self.LAYERS)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return decode(self, x, train)


class Encoder(BaseNetwork):
    """32 -> 16 -> 8 -> 4 -> 2 -> 1x1 logits; ``last_kernel`` is 2 here, 4 in
    ``conv64``."""

    last_kernel = 2

    def __init__(self, input_channel: int, output_channel: int, ndf: int = 32,
                 norm_type: Optional[str] = "batch", return_features: bool = False):
        super().__init__(input_channel, output_channel)
        self.return_features = bool(return_features)
        self.Conv_0 = Conv(input_channel, ndf, 4, 2, 1)
        for i, mult in enumerate((2, 4, 8)):
            self.add_module(f"Conv_{i + 1}", Conv(ndf * mult // 2, ndf * mult, 4, 2, 1))
            self.add_module(f"Norm_{i}", Norm(norm_type, ndf * mult))
        self.Conv_4 = Conv(ndf * 8, output_channel, self.last_kernel, 1, 0)

    def forward(self, x: torch.Tensor, train: bool = True):
        n = x.shape[0]
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        x = F.leaky_relu(self.Norm_0(self.Conv_1(x), train), 0.2)
        features = F.leaky_relu(self.Norm_1(self.Conv_2(x), train), 0.2)
        x = F.leaky_relu(self.Norm_2(self.Conv_3(features), train), 0.2)
        out = self.Conv_4(x).reshape(n, -1)
        return (out, features.reshape(n, -1)) if self.return_features else out
