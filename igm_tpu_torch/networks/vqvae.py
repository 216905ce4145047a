"""VQ-VAE encoder and decoder, NHWC: counterpart of
``igm_tpu/networks/vqvae.py``.

Submodules carry the names Flax gives the same modules (``Conv_0``,
``ResidualStack_0/ResidualLayer_0/Conv_1``, ``ConvTranspose_2``, ...), so
``igm_tpu_torch.interop`` maps a Flax param path onto the ``state_dict`` key.

``ResidualStack(tied=True)``, the default, keeps the reference's quirk
(``[ResidualLayer(...)] * n``, ``igm_tpu/networks/vqvae.py:39-42``): ONE
``ResidualLayer`` is applied ``n_res_layers`` times, so all applications
share its parameters.  ``tied=False`` is the standard untied stack.  The
networks run in the dtype of their input (float32 on every path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .base import Conv, ConvTranspose


class ResidualLayer(nn.Module):
    """relu -> 3x3 conv -> relu -> 1x1 conv, both without bias, plus the
    residual."""

    def __init__(self, h_dim: int, res_h_dim: int):
        super().__init__()
        self.Conv_0 = Conv(h_dim, res_h_dim, 3, 1, 1, use_bias=False)
        self.Conv_1 = Conv(res_h_dim, h_dim, 1, 1, 0, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.Conv_0(F.relu(x))
        return x + self.Conv_1(F.relu(r))


class ResidualStack(nn.Module):
    def __init__(self, h_dim: int, res_h_dim: int, n_res_layers: int = 3,
                 tied: bool = True):
        super().__init__()
        self.n_res_layers, self.tied = int(n_res_layers), bool(tied)
        for i in range(1 if tied else self.n_res_layers):
            self.add_module(f"ResidualLayer_{i}", ResidualLayer(h_dim, res_h_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_res_layers):
            x = getattr(self, f"ResidualLayer_{0 if self.tied else i}")(x)
        return F.relu(x)


class Encoder(nn.Module):
    """Image (N, H, W, C) -> latent grid (N, H/4, W/4, output_channel)."""

    def __init__(self, input_channel: int, output_channel: int,
                 n_res_layers: int = 3, res_h_dim: int = 128):
        super().__init__()
        half = output_channel // 2
        self.Conv_0 = Conv(input_channel, half, 4, 2, 1)
        self.Conv_1 = Conv(half, output_channel, 4, 2, 1)
        self.Conv_2 = Conv(output_channel, output_channel, 3, 1, 1)
        self.ResidualStack_0 = ResidualStack(output_channel, res_h_dim,
                                             n_res_layers)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.ResidualStack_0(self.Conv_2(x))


class Decoder(nn.Module):
    """Latent grid (N, h, w, input_channel) -> image (N, 4h, 4w,
    output_channel)."""

    def __init__(self, input_channel: int, output_channel: int, h_dim: int = 128,
                 n_res_layers: int = 3, res_h_dim: int = 128):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(input_channel, h_dim, 3, 1, 1)
        self.ResidualStack_0 = ResidualStack(h_dim, res_h_dim, n_res_layers)
        self.ConvTranspose_1 = ConvTranspose(h_dim, h_dim // 2, 4, 2, 1)
        self.ConvTranspose_2 = ConvTranspose(h_dim // 2, output_channel, 4, 2, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.ResidualStack_0(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return self.ConvTranspose_2(x)
