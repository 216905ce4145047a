"""MLP and MNIST-size DCGAN networks, NHWC: counterpart of
``igm_tpu/networks/basic.py``.

Constructor arguments are ``igm_tpu``'s (the configs' ``_target_`` swaps
are drop-in); submodules carry the names Flax gives the same modules
(``LinearAct_0/Dense_0``, ``Norm_1/BatchNorm_0``, ``Conv_2``,
``ConvTranspose_3``), so ``igm_tpu_torch.interop`` maps a Flax path onto
the ``state_dict``.  ``forward(x, train)`` takes the mode explicitly, as
``igm_tpu``'s ``__call__`` does; ``return_features`` adds the features
before the last layer as a second output.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .base import BaseNetwork, Conv, ConvTranspose, Dense, Norm, get_act_function


class LinearAct(nn.Module):
    """fc -> norm -> act -> dropout.  A dropout rate above 0 in train mode
    raises: ``igm_tpu``'s models pass no dropout key, so no path of theirs
    runs it."""

    def __init__(self, in_features: int, features: int, act: str = "relu",
                 dropout: float = 0.0, norm_type: Optional[str] = "batch"):
        super().__init__()
        self.act, self.dropout = act, float(dropout or 0.0)
        self.Dense_0 = Dense(in_features, features)
        self.Norm_0 = Norm(norm_type, features)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = get_act_function(self.act)(self.Norm_0(self.Dense_0(x), train))
        if self.dropout > 0 and train:
            raise NotImplementedError("LinearAct: dropout in train mode (igm_tpu's "
                                      "models give it no key)")
        return x


class MLPEncoder(BaseNetwork):
    """Flattened image -> hidden_dims (leaky ReLU; the first layer
    layer-normed, the rest ``norm_type``) -> ``output_channel``."""

    def __init__(self, input_channel: int, output_channel: int,
                 hidden_dims: Sequence[int] = (256,), width: int = 1, height: int = 1,
                 dropout: float = 0.0, norm_type: Optional[str] = "batch",
                 return_features: bool = False, output_act: str = "identity"):
        super().__init__(input_channel, output_channel)
        self.return_features = bool(return_features)
        dims = [int(input_channel) * int(width) * int(height), *map(int, hidden_dims)]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"LinearAct_{i}", LinearAct(
                a, b, "leaky_relu", dropout, "layer" if i == 0 else norm_type))
        self.n_hidden = len(dims) - 1
        self.add_module(f"LinearAct_{self.n_hidden}",
                        LinearAct(dims[-1], output_channel, output_act, norm_type=None))

    def forward(self, x: torch.Tensor, train: bool = True):
        n = x.shape[0]
        x = x.reshape(n, -1)
        for i in range(self.n_hidden):
            x = getattr(self, f"LinearAct_{i}")(x, train)
        out = getattr(self, f"LinearAct_{self.n_hidden}")(x, train)
        return (out, x.reshape(n, -1)) if self.return_features else out


class MLPDecoder(BaseNetwork):
    """Latent -> hidden_dims (ReLU, ``norm_type``) -> an image of
    ``output_act``."""

    def __init__(self, input_channel: int, output_channel: int,
                 hidden_dims: Sequence[int] = (256,), width: int = 1, height: int = 1,
                 output_act: str = "tanh", norm_type: Optional[str] = "batch"):
        super().__init__(input_channel, output_channel)
        self.width, self.height = int(width), int(height)
        dims = [int(input_channel), *map(int, hidden_dims)]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"LinearAct_{i}", LinearAct(a, b, "relu", norm_type=norm_type))
        self.n_hidden = len(dims) - 1
        self.add_module(f"LinearAct_{self.n_hidden}", LinearAct(
            dims[-1], output_channel * self.width * self.height, output_act, norm_type=None))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        for i in range(self.n_hidden + 1):
            x = getattr(self, f"LinearAct_{i}")(x, train)
        return x.reshape(-1, self.height, self.width, self.output_channel)


class ConvDecoder(BaseNetwork):
    """28x28 DCGAN decoder: 1 -> 4 -> 7 -> 14 -> 28."""

    LAYERS = ((4, 4, 1, 0), (2, 3, 2, 1), (1, 4, 2, 1))    # (ngf multiple, k, s, p)

    def __init__(self, input_channel: int, output_channel: int, ngf: int = 32,
                 norm_type: Optional[str] = "batch", output_act: str = "tanh"):
        super().__init__(input_channel, output_channel)
        self.output_act = output_act
        build_decoder(self, input_channel, output_channel, ngf, norm_type, self.LAYERS)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return decode(self, x, train)


class ConvEncoder(BaseNetwork):
    """28x28 DCGAN encoder, the mirror of :class:`ConvDecoder`."""

    def __init__(self, input_channel: int, output_channel: int, ndf: int = 32,
                 norm_type: Optional[str] = "batch", return_features: bool = False):
        super().__init__(input_channel, output_channel)
        self.return_features = bool(return_features)
        self.Conv_0 = Conv(input_channel, ndf, 4, 2, 1)
        self.Conv_1 = Conv(ndf, ndf * 2, 4, 2, 1)
        self.Norm_0 = Norm(norm_type, ndf * 2)
        self.Conv_2 = Conv(ndf * 2, ndf * 4, 3, 2, 1)
        self.Norm_1 = Norm(norm_type, ndf * 4)
        self.Conv_3 = Conv(ndf * 4, output_channel, 4, 1, 0)

    def forward(self, x: torch.Tensor, train: bool = True):
        n = x.shape[0]
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        x = F.leaky_relu(self.Norm_0(self.Conv_1(x), train), 0.2)
        features = F.leaky_relu(self.Norm_1(self.Conv_2(x), train), 0.2)
        out = self.Conv_3(features).reshape(n, self.output_channel)
        return (out, features.reshape(n, -1)) if self.return_features else out


def build_decoder(net: nn.Module, input_channel: int, output_channel: int, ngf: int,
                  norm_type, layers) -> None:
    """A DCGAN decoder's modules on ``net``: per entry of ``layers`` (ngf
    multiple, kernel, stride, padding) a ``ConvTranspose_i`` and a
    ``Norm_i``, then the last ``ConvTranspose`` (4, 2, 1) to
    ``output_channel``."""
    c = input_channel
    for i, (mult, k, s, p) in enumerate(layers):
        net.add_module(f"ConvTranspose_{i}", ConvTranspose(c, ngf * mult, k, s, p))
        net.add_module(f"Norm_{i}", Norm(norm_type, ngf * mult))
        c = ngf * mult
    net.n_up = len(layers)
    net.add_module(f"ConvTranspose_{net.n_up}", ConvTranspose(c, output_channel, 4, 2, 1))


def decode(net: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The forward of a :func:`build_decoder` network: the latent as a 1x1
    image, (ConvTranspose, Norm, ReLU) per layer, the last ConvTranspose and
    ``output_act``."""
    x = x.reshape(x.shape[0], 1, 1, -1)
    for i in range(net.n_up):
        x = F.relu(getattr(net, f"Norm_{i}")(getattr(net, f"ConvTranspose_{i}")(x), train))
    x = getattr(net, f"ConvTranspose_{net.n_up}")(x)
    return get_act_function(net.output_act)(x)
