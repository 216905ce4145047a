"""RealNVP, the affine-coupling normalizing flow: counterpart of
``igm_tpu/models/realnvp.py``.

Uniform dequantisation and the logit transform (``alpha``), then the
multi-scale stack: ``check1_<i>`` checkerboard couplings, a squeeze
(H, W, C) -> (H/2, W/2, 4C), ``chan_<i>`` channel couplings and
``check2_<i>`` checkerboard couplings at half resolution; ``inverse`` runs
them backwards.  Exact bits/dim: ``-(log N(z) + logdets) / (D ln 2) + 8``.
Each coupling's (s, t) net (``CouplingNet``) is two of the port's ``Conv``
(``Conv_0`` 3x3, ``Conv_1`` 1x1, ReLU) and a zero-initialised 3x3
``Conv_2``, so the flow starts as the identity; ``log s = s_scale *
tanh(raw_s)``.  Module names are Flax's, so ``igm_tpu_torch.interop``
carries an ``igm_tpu`` tree over.

Training clips the gradients by their global norm (optax's rule, not
``clip_grad_norm_``) ahead of Adam(b1, b2).  The dequantisation noise ``u``
(train and validation) and the sampler's ``z`` are drawn from the given
generator, or given.  On the card the sampler's inverse pass replays a CUDA
graph per batch size (``use_graphs``), which follows the parameters in
place.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.base import Conv
from .base import BaseModel, ValidationResult

LOG2 = math.log(2.0)


def squeeze(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), space to depth."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * 2, w * 2, c)


class _ZeroConv(Conv):
    """Flax's ``nn.Conv`` with zero kernel and bias (``Conv_2``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.zero_()


class CouplingNet(nn.Module):
    """(s, t) of the masked input: zero at init."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.Conv_0 = Conv(channels, hidden, 3, padding=1)
        self.Conv_1 = Conv(hidden, hidden, 1)
        self.Conv_2 = _ZeroConv(hidden, 2 * channels, 3, padding=1)
        self.s_scale = nn.Parameter(torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.s_scale.fill_(1.0)

    def forward(self, x: torch.Tensor):
        h = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        raw_s, t = self.Conv_2(h).chunk(2, dim=-1)
        return self.s_scale * torch.tanh(raw_s), t


class AffineCoupling(nn.Module):
    """One masked affine coupling; ``parity`` flips the conditioning half."""

    def __init__(self, channels: int, hidden: int, mask_type: str, parity: int):
        super().__init__()
        self.mask_type, self.parity = mask_type, parity
        self.net = CouplingNet(channels, hidden)

    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        if self.mask_type == "check":
            hh = torch.arange(h, device=x.device).reshape(1, h, 1, 1)
            ww = torch.arange(w, device=x.device).reshape(1, 1, w, 1)
            return ((hh + ww + self.parity) % 2).to(x.dtype)
        half = (torch.arange(c, device=x.device) < c // 2).to(x.dtype)
        return (half if self.parity == 0 else 1.0 - half).reshape(1, 1, 1, c)

    def forward(self, x: torch.Tensor):
        b = self._mask(x)
        log_s, t = self.net(x * b)
        log_s = log_s * (1.0 - b)
        t = t * (1.0 - b)
        z = x * b + (1.0 - b) * (x * torch.exp(log_s) + t)
        return z, log_s.sum(dim=(1, 2, 3))

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        b = self._mask(z)
        log_s, t = self.net(z * b)
        log_s = log_s * (1.0 - b)
        t = t * (1.0 - b)
        return z * b + (1.0 - b) * (z - t) * torch.exp(-log_s)


class RealNVPFlow(nn.Module):
    """Data space -> latent (``forward``, with the summed logdet) and back
    (``inverse``)."""

    def __init__(self, channels: int, hidden: int = 64, n_check: int = 3, n_chan: int = 3,
                 n_final: int = 3):
        super().__init__()
        self.counts = (n_check, n_chan, n_final)
        for i in range(n_check):
            self.add_module(f"check1_{i}", AffineCoupling(channels, hidden, "check", i % 2))
        for i in range(n_chan):
            self.add_module(f"chan_{i}", AffineCoupling(4 * channels, hidden, "chan", i % 2))
        for i in range(n_final):
            self.add_module(f"check2_{i}", AffineCoupling(4 * channels, hidden, "check", i % 2))

    def _group(self, name: str, n: int):
        return [getattr(self, f"{name}_{i}") for i in range(n)]

    def forward(self, x: torch.Tensor):
        n_check, n_chan, n_final = self.counts
        logdet = x.new_zeros(x.shape[0])
        for c in self._group("check1", n_check):
            x, ld = c(x)
            logdet = logdet + ld
        x = squeeze(x)
        for c in self._group("chan", n_chan) + self._group("check2", n_final):
            x, ld = c(x)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        n_check, n_chan, n_final = self.counts
        for c in (self._group("check2", n_final)[::-1] + self._group("chan", n_chan)[::-1]):
            z = c.inverse(z)
        z = unsqueeze(z)
        for c in self._group("check1", n_check)[::-1]:
            z = c.inverse(z)
        return z


class RealNVP(BaseModel):
    weights_module = "flow"

    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 n_couplings: Sequence[int] = (3, 3, 3), lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, alpha: float = 0.05, sample_batch: int = 64,
                 grad_clip: float = 50.0, device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s RealNVP, plus ``device``
        (the card unless the CPU is asked for)."""
        super().__init__(datamodule, device)
        if self.height % 2 or self.width % 2:
            raise ValueError("RealNVP squeeze needs even H and W "
                             f"(got {self.height}x{self.width})")
        nc = [int(n) for n in n_couplings]
        self.save_hyperparameters(hidden_dim=hidden_dim, n_couplings=nc, lr=lr, b1=b1, b2=b2,
                                  alpha=alpha, sample_batch=sample_batch, grad_clip=grad_clip)
        self.modules = nn.ModuleDict({"flow": RealNVPFlow(
            self.channels, int(hidden_dim), n_check=nc[0], n_chan=nc[1], n_final=nc[2])})
        self.dims = self.height * self.width * self.channels
        self.init_params(0)

    @property
    def flow(self) -> RealNVPFlow:
        return self.modules["flow"]

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = OptimizerSet().add(
            "opt", adam(hp.lr, hp.b1, hp.b2, clip_norm=float(hp.grad_clip)), ["flow"])
        self.state = self.make_state(seed)
        return self.state

    # ----------------------------------------------------------- data <-> z0
    def _to_unit(self, imgs_raw: torch.Tensor) -> torch.Tensor:
        """Model-input space -> [0, 1] pixel space (before dequantisation)."""
        x = self.preprocess(imgs_raw)
        return (x + 1.0) / 2.0 if self.input_normalize else x

    def _logit_forward(self, y: torch.Tensor):
        """Dequantised y in (0, 1) -> logit space, with the per-sample logdet."""
        a = float(self.hparams.alpha)
        q = a + (1.0 - 2.0 * a) * y
        z0 = torch.log(q) - torch.log1p(-q)
        logdet = (math.log(1.0 - 2.0 * a) - torch.log(q) - torch.log1p(-q)).sum(dim=(1, 2, 3))
        return z0, logdet

    def _logit_inverse(self, z0: torch.Tensor) -> torch.Tensor:
        a = float(self.hparams.alpha)
        return torch.clamp((torch.sigmoid(z0) - a) / (1.0 - 2.0 * a), 0.0, 1.0)

    def bpd(self, imgs_raw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Exact dequantised bits/dim with the noise ``u`` (the batch's
        shape, uniform in [0, 1))."""
        y = (self._to_unit(imgs_raw) * 255.0 + u) / 256.0
        z0, ld_pre = self._logit_forward(y)
        z, ld_flow = self.flow(z0)
        log_prior = -0.5 * (z ** 2 + math.log(2.0 * math.pi)).sum(dim=(1, 2, 3))
        return (-(log_prior + ld_flow + ld_pre) / (self.dims * LOG2) + 8.0).mean()

    def _noise(self, imgs_raw, generator) -> torch.Tensor:
        return self.batch_draw(torch.rand, imgs_raw.shape, generator)

    # ------------------------------------------------------------------ train
    def train_step(self, state: TrainState, batch, u: Optional[torch.Tensor] = None):
        """One clipped Adam step; ``u`` replaces the dequantisation draw from
        ``state.generator``."""
        imgs_raw, _ = batch
        if u is None:
            u = self._noise(imgs_raw, state.generator)

        def loss_fn():
            bpd = self.bpd(imgs_raw, u)
            return bpd, {"train_bpd": bpd.detach()}

        state, _, metrics = self.optimizers.grad_step(state, "opt", loss_fn)
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, H, W, C) images in model space: one inverse pass of N(0, I)
        latents ``z`` (n, H/2, W/2, 4C), drawn from ``generator`` when not
        given; on the card a CUDA graph per batch (``use_graphs``)."""
        if z is None:
            z = self.batch_draw(torch.randn,
                                (n, self.height // 2, self.width // 2, 4 * self.channels),
                                generator)
        return self.graphed("sample", self._decode, z)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        y = self._logit_inverse(self.flow.inverse(z))
        return y * 2.0 - 1.0 if self.input_normalize else y

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        """bpd with a fresh dequantisation draw; with ``sample``
        ``sample_batch`` samples."""
        imgs_raw, _ = batch
        bpd = self.bpd(imgs_raw, self._noise(imgs_raw, generator))
        result = ValidationResult(real_image=self.preprocess(imgs_raw))
        if sample:
            result.fake_image = self.sample(int(self.hparams.sample_batch), generator)
        return result, {"val_bpd": bpd}
