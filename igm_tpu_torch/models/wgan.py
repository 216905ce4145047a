"""WGAN with weight clipping: counterpart of ``igm_tpu/models/wgan.py``.

RMSprop (``core.optim.rmsprop``: optax's formula) for ``netG`` (``g``) and
``netD`` (``d``).  Every step first clamps ``netD``'s parameters to
+-``clip_weight`` in place, in both branches; the step then takes the G
branch when ``state.step % (n_critic + 1) == 0`` and the D branch (the
critic) otherwise (``phase_period = n_critic + 1``).  The losses are the
critic's means: G ``-D(G(z))``, D ``-D(x) + D(G(z))`` with the fakes
detached; the BatchNorms move their statistics in the order of
``igm_tpu``'s branches (as :mod:`.gan`).  ``eval_fid`` is accepted and kept
as a hyperparameter, as there.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, clip_params, rmsprop
from ..core.state import TrainState
from .base import BaseModel, ValidationResult
from .gan import nan_metrics


class WGAN(BaseModel):
    weights_module = "netG"
    decoder_module_name = "netG"

    def __init__(self, datamodule: Any, netG: Any, netD: Any, latent_dim: int = 100,
                 n_critic: int = 5, clip_weight: float = 0.01, lrG: float = 5e-5,
                 lrD: float = 5e-5, alpha: float = 0.99, eval_fid: bool = False,
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, n_critic=n_critic,
                                  clip_weight=clip_weight, lrG=lrG, lrD=lrD, alpha=alpha,
                                  eval_fid=eval_fid)
        self.phase_period = int(n_critic) + 1
        self.modules = nn.ModuleDict({
            "netG": instantiate(netG, input_channel=latent_dim, output_channel=self.channels),
            "netD": instantiate(netD, input_channel=self.channels, output_channel=1)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("g", rmsprop(hp.lrG, hp.alpha), ["netG"])
                           .add("d", rmsprop(hp.lrD, hp.alpha), ["netD"]))
        self.state = self.make_state(seed)
        return self.state

    def g_loss(self, z: torch.Tensor):
        g_loss = -self.modules["netD"](self.modules["netG"](z, True), True).mean()
        return g_loss, {"train_loss/g_loss": g_loss.detach(),
                        **nan_metrics(z.device, "train_loss/d_loss", "train_log/real_logit",
                                      "train_log/fake_logit")}

    def d_loss(self, imgs: torch.Tensor, z: torch.Tensor):
        net_d = self.modules["netD"]
        real_loss = -net_d(imgs, True).mean()
        with torch.no_grad():
            fake = self.modules["netG"](z, True)
        fake_loss = net_d(fake, True).mean()
        d_loss = real_loss + fake_loss
        return d_loss, {"train_loss/d_loss": d_loss.detach(),
                        "train_log/real_logit": -real_loss.detach(),
                        "train_log/fake_logit": fake_loss.detach(),
                        **nan_metrics(z.device, "train_loss/g_loss")}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim)) replaces the draw."""
        imgs = self.preprocess(batch[0])
        if z is None:
            z = self.latent_noise(imgs.shape[0], state.generator)
        clip_params(self.modules["netD"], self.hparams.clip_weight)
        if state.step % self.phase_period == 0:
            state, _, metrics = self.optimizers.grad_step(state, "g", lambda: self.g_loss(z))
        else:
            state, _, metrics = self.optimizers.grad_step(state, "d",
                                                          lambda: self.d_loss(imgs, z))
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        return ValidationResult(real_image=imgs,
                                fake_image=self.sample(imgs.shape[0], generator)), {}
