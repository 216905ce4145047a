"""GAN / LSGAN / GGAN-hinge: counterpart of ``igm_tpu/models/gan.py``.

Two Adam optimizers, ``g`` over ``netG`` and ``d`` over ``netD``; the step
takes the G branch when ``state.step % 2 == 0`` and the D branch
otherwise, as ``igm_tpu``'s ``lax.cond`` does (``phase_period = 2``: a
graphed chunk is kept per starting phase).  The branch that does not run
reports its metrics as NaN, which the chunk's nan-mean and the logger
skip.

- G: ``netG(z)`` then ``netD`` on the fakes, the generator's adversarial
  loss; gradients with respect to ``netG`` alone.
- D: ``netD`` on the real images, ``netG(z)`` (no gradient: the fakes are
  detached), then ``netD`` on the fakes.

The BatchNorms move their statistics in that order, in place.  ``z`` is
drawn from ``state.generator`` on every step, in both branches, unless
given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..utils.losses import adversarial_loss
from .base import BaseModel, ValidationResult


def nan_metrics(device, *keys: str) -> Dict[str, torch.Tensor]:
    """The metrics of a branch that did not run: NaN scalars on ``device``."""
    return {k: torch.full((), float("nan"), device=device) for k in keys}


class GAN(BaseModel):
    weights_module = "netG"
    decoder_module_name = "netG"
    phase_period = 2

    def __init__(self, datamodule: Any, netG: Any, netD: Any, latent_dim: int = 100,
                 loss_mode: str = "vanilla", lrG: float = 2e-4, lrD: float = 2e-4,
                 b1: float = 0.5, b2: float = 0.999, device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, loss_mode=loss_mode, lrG=lrG,
                                  lrD=lrD, b1=b1, b2=b2)
        self.modules = nn.ModuleDict({
            "netG": instantiate(netG, input_channel=latent_dim, output_channel=self.channels),
            "netD": instantiate(netD, input_channel=self.channels, output_channel=1)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("g", adam(hp.lrG, hp.b1, hp.b2), ["netG"])
                           .add("d", adam(hp.lrD, hp.b1, hp.b2), ["netD"]))
        self.state = self.make_state(seed)
        return self.state

    def g_loss(self, z: torch.Tensor):
        fake = self.modules["netG"](z, True)
        g_loss = adversarial_loss(self.modules["netD"](fake, True), True, self.hparams.loss_mode)
        return g_loss, {"train_loss/g_loss": g_loss.detach(),
                        **nan_metrics(z.device, "train_loss/d_loss", "train_log/pred_real",
                                      "train_log/pred_fake")}

    def d_loss(self, imgs: torch.Tensor, z: torch.Tensor):
        mode, net_d = self.hparams.loss_mode, self.modules["netD"]
        pred_real = net_d(imgs, True)
        with torch.no_grad():
            fake = self.modules["netG"](z, True)
        pred_fake = net_d(fake, True)
        d_loss = (adversarial_loss(pred_real, True, mode)
                  + adversarial_loss(pred_fake, False, mode)) / 2.0
        return d_loss, {"train_loss/d_loss": d_loss.detach(),
                        "train_log/pred_real": pred_real.mean().detach(),
                        "train_log/pred_fake": pred_fake.mean().detach(),
                        **nan_metrics(z.device, "train_loss/g_loss")}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim)) replaces the draw."""
        imgs = self.preprocess(batch[0])
        if z is None:
            z = self.latent_noise(imgs.shape[0], state.generator)
        if state.step % 2 == 0:
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
