"""Adversarial autoencoder: counterpart of ``igm_tpu/models/aae.py``.

Three updates a step, in order:

1. reconstruction (``g``: encoder and decoder): ``recon_weight`` times the
   mean squared error of ``decoder(encoder(x))``;
2. the latent discriminator (``d``): prior draws as real, the encoder's
   latents (after update 1, detached) as fake;
3. the encoder's adversarial loss (``g`` again: its second update of the
   step, and Adam's bias correction counts it; the decoder's gradient is
   0).

The encoder's BatchNorms move in each of the three.  The discriminator is
an MLP on the latents (256-256, layer norm) whatever the ``netD`` config
says: it is accepted and ignored, as ``igm_tpu`` ignores it
(``aae.py:41-43``).  The prior is N(0, I) or, with ``prior="toy_gmm"``,
the 10-component circle :class:`~igm_tpu_torch.utils.toy.ToyGMM` (a 2-d
latent).  Its draws come from ``state.generator`` unless given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.basic import MLPEncoder
from ..utils.losses import adversarial_loss
from ..utils.toy import ToyGMM
from .base import BaseModel, ValidationResult


class AAE(BaseModel):
    weights_module = "decoder"

    def __init__(self, datamodule: Any, encoder: Any, decoder: Any, netD: Any = None,
                 latent_dim: int = 100, loss_mode: str = "vanilla", lrG: float = 2e-4,
                 lrD: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
                 recon_weight: float = 1, prior: str = "normal",
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, loss_mode=loss_mode, lrG=lrG,
                                  lrD=lrD, b1=b1, b2=b2, recon_weight=recon_weight,
                                  prior=prior)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=latent_dim),
            "discriminator": MLPEncoder(input_channel=latent_dim, output_channel=1,
                                        hidden_dims=[256, 256], width=1, height=1,
                                        norm_type="layer")})
        self._gmm = ToyGMM(10) if prior == "toy_gmm" else None
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("g", adam(hp.lrG, hp.b1, hp.b2), ["encoder", "decoder"])
                           .add("d", adam(hp.lrD, hp.b1, hp.b2), ["discriminator"]))
        self.state = self.make_state(seed)
        return self.state

    def sample_prior(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self._gmm is not None:
            return self._gmm.sample(n, generator, self.device)[0]
        return self.latent_noise(n, generator)

    def recon_loss(self, imgs: torch.Tensor):
        recon = self.modules["decoder"](self.modules["encoder"](imgs, True), True)
        loss = torch.mean((imgs - recon.reshape(imgs.shape)) ** 2)
        return loss * self.hparams.recon_weight, {"train_loss/recon_loss": loss.detach()}

    def d_loss(self, imgs: torch.Tensor, real_prior: torch.Tensor):
        mode, disc = self.hparams.loss_mode, self.modules["discriminator"]
        real_logit = disc(real_prior, True)
        with torch.no_grad():
            q_z = self.modules["encoder"](imgs, True)
        fake_logit = disc(q_z, True)
        d_loss = (adversarial_loss(real_logit, True, mode)
                  + adversarial_loss(fake_logit, False, mode)) / 2.0
        return d_loss, {"train_loss/d_loss": d_loss.detach(),
                        "train_log/real_logit": real_logit.mean().detach(),
                        "train_log/fake_logit": fake_logit.mean().detach()}

    def g_adv_loss(self, imgs: torch.Tensor):
        logit = self.modules["discriminator"](self.modules["encoder"](imgs, True), True)
        g_adv = adversarial_loss(logit, True, self.hparams.loss_mode)
        return g_adv, {"train_loss/adv_encoder_loss": g_adv.detach()}

    def train_step(self, state: TrainState, batch, real_prior: Optional[torch.Tensor] = None):
        """``real_prior`` ((N, latent_dim)) replaces the prior draws."""
        imgs = self.preprocess(batch[0])
        if real_prior is None:
            real_prior = self.sample_prior(imgs.shape[0], state.generator)
        metrics = {}
        state, _, m = self.optimizers.grad_step(state, "g", lambda: self.recon_loss(imgs))
        metrics.update(m)
        state, _, m = self.optimizers.grad_step(state, "d",
                                                lambda: self.d_loss(imgs, real_prior))
        metrics.update(m)
        state, _, m = self.optimizers.grad_step(state, "g", lambda: self.g_adv_loss(imgs))
        metrics.update(m)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        z = self.modules["encoder"](imgs, False)
        recon = self.modules["decoder"](z, False).reshape(imgs.shape)
        sample_z = self.sample_prior(imgs.shape[0], generator)
        fake = self.modules["decoder"](sample_z, False).reshape(imgs.shape)
        return ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                label=batch[1], encode_latent=z), {}
