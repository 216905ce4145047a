"""Adversarial generator-encoder: counterpart of ``igm_tpu/models/age.py``.

The encoder maps images onto the unit sphere (``norm_z``) and is trained
to tell real from generated images by the KL divergence of their latents'
batch gaussian from the prior (:func:`calculate_kl`); the decoder is
trained against it.  One encoder update (``e``) every ``1 + g_updates``
steps, on ``state.step % (1 + g_updates) == 0``, the decoder's (``g``) on
the others (``phase_period = 1 + g_updates``).  Each optimizer's learning
rate halves every ``drop_lr_epoch`` epochs of its own updates
(``halving_lr`` of its own count, as optax counts), so the two halve at
different steps.

- E: ``encoder(x)``, ``decoder(z)`` (detached), ``encoder`` on the fakes;
  ``real_kl - fake_kl + e_recon_x_weight * mse(x, decoder(encoder(x))) +
  e_recon_z_weight * (1 - cos(fake_z, z))``.
- G: ``decoder(z)``, ``encoder`` on the fakes; ``fake_kl +
  g_recon_z_weight * mse(fake_z, z) + g_recon_x_weight * mse(x,
  decoder(encoder(x)))``.

The reconstruction's decoder pass moves no statistics in either branch
(``frozen_stats``: ``igm_tpu`` drops them); every other pass moves its
network's, in the order above.  The branch that does not run reports its
metrics as NaN.  ``z`` is drawn from ``state.generator`` on every step
unless given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam, halving_lr
from ..core.state import TrainState
from ..networks.base import frozen_stats
from ..parallel.mesh import all_reduce_sum
from .base import BaseModel, ValidationResult
from .gan import nan_metrics

E_METRICS = ("train_loss/real_kl", "train_loss/fake_kl", "train_loss/total_e_loss",
             "train_log/real_mu", "train_log/real_var", "train_log/fake_mu",
             "train_log/fake_var")
G_METRICS = ("train_loss/g_recon_z", "train_loss/g_loss")


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-12)


def calculate_kl(samples: torch.Tensor, mesh=None):
    """KL(N(batch mean, batch variance) || N(0, 1)) averaged over the
    dimensions, with the unbiased variance; and the means of the batch mean
    and variance.  On a data-axis mesh the batch is the global one: the
    mean and the squared deviations summed over the ranks, the global n in
    ``n / (n - 1)``."""
    if mesh is None:
        n = samples.shape[0]
        mu = samples.mean(dim=0)
        var = samples.var(dim=0, unbiased=False) * (n / max(n - 1, 1))
    else:
        n = samples.shape[0] * mesh.world
        mu = all_reduce_sum(mesh, samples.sum(dim=0)) / n
        var = (all_reduce_sum(mesh, ((samples - mu) ** 2).sum(dim=0)) / n
               * (n / max(n - 1, 1)))
    kl = (mu ** 2 + var - torch.log(var)).mean() / 2.0
    return kl, mu.mean(), var.mean()


class AGE(BaseModel):
    weights_module = "decoder"

    def __init__(self, datamodule: Any, encoder: Any, decoder: Any, lrE: float = 2e-4,
                 lrG: float = 2e-4, latent_dim: int = 128, b1: float = 0.5, b2: float = 0.999,
                 e_recon_z_weight: float = 1000, e_recon_x_weight: float = 0,
                 g_recon_z_weight: float = 0, g_recon_x_weight: float = 10,
                 norm_z: bool = True, drop_lr_epoch: int = 20, g_updates: int = 2,
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(
            lrE=lrE, lrG=lrG, latent_dim=latent_dim, b1=b1, b2=b2,
            e_recon_z_weight=e_recon_z_weight, e_recon_x_weight=e_recon_x_weight,
            g_recon_z_weight=g_recon_z_weight, g_recon_x_weight=g_recon_x_weight,
            norm_z=norm_z, drop_lr_epoch=drop_lr_epoch, g_updates=g_updates)
        self.phase_period = 1 + int(g_updates)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=latent_dim)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp, spe = self.hparams, self.steps_per_epoch
        self.optimizers = (
            OptimizerSet()
            .add("e", adam(halving_lr(hp.lrE, hp.drop_lr_epoch, spe), hp.b1, hp.b2),
                 ["encoder"])
            .add("g", adam(halving_lr(hp.lrG, hp.drop_lr_epoch, spe), hp.b1, hp.b2),
                 ["decoder"]))
        self.state = self.make_state(seed)
        return self.state

    def _encode(self, imgs: torch.Tensor, train: bool) -> torch.Tensor:
        z = self.modules["encoder"](imgs, train).reshape(imgs.shape[0], -1)
        return _normalize(z) if self.hparams.norm_z else z

    def _recon(self, imgs: torch.Tensor, real_z: torch.Tensor) -> torch.Tensor:
        """mse(x, decoder(real_z)), the decoder's statistics left as they are."""
        with frozen_stats(self.modules["decoder"]):
            recon = self.modules["decoder"](real_z, True)
        return torch.mean((imgs - recon.reshape(imgs.shape)) ** 2)

    def e_loss(self, imgs: torch.Tensor, z: torch.Tensor):
        hp = self.hparams
        real_z = self._encode(imgs, True)
        real_kl, real_mu, real_var = calculate_kl(real_z, self.mesh)
        with torch.no_grad():
            fake_imgs = self.modules["decoder"](z, True).reshape(imgs.shape)
        fake_z = self._encode(fake_imgs, True)
        fake_kl, fake_mu, fake_var = calculate_kl(fake_z, self.mesh)
        total = real_kl - fake_kl
        if hp.e_recon_x_weight > 0:
            total = total + hp.e_recon_x_weight * self._recon(imgs, real_z)
        if hp.e_recon_z_weight > 0:
            cos = (fake_z * z).sum(-1) / torch.clamp(
                torch.linalg.vector_norm(fake_z, dim=-1) * torch.linalg.vector_norm(z, dim=-1),
                min=1e-12)
            total = total + hp.e_recon_z_weight * (1.0 - cos.mean())
        values = (real_kl, fake_kl, total, real_mu, real_var, fake_mu, fake_var)
        return total, {**{k: v.detach() for k, v in zip(E_METRICS, values)},
                       **nan_metrics(z.device, *G_METRICS)}

    def g_loss(self, imgs: torch.Tensor, z: torch.Tensor):
        hp = self.hparams
        fake_imgs = self.modules["decoder"](z, True).reshape(imgs.shape)
        fake_z = self._encode(fake_imgs, True)
        fake_kl, _, _ = calculate_kl(fake_z, self.mesh)
        recon_z = torch.zeros((), device=z.device)
        if hp.g_recon_z_weight > 0:
            recon_z = torch.mean((fake_z - z) ** 2)
        total = fake_kl + hp.g_recon_z_weight * recon_z
        if hp.g_recon_x_weight > 0:
            total = total + hp.g_recon_x_weight * self._recon(imgs, self._encode(imgs, True))
        return total, {**nan_metrics(z.device, *E_METRICS),
                       "train_loss/g_recon_z": recon_z.detach(),
                       "train_loss/g_loss": total.detach()}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim), before the normalisation) replaces the
        draw."""
        imgs = self.preprocess(batch[0])
        if z is None:
            z = self.latent_noise(imgs.shape[0], state.generator)
        if self.hparams.norm_z:
            z = _normalize(z)
        if state.step % self.phase_period == 0:
            state, _, metrics = self.optimizers.grad_step(state, "e",
                                                          lambda: self.e_loss(imgs, z))
        else:
            state, _, metrics = self.optimizers.grad_step(state, "g",
                                                          lambda: self.g_loss(imgs, z))
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        z = self.latent_noise(imgs.shape[0], generator)
        if self.hparams.norm_z:
            z = _normalize(z)
        fake = self.forward(state, z)
        enc_z = self._encode(imgs, False)
        recon = self.modules["decoder"](enc_z, False).reshape(imgs.shape)
        return ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                encode_latent=enc_z), {}
