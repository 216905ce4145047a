"""VAE-GAN: counterpart of ``igm_tpu/models/vae_gan.py``.

A VAE whose reconstruction loss is taken in the discriminator's feature
space: ``netD`` is the encoder config's network with one output and
``return_features=True``.  One forward a step: the VAE (encoder, the
reparameterised z, decoder), the decoder on prior draws (its batch
statistics dropped, as ``igm_tpu`` drops them: ``frozen_stats``), then
``netD`` on the fakes, the real images and the reconstructions (its
BatchNorms move in that order).  From it three gradients, all taken before
any update:

- of ``reg + feat_recon`` (the KL and the feature reconstruction) with
  respect to the encoder and decoder;
- of the generator's adversarial loss with respect to the decoder;
- of the discriminator's loss with respect to ``netD``;

then ``ae`` applies the encoder's first gradient and the decoder's
``recon_weight * first + adversarial`` (``igm_tpu``'s gradient surgery),
and ``d`` applies ``netD``'s.  The adversarial losses are vanilla whatever
``loss_mode`` says, as there.  The reparameterisation noise and the prior
draws come from ``state.generator``, in that order, unless given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.base import frozen_stats
from ..utils.losses import adversarial_loss, normal_kld
from .base import BaseModel, ValidationResult
from .vae import reparameterize


class VAEGAN(BaseModel):
    weights_module = "decoder"

    def __init__(self, datamodule: Any, encoder: Any = None, decoder: Any = None,
                 latent_dim: int = 100, lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
                 recon_weight: float = 1e-4, loss_mode: str = "vanilla",
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, lr=lr, b1=b1, b2=b2,
                                  recon_weight=recon_weight, loss_mode=loss_mode)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=2 * latent_dim),
            "netD": instantiate(encoder, input_channel=self.channels, output_channel=1,
                                return_features=True)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("ae", adam(hp.lr, hp.b1, hp.b2), ["encoder", "decoder"])
                           .add("d", adam(hp.lr, hp.b1, hp.b2), ["netD"]))
        self.state = self.make_state(seed)
        return self.state

    def _vae(self, imgs: torch.Tensor, eps: torch.Tensor, train: bool):
        z, mu, log_sigma = reparameterize(self.modules["encoder"](imgs, train), eps)
        recon = self.modules["decoder"](z, train).reshape(imgs.shape)
        return mu, log_sigma, z, recon

    def losses(self, imgs: torch.Tensor, eps: torch.Tensor, prior_z: torch.Tensor):
        """(reg + feat_recon, g_adv, d_adv, metrics) of the step's forward."""
        n = imgs.shape[0]
        mu, log_sigma, _, recon = self._vae(imgs, eps, True)
        with frozen_stats(self.modules["decoder"]):
            fake = self.modules["decoder"](prior_z, True).reshape(imgs.shape)
        net_d = self.modules["netD"]
        fake_logit, _ = net_d(fake, True)
        real_logit, real_feat = net_d(imgs, True)
        recon_logit, recon_feat = net_d(recon, True)
        reg_loss = normal_kld(mu, log_sigma)
        feat_recon = ((real_feat - recon_feat) ** 2).sum() / n
        g_adv = adversarial_loss(fake_logit, True)
        d_adv = adversarial_loss(real_logit, True) + adversarial_loss(fake_logit, False)
        metrics = {"train_loss/reg_loss": reg_loss.detach(),
                   "train_loss/feature_recon_loss": feat_recon.detach(),
                   "train_loss/g_adv_loss": g_adv.detach(),
                   "train_loss/d_adv_loss": d_adv.detach(),
                   "train_log/real_logit": real_logit.mean().detach(),
                   "train_log/fake_logit": fake_logit.mean().detach(),
                   "train_log/recon_logit": recon_logit.mean().detach()}
        return reg_loss + feat_recon, g_adv, d_adv, metrics

    def train_step(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None,
                   prior_z: Optional[torch.Tensor] = None):
        """``eps`` and ``prior_z`` ((N, latent_dim) each) replace the draws."""
        imgs = self.preprocess(batch[0])
        n = imgs.shape[0]
        if eps is None:
            eps = self.latent_noise(n, state.generator)
        if prior_z is None:
            prior_z = self.latent_noise(n, state.generator)
        vae_loss, g_adv, d_adv, metrics = self.losses(imgs, eps, prior_z)
        enc = list(self.modules["encoder"].parameters())
        dec = list(self.modules["decoder"].parameters())
        g_vae = torch.autograd.grad(vae_loss, enc + dec, retain_graph=True)
        g_adv_dec = torch.autograd.grad(g_adv, dec, retain_graph=True)
        g_dis = torch.autograd.grad(d_adv, list(self.modules["netD"].parameters()))
        rw = float(self.hparams.recon_weight)
        g_dec = [rw * a + b for a, b in zip(g_vae[len(enc):], g_adv_dec)]
        state = self.optimizers.apply_grads(state, "ae", list(g_vae[:len(enc)]) + g_dec)
        state = self.optimizers.apply_grads(state, "d", g_dis)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        eps = self.latent_noise(imgs.shape[0], generator)
        _, _, z, recon = self._vae(imgs, eps, train=False)
        fake = self.sample(imgs.shape[0], generator)
        return (ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                 label=batch[1], encode_latent=z),
                {"val_log/van_mse": torch.mean((imgs - recon) ** 2)})
