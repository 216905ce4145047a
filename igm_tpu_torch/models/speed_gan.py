"""speed_gan: counterpart of ``igm_tpu/models/speed_gan.py`` (the class is
``GAN``, as there).

One forward a step serves both updates: ``netG(z)``, ``netD`` on the fakes,
then ``netD`` on the real images (the BatchNorms move in that order), and
from it the generator's loss and the discriminator's.  ``grads_g`` is the
gradient of the G loss with respect to ``netG`` and ``grads_d`` that of the
D loss with respect to ``netD`` (``igm_tpu`` pulls both back through one
``jax.vjp``; the cross terms are dropped there as here).  Both gradients
are taken before either optimizer updates a parameter in place, which
would change tensors autograd saved; then ``g`` and ``d`` apply them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.state import TrainState
from ..utils.losses import adversarial_loss
from .gan import GAN as _AlternatingGAN


class GAN(_AlternatingGAN):
    phase_period = 1

    def losses(self, imgs: torch.Tensor, z: torch.Tensor):
        """(G loss, D loss, metrics) of the shared forward."""
        mode, net_d = self.hparams.loss_mode, self.modules["netD"]
        pred_fake = net_d(self.modules["netG"](z, True), True)
        pred_real = net_d(imgs, True)
        d_loss = (adversarial_loss(pred_real, True, mode)
                  + adversarial_loss(pred_fake, False, mode)) / 2.0
        g_loss = adversarial_loss(pred_fake, True, mode)
        return g_loss, d_loss, {"train_loss/d_loss": d_loss.detach(),
                                "train_loss/g_loss": g_loss.detach(),
                                "train_log/pred_real": pred_real.mean().detach(),
                                "train_log/pred_fake": pred_fake.mean().detach()}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim)) replaces the draw."""
        imgs = self.preprocess(batch[0])
        if z is None:
            z = self.latent_noise(imgs.shape[0], state.generator)
        g_loss, d_loss, metrics = self.losses(imgs, z)
        grads_g = torch.autograd.grad(g_loss, list(self.modules["netG"].parameters()),
                                      retain_graph=True)
        grads_d = torch.autograd.grad(d_loss, list(self.modules["netD"].parameters()))
        state = self.optimizers.apply_grads(state, "g", grads_g)
        state = self.optimizers.apply_grads(state, "d", grads_d)
        state.step += 1
        return state, metrics
