"""WGAN-GP: counterpart of ``igm_tpu/models/wgan_gp.py`` (the class is
``WGAN``, as there).

Adam(lr, b1=0, b2=0.9) for ``netG`` (``g``) and ``netD`` (``d``).  The step
takes the G branch when ``state.step % (n_critic + 1) == n_critic`` and the
D branch otherwise (``phase_period = n_critic + 1``).  The D loss adds
``gp_weight`` times the gradient penalty on interpolates ``x_hat = lerp *
x + (1 - lerp) * G(z)`` (``lerp`` ~ U(0, 1) a sample, the fakes detached):
``mean((||dD(x_hat)/dx_hat|| - 1)**2)``, the norm ``sqrt(sum g**2 +
1e-12)``, taken with ``create_graph=True`` so that the D update
differentiates through it (a gradient of a gradient).  The penalty's critic
call moves no statistics (``frozen_stats``), as ``igm_tpu`` passes
``update_stats=False``.

Both networks are built with ``norm_type="layer"`` whatever the config
says (the experiments ask for ``instance``): a quirk of ``igm_tpu``
(``wgan_gp.py:39-40``), mirrored.  ``z`` and ``lerp`` are drawn from
``state.generator`` on every step, in that order, unless given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.base import frozen_stats
from .base import BaseModel, ValidationResult
from .gan import nan_metrics


class WGAN(BaseModel):
    weights_module = "netG"
    decoder_module_name = "netG"

    def __init__(self, datamodule: Any, netG: Any, netD: Any, latent_dim: int = 100,
                 n_critic: int = 5, lrG: float = 1e-4, lrD: float = 1e-4, b1: float = 0.0,
                 b2: float = 0.9, gp_weight: float = 10,
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, n_critic=n_critic, lrG=lrG, lrD=lrD,
                                  b1=b1, b2=b2, gp_weight=gp_weight)
        self.phase_period = int(n_critic) + 1
        netG = dict(netG, norm_type="layer")
        netD = dict(netD, norm_type="layer")
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
        g_loss = -self.modules["netD"](self.modules["netG"](z, True), True).mean()
        return g_loss, {"train_loss/g_loss": g_loss.detach(),
                        **nan_metrics(z.device, "train_loss/d_loss", "train_log/real_logit",
                                      "train_log/fake_logit", "train_log/gradient_panelty")}

    def gradient_penalty(self, imgs: torch.Tensor, fake: torch.Tensor,
                         lerp: torch.Tensor) -> torch.Tensor:
        """``mean((||dD/dx_hat|| - 1)**2)`` at the interpolates, differentiable
        with respect to ``netD``'s parameters."""
        net_d = self.modules["netD"]
        x_hat = (lerp * imgs + (1.0 - lerp) * fake).detach().requires_grad_(True)
        with frozen_stats(net_d):
            out = net_d(x_hat, True)
        grads, = torch.autograd.grad(out.sum(), x_hat, create_graph=True)
        g_norm = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
        return ((g_norm - 1.0) ** 2).mean()

    def d_loss(self, imgs: torch.Tensor, z: torch.Tensor, lerp: torch.Tensor):
        net_d = self.modules["netD"]
        real_loss = -net_d(imgs, True).mean()
        with torch.no_grad():
            fake = self.modules["netG"](z, True)
        fake_loss = net_d(fake, True).mean()
        gp = self.gradient_penalty(imgs, fake, lerp)
        d_loss = real_loss + fake_loss + self.hparams.gp_weight * gp
        return d_loss, {"train_loss/d_loss": d_loss.detach(),
                        "train_log/real_logit": -real_loss.detach(),
                        "train_log/fake_logit": fake_loss.detach(),
                        "train_log/gradient_panelty": gp.detach(),
                        **nan_metrics(z.device, "train_loss/g_loss")}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None,
                   lerp: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim)) and ``lerp`` ((N, 1, 1, 1)) replace the
        draws."""
        imgs = self.preprocess(batch[0])
        n = imgs.shape[0]
        if z is None:
            z = self.latent_noise(n, state.generator)
        if lerp is None:
            lerp = self.batch_draw(torch.rand, (n, 1, 1, 1), state.generator)
        if state.step % self.phase_period == self.hparams.n_critic:
            state, _, metrics = self.optimizers.grad_step(state, "g", lambda: self.g_loss(z))
        else:
            state, _, metrics = self.optimizers.grad_step(
                state, "d", lambda: self.d_loss(imgs, z, lerp))
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        return ValidationResult(real_image=imgs,
                                fake_image=self.sample(imgs.shape[0], generator)), {}
