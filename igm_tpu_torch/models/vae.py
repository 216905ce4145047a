"""VAE and beta-VAE: counterpart of ``igm_tpu/models/vae.py``.

ELBO = -beta KL + recon_weight log p(x|z), with the reparameterised Gaussian
posterior ``z = mu + exp(log_sigma) eps``; Adam with the per-epoch
StepLR(0.99) (``core.optim.step_lr``, the capturable learning-rate slot on
the card).  beta-VAE is the config's ``beta``.  The encoder's and decoder's
BatchNorms (``networks.base.Norm``) move their running statistics in the
train step, in place, so ``train_step_n`` captures it.  ``eps`` is drawn
from ``state.generator`` unless given (the parity tests inject
``igm_tpu``'s).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam, step_lr
from ..core.state import TrainState
from ..utils.distributions import get_decode_dist
from ..utils.losses import normal_kld
from .base import BaseModel, ValidationResult


def reparameterize(z2: torch.Tensor, eps: torch.Tensor):
    """The encoder's (N, 2L) output -> (z, mu, log_sigma)."""
    mu, log_sigma = torch.chunk(z2, 2, dim=1)
    return mu + torch.exp(log_sigma) * eps, mu, log_sigma


def negative_elbo(model: BaseModel, mu, log_sigma, recon, imgs):
    """-(-beta KL + recon_weight log p(x|z)) and the ``train_log/*`` metrics."""
    hp = model.hparams
    kld = normal_kld(mu, log_sigma)
    log_p = model.decoder_dist.prob(recon, imgs).mean()
    elbo = -hp.beta * kld + hp.recon_weight * log_p
    return -elbo, {"train_log/elbo": elbo.detach(),
                   "train_log/kl_divergence": kld.detach(),
                   "train_log/log_p_x_of_z": log_p.detach()}


class VAE(BaseModel):
    weights_module = "decoder"

    def __init__(self, datamodule: Any = None, encoder: Any = None, decoder: Any = None,
                 latent_dim: int = 100, beta: float = 1.0, recon_weight: float = 1.0,
                 lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 decoder_dist: str = "gaussian", device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, beta=beta,
                                  recon_weight=recon_weight, lr=lr, b1=b1, b2=b2,
                                  decoder_dist=decoder_dist)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels, output_act=self.output_act),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=2 * latent_dim)})
        self.decoder_dist = get_decode_dist(decoder_dist)
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        tx = adam(step_lr(hp.lr, 0.99, self.steps_per_epoch), hp.b1, hp.b2)
        self.optimizers = OptimizerSet().add("opt", tx, ["encoder", "decoder"])
        self.state = self.make_state(seed)
        return self.state

    def _vae(self, imgs: torch.Tensor, eps: torch.Tensor, train: bool):
        z, mu, log_sigma = reparameterize(self.modules["encoder"](imgs, train), eps)
        recon = self.modules["decoder"](z, train).reshape(imgs.shape)
        return mu, log_sigma, z, recon

    def loss(self, imgs: torch.Tensor, eps: torch.Tensor):
        """(-ELBO, metrics) of a train-mode forward on preprocessed images."""
        mu, log_sigma, _, recon = self._vae(imgs, eps, train=True)
        return negative_elbo(self, mu, log_sigma, recon, imgs)

    def train_step(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        imgs = self.preprocess(batch[0])
        if eps is None:
            eps = self.latent_noise(imgs.shape[0], state.generator)
        state, _, metrics = self.optimizers.grad_step(state, "opt",
                                                      lambda: self.loss(imgs, eps))
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        eps = self.latent_noise(imgs.shape[0], generator)
        _, _, z, recon = self._vae(imgs, eps, train=False)
        log_p = self.decoder_dist.prob(recon, imgs).mean()
        fake = self.sample(imgs.shape[0], generator)
        return (ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                 label=batch[1], encode_latent=z),
                {"val_log/log_p_x_of_z": log_p})
