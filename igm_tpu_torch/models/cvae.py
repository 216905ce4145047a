"""Conditional VAE: counterpart of ``igm_tpu/models/cvae.py``.

q(z|x, c): the one-hot label broadcast to every pixel and concatenated to
the encoder's input (``encode_label``); p(x|z, c): a learned class
embedding (``networks.base.Embed``, N(0, 1) rows, a fixed-order backward)
concatenated to z, so the decoder takes 2 * latent_dim.  ``sample(n)``
decodes one row of n per class.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam, step_lr
from ..core.state import TrainState
from ..networks.base import Embed
from ..utils.distributions import get_decode_dist
from .base import BaseModel, ValidationResult
from .vae import negative_elbo, reparameterize


class cVAE(BaseModel):  # noqa: N801  (igm_tpu's name)
    weights_module = "decoder"

    def __init__(self, datamodule: Any = None, encoder: Any = None, decoder: Any = None,
                 latent_dim: int = 100, beta: float = 1.0, recon_weight: float = 1.0,
                 lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 n_classes: Optional[int] = None, encode_label: bool = True,
                 decoder_dist: str = "gaussian", device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, beta=beta,
                                  recon_weight=recon_weight, lr=lr, b1=b1, b2=b2,
                                  n_classes=n_classes, encode_label=encode_label,
                                  decoder_dist=decoder_dist)
        self.n_classes = int(n_classes)
        enc_in = self.channels + (self.n_classes if encode_label else 0)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim * 2,
                                   output_channel=self.channels, output_act=self.output_act),
            "encoder": instantiate(encoder, input_channel=enc_in,
                                   output_channel=2 * latent_dim),
            "class_embedding": Embed(self.n_classes, latent_dim)})
        self.decoder_dist = get_decode_dist(decoder_dist)
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        tx = adam(step_lr(hp.lr, 0.99, self.steps_per_epoch), hp.b1, hp.b2)
        self.optimizers = OptimizerSet().add("opt", tx,
                                             ["encoder", "decoder", "class_embedding"])
        self.state = self.make_state(seed)
        return self.state

    def decode(self, z: torch.Tensor, labels: torch.Tensor, train: bool) -> torch.Tensor:
        zc = torch.cat([z, self.modules["class_embedding"](labels)], dim=1)
        out = self.modules["decoder"](zc, train)
        return out.reshape(z.shape[0], self.height, self.width, self.channels)

    def _vae(self, imgs: torch.Tensor, labels: torch.Tensor, eps: torch.Tensor, train: bool):
        x = imgs
        if self.hparams.encode_label:
            classes = torch.arange(self.n_classes, device=labels.device)
            onehot = (labels.long()[:, None] == classes).to(imgs.dtype)
            x = torch.cat([imgs, onehot[:, None, None, :].expand(
                *imgs.shape[:3], self.n_classes)], dim=-1)
        z, mu, log_sigma = reparameterize(self.modules["encoder"](x, train), eps)
        return mu, log_sigma, z, self.decode(z, labels, train)

    def loss(self, imgs, labels, eps):
        mu, log_sigma, _, recon = self._vae(imgs, labels, eps, train=True)
        return negative_elbo(self, mu, log_sigma, recon, imgs)

    def train_step(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        imgs = self.preprocess(batch[0])
        labels = batch[1].to(self.device, non_blocking=True)
        if eps is None:
            eps = self.latent_noise(imgs.shape[0], state.generator)
        state, _, metrics = self.optimizers.grad_step(
            state, "opt", lambda: self.loss(imgs, labels, eps))
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One row of n samples per class: (n * n_classes, H, W, C), the
        class of image i being i // n; ``z`` replaces the latents' draw."""
        labels = torch.arange(self.n_classes, device=self.device).repeat_interleave(n)
        if z is None:
            z = self.latent_noise(n * self.n_classes, generator)
        return self.graphed("sample", lambda z, y: self.decode(z, y, train=False), z, labels)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        labels = batch[1].to(self.device)
        eps = self.latent_noise(imgs.shape[0], generator)
        _, _, z, recon = self._vae(imgs, labels, eps, train=False)
        log_p = self.decoder_dist.prob(recon, imgs).mean()
        fake = self.sample(8, generator)
        return (ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                 label=labels, encode_latent=z),
                {"val_log/log_p_x_of_z": log_p})
