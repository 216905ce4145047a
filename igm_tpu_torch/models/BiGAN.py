"""BiGAN: counterpart of ``igm_tpu/models/BiGAN.py``.

A joint discriminator D(x, z) of three sub-networks (:class:`Discriminator`)
judges (image, encoded latent) pairs as real and (generated image, latent)
pairs as fake.  As in speed_gan, one forward a step gives the G loss
(encoder and decoder, optimizer ``g``) and the D loss (``discriminator``,
``d``): ``encoder(x)``, ``decoder(z)``, D on the real pairs, then D on the
fake pairs (the BatchNorms move in that order); both gradients are taken
before either update.
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
from .base import BaseModel, ValidationResult


class Discriminator(nn.Module):
    """``dis_z`` (an MLP on z, leaky-ReLU output), ``dis_x`` (the encoder
    config's network on x) and ``dis_pair`` (an MLP on their concatenated
    features).  The sub-networks are held under the names Flax gives them,
    ``<class name>_<count of that class before it>`` in construction order
    (``MLPEncoder_0``, ``Encoder_0``, ``MLPEncoder_1`` for a conv encoder;
    ``MLPEncoder_0``, ``MLPEncoder_1``, ``MLPEncoder_2`` for an MLP one), so
    that ``interop`` maps ``igm_tpu``'s parameter paths onto them."""

    def __init__(self, encoder_cfg: Any, input_channel: int, latent_dim: int,
                 hidden_dim: int):
        super().__init__()
        parts = (
            MLPEncoder(input_channel=latent_dim, output_channel=hidden_dim, width=1, height=1,
                       hidden_dims=[hidden_dim, hidden_dim], output_act="leaky_relu"),
            instantiate(encoder_cfg, input_channel=input_channel, output_channel=hidden_dim),
            MLPEncoder(input_channel=2 * hidden_dim, output_channel=1, width=1, height=1,
                       hidden_dims=[hidden_dim]))
        seen: dict = {}
        self.part_names = []
        for part in parts:
            kind = type(part).__name__
            name = f"{kind}_{seen.get(kind, 0)}"
            seen[kind] = seen.get(kind, 0) + 1
            self.add_module(name, part)
            self.part_names.append(name)

    def forward(self, x: torch.Tensor, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        dis_z, dis_x, dis_pair = (getattr(self, n) for n in self.part_names)
        return dis_pair(torch.cat([dis_z(z, train), dis_x(x, train)], dim=1), train)


class BiGAN(BaseModel):
    weights_module = "decoder"

    def __init__(self, datamodule: Any, encoder: Any, decoder: Any, latent_dim: int = 100,
                 hidden_dim: int = 512, loss_mode: str = "vanilla", lrG: float = 2e-4,
                 lrD: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
                 device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(latent_dim=latent_dim, hidden_dim=hidden_dim,
                                  loss_mode=loss_mode, lrG=lrG, lrD=lrD, b1=b1, b2=b2)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=latent_dim),
            "discriminator": Discriminator(dict(encoder), self.channels, latent_dim,
                                           hidden_dim)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("g", adam(hp.lrG, hp.b1, hp.b2), ["encoder", "decoder"])
                           .add("d", adam(hp.lrD, hp.b1, hp.b2), ["discriminator"]))
        self.state = self.make_state(seed)
        return self.state

    def losses(self, imgs: torch.Tensor, z: torch.Tensor):
        """(G loss, D loss, metrics) of the shared forward."""
        mode, disc = self.hparams.loss_mode, self.modules["discriminator"]
        enc_z = self.modules["encoder"](imgs, True)
        fake_x = self.modules["decoder"](z, True)
        real_logit = disc(imgs, enc_z, True)
        fake_logit = disc(fake_x, z, True)
        g_loss = (adversarial_loss(real_logit, False, mode)
                  + adversarial_loss(fake_logit, True, mode))
        d_loss = (adversarial_loss(real_logit, True, mode)
                  + adversarial_loss(fake_logit, False, mode))
        return g_loss, d_loss, {"train_loss/g_loss": g_loss.detach(),
                                "train_loss/d_loss": d_loss.detach(),
                                "train_log/real_logit": real_logit.mean().detach(),
                                "train_log/fake_logit": fake_logit.mean().detach()}

    def train_step(self, state: TrainState, batch, z: Optional[torch.Tensor] = None):
        """``z`` ((N, latent_dim)) replaces the draw."""
        imgs = self.preprocess(batch[0])
        if z is None:
            z = self.latent_noise(imgs.shape[0], state.generator)
        g_loss, d_loss, metrics = self.losses(imgs, z)
        g_params = [p for m in ("encoder", "decoder") for p in self.modules[m].parameters()]
        grads_g = torch.autograd.grad(g_loss, g_params, retain_graph=True)
        grads_d = torch.autograd.grad(d_loss, list(self.modules["discriminator"].parameters()))
        state = self.optimizers.apply_grads(state, "g", grads_g)
        state = self.optimizers.apply_grads(state, "d", grads_d)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        fake = self.sample(imgs.shape[0], generator)
        enc_z = self.modules["encoder"](imgs, False)
        recon = self.modules["decoder"](enc_z, False).reshape(imgs.shape)
        return ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                encode_latent=enc_z), {}
