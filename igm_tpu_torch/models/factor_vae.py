"""FactorVAE: counterpart of ``igm_tpu/models/factor_vae.py``.

A train step splits the batch in two halves and takes two optimizer steps:

- AE (``ae``: encoder and decoder, Adam(lr, ae_b1, ae_b2)): the
  reconstruction loss, the KL and ``adv_weight`` times the critic's
  adversarial loss on the first half's latents z1.  The loss runs through
  the critic ``netD``, but the gradients are taken with respect to the AE
  parameters alone (``OptimizerSet.grad_step``), so nothing of this phase
  reaches ``netD``'s gradients.
- D (``d``: ``netD``, Adam(lrD, adv_b1, adv_b2)): the critic on the second
  half's latents, each latent dimension permuted independently across the
  batch (:func:`permute_dims`), as real, and on z1, detached, as fake, with
  ``netD``'s parameters as the AE step left them (unchanged).

The encoder runs in train mode in both phases, so its BatchNorms (if the
config gives it any) move their statistics twice a step: on the first
half, then on the second.  The decoder moves its statistics in the AE
phase.  ``netD`` (a 256-256 MLP critic, its first layer layer-normed, its
second batch-normed) normalises with batch statistics but never moves its
running ones: ``igm_tpu`` drops the ``batch_stats`` it returns in both
phases, so eval mode reads their initial 0 and 1 (``frozen_stats``).

The draws (the two halves' N(0, I) noise and the permutations) come from
``state.generator`` on the device, in that order, unless given: a
permutation per latent dimension is the ``argsort`` of uniform noise down
that column, so the step stays capturable.

Under data parallelism (``batch_blocks = 2``) a rank holds its rows of
each half; the noise is drawn at the global halves and the permutations
over the global second half: ``z`` is all-gathered, permuted as one
process permutes it, and the rank keeps its rows.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..parallel.mesh import all_gather_rows
from ..networks.base import frozen_stats
from ..networks.basic import MLPEncoder
from ..utils.distributions import get_decode_dist
from ..utils.losses import adversarial_loss, normal_kld
from .base import BaseModel, ValidationResult
from .vae import reparameterize


def draw_permutations(n: int, d: int, generator: Optional[torch.Generator],
                      device) -> torch.Tensor:
    """(n, d): column j an independent uniform permutation of range(n)."""
    u = torch.rand((n, d), generator=generator, device=device)
    return torch.argsort(u, dim=0)


def permute_dims(z: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = z[perm[i, j], j]``: each latent dimension shuffled
    across the batch by its own permutation (``igm_tpu``'s
    ``take_along_axis(z, perms.T, axis=0)``)."""
    return torch.gather(z, 0, perm)


class FactorVAE(BaseModel):
    weights_module = "decoder"
    batch_blocks = 2

    def __init__(self, datamodule: Any, encoder: Any = None, decoder: Any = None,
                 loss_mode: str = "lsgan", adv_weight: float = 1, latent_dim: int = 10,
                 lr: float = 2e-4, lrD: float = 1e-4, ae_b1: float = 0.9,
                 ae_b2: float = 0.999, adv_b1: float = 0.5, adv_b2: float = 0.9,
                 decoder_dist: str = "gaussian", device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        self.save_hyperparameters(loss_mode=loss_mode, adv_weight=adv_weight,
                                  latent_dim=latent_dim, lr=lr, lrD=lrD, ae_b1=ae_b1,
                                  ae_b2=ae_b2, adv_b1=adv_b1, adv_b2=adv_b2,
                                  decoder_dist=decoder_dist)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels, output_act=self.output_act),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=latent_dim * 2),
            "netD": MLPEncoder(input_channel=latent_dim, hidden_dims=[256, 256],
                               output_channel=1, width=1, height=1)})
        self.decoder_dist = get_decode_dist(decoder_dist)
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (OptimizerSet()
                           .add("ae", adam(hp.lr, hp.ae_b1, hp.ae_b2), ["encoder", "decoder"])
                           .add("d", adam(hp.lrD, hp.adv_b1, hp.adv_b2), ["netD"]))
        self.state = self.make_state(seed)
        return self.state

    def critic(self, z: torch.Tensor) -> torch.Tensor:
        """``netD`` in train mode, its running statistics left as they are."""
        with frozen_stats(self.modules["netD"]):
            return self.modules["netD"](z, train=True)

    def ae_loss(self, imgs1: torch.Tensor, eps1: torch.Tensor):
        hp = self.hparams
        z1, mu, log_sigma = reparameterize(self.modules["encoder"](imgs1, True), eps1)
        recon = self.modules["decoder"](z1, True).reshape(imgs1.shape)
        reg_loss = normal_kld(mu, log_sigma)
        recon_loss = -self.decoder_dist.prob(recon, imgs1).mean()
        g_adv = adversarial_loss(self.critic(z1), True, hp.loss_mode)
        loss = recon_loss + reg_loss + hp.adv_weight * g_adv
        return loss, {"z1": z1.detach(),
                      "metrics": {"train_loss/reg_loss": reg_loss.detach(),
                                  "train_loss/recon_loss": recon_loss.detach(),
                                  "train_loss/g_adv_loss": g_adv.detach()}}

    def d_loss(self, perm_z: torch.Tensor, z1: torch.Tensor):
        mode = self.hparams.loss_mode
        real_logit, fake_logit = self.critic(perm_z), self.critic(z1)
        d_loss = (adversarial_loss(real_logit, True, mode)
                  + adversarial_loss(fake_logit, False, mode))
        return d_loss, {"train_loss/d_adv_loss": d_loss.detach(),
                        "train_log/real_logit": real_logit.mean().detach(),
                        "train_log/fake_logit": fake_logit.mean().detach()}

    def train_step(self, state: TrainState, batch, eps1: Optional[torch.Tensor] = None,
                   eps2: Optional[torch.Tensor] = None, perm: Optional[torch.Tensor] = None):
        """``eps1``/``eps2`` (the halves' noise, (N/2, L)) and ``perm``
        ((N/2, L) over the global half, :func:`permute_dims`) replace the
        draws."""
        imgs1, imgs2 = torch.chunk(self.preprocess(batch[0]), 2, dim=0)
        gen, latent = state.generator, int(self.hparams.latent_dim)
        if eps1 is None:
            eps1 = self.latent_noise(imgs1.shape[0], gen)
        if eps2 is None:
            eps2 = self.latent_noise(imgs2.shape[0], gen)
        world = 1 if self.mesh is None else self.mesh.world
        if perm is None:      # over the global second half
            perm = draw_permutations(imgs2.shape[0] * world, latent, gen, self.device)
        state, _, aux = self.optimizers.grad_step(state, "ae",
                                                  lambda: self.ae_loss(imgs1, eps1))
        metrics = dict(aux["metrics"])
        with torch.no_grad():        # the encoder after the AE step, its output detached
            z2, _, _ = reparameterize(self.modules["encoder"](imgs2, True), eps2)
            if self.mesh is not None:
                z2 = all_gather_rows(self.mesh, z2)
            perm_z = self.batch_rows(permute_dims(z2, perm))
        state, _, d_metrics = self.optimizers.grad_step(
            state, "d", lambda: self.d_loss(perm_z, aux["z1"]))
        metrics.update(d_metrics)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        eps = self.latent_noise(imgs.shape[0], generator)
        z, _, _ = reparameterize(self.modules["encoder"](imgs, False), eps)
        recon = self.modules["decoder"](z, False).reshape(imgs.shape)
        fake = self.sample(imgs.shape[0], generator)
        return (ValidationResult(real_image=imgs, fake_image=fake, recon_image=recon,
                                 encode_latent=z, label=batch[1]), {})
