"""InfoGAN: counterpart of ``igm_tpu/models/info_gan.py``.

The latent is a one-hot discrete code (``discrete_dim`` codes of
``discrete_value`` values, laid out value-major as ``jax.nn.one_hot(...,
axis=1)`` lays it), a U(-1, 1) continuous code and N(0, I) noise.  A shared
``common`` network (the encoder config, ``encode_dim`` features) feeds the
adversarial head ``netD`` (:class:`_AdvHead`) and the posterior head
``netQ`` (:class:`_QHead`).  Both optimizers step on every batch, G first,
on one latent drawn a step:

- ``g`` (:func:`~igm_tpu_torch.core.optim.grouped_adam`: ``lrG`` for
  ``netG``, ``lrQ`` for ``netQ``): the generator's adversarial loss plus
  ``lambda_I`` times the mutual-information terms (cross-entropy of the
  discrete codes, mean squared error of the continuous ones);
- ``d`` (``netD`` and ``common``): the discriminator's loss on the real
  images and the detached fakes.

The BatchNorms move in ``igm_tpu``'s order: netG and common (G), then
common on the real images, netG, common on the fakes (D).  The grids of
samples and of the discrete and continuous traversals are logged at each
epoch's end (``on_train_epoch_end``), from a generator seeded with the
epoch.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam, grouped_adam
from ..core.state import TrainState
from ..networks.base import Dense
from ..utils.losses import adversarial_loss
from .base import BaseModel, ValidationResult


class _AdvHead(nn.Module):
    """LeakyReLU(0.01) -> Linear(1)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.Dense_0(F.leaky_relu(x, 0.01))


class _QHead(nn.Module):
    """LeakyReLU -> 128 -> LeakyReLU -> discrete logits and continuous codes."""

    def __init__(self, in_features: int, out_dim: int):
        super().__init__()
        self.Dense_0 = Dense(in_features, 128)
        self.Dense_1 = Dense(128, out_dim)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.leaky_relu(self.Dense_0(F.leaky_relu(x, 0.01)), 0.01)
        return self.Dense_1(x)


class InfoGAN(BaseModel):
    weights_module = "netG"
    decoder_module_name = "netG"

    def __init__(self, datamodule: Any, netG: Any, netD: Any, lambda_I: float = 1,
                 discrete_dim: int = 1, discrete_value: int = 10, continuous_dim: int = 2,
                 noise_dim: int = 62, encode_dim: int = 1024, loss_mode: str = "vanilla",
                 lrG: float = 1e-3, lrD: float = 2e-4, lrQ: float = 2e-4, b1: float = 0.5,
                 b2: float = 0.999, device: str | torch.device | None = None):
        super().__init__(datamodule, device)
        codes = discrete_dim * discrete_value + continuous_dim
        self.save_hyperparameters(
            lambda_I=lambda_I, discrete_dim=discrete_dim, discrete_value=discrete_value,
            continuous_dim=continuous_dim, noise_dim=noise_dim, encode_dim=encode_dim,
            loss_mode=loss_mode, lrG=lrG, lrD=lrD, lrQ=lrQ, b1=b1, b2=b2,
            latent_dim=codes + noise_dim)
        self.latent_dim = self.hparams.latent_dim
        self.modules = nn.ModuleDict({
            "netG": instantiate(netG, input_channel=self.latent_dim,
                                output_channel=self.channels),
            "common": instantiate(netD, input_channel=self.channels, output_channel=encode_dim),
            "netD": _AdvHead(encode_dim),
            "netQ": _QHead(encode_dim, codes)})
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = (
            OptimizerSet()
            .add("g", grouped_adam({"netG": hp.lrG, "netQ": hp.lrQ}, hp.b1, hp.b2),
                 ["netG", "netQ"])
            .add("d", adam(hp.lrD, hp.b1, hp.b2), ["netD", "common"]))
        self.state = self.make_state(seed)
        return self.state

    # --------------------------------------------------------------- latents
    def draw_codes(self, n: int, generator: Optional[torch.Generator] = None):
        """(discrete indices (n, discrete_dim), continuous codes, noise)."""
        hp = self.hparams
        dis = self.batch_draw(functools.partial(torch.randint, 0, hp.discrete_value),
                              (n, hp.discrete_dim), generator)
        cont = self.batch_draw(torch.rand, (n, hp.continuous_dim), generator) * 2.0 - 1.0
        z = self.batch_draw(torch.randn, (n, hp.noise_dim), generator)
        return dis, cont, z

    def make_latent(self, dis: torch.Tensor, cont: torch.Tensor, z: torch.Tensor):
        """The generator's input: one-hot codes (n, value, dim) flattened,
        then the continuous codes and the noise."""
        n = dis.shape[0]
        one_hot = F.one_hot(dis.long(), self.hparams.discrete_value).transpose(1, 2)
        return torch.cat([one_hot.reshape(n, -1).to(z.dtype), cont, z], dim=1)

    def decode(self, n: int, generator: Optional[torch.Generator] = None, dis=None,
               cont=None, z=None) -> torch.Tensor:
        """Images from codes: each of ``dis``, ``cont``, ``z`` not given is
        drawn."""
        d0, c0, z0 = self.draw_codes(n, generator)
        latent = self.make_latent(d0 if dis is None else dis, c0 if cont is None else cont,
                                  z0 if z is None else z)
        return self.forward(self.state, latent)

    # ------------------------------------------------------------------ steps
    def g_loss(self, dis: torch.Tensor, cont: torch.Tensor, z: torch.Tensor):
        hp = self.hparams
        n = dis.shape[0]
        fake = self.modules["netG"](self.make_latent(dis, cont, z), True)
        feat = self.modules["common"](fake, True)
        g_loss = adversarial_loss(self.modules["netD"](feat, True), True, hp.loss_mode)
        q_out = self.modules["netQ"](feat, True)
        c = hp.continuous_dim
        dis_logits = q_out[:, :-c].reshape(n, hp.discrete_value, hp.discrete_dim)
        log_probs = F.log_softmax(dis_logits, dim=1)
        i_disc = -torch.gather(log_probs, 1, dis[:, None, :].long()).mean() * 1.0
        i_cont = torch.mean((q_out[:, -c:] - cont) ** 2)
        total = g_loss + hp.lambda_I * (i_disc + i_cont)
        return total, {"train_loss/g_loss": g_loss.detach(),
                       "train_loss/I_discrete_loss": i_disc.detach(),
                       "train_loss/I_continuous": i_cont.detach()}

    def d_loss(self, imgs: torch.Tensor, latent: torch.Tensor):
        mode, common, net_d = self.hparams.loss_mode, self.modules["common"], self.modules["netD"]
        pred_real = net_d(common(imgs, True), True)
        with torch.no_grad():
            fake = self.modules["netG"](latent, True)
        pred_fake = net_d(common(fake, True), True)
        d_loss = (adversarial_loss(pred_real, True, mode)
                  + adversarial_loss(pred_fake, False, mode)) / 2.0
        return d_loss, {"train_loss/d_loss": d_loss.detach(),
                        "train_log/pred_real": pred_real.mean().detach(),
                        "train_log/pred_fake": pred_fake.mean().detach()}

    def train_step(self, state: TrainState, batch, dis: Optional[torch.Tensor] = None,
                   cont: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        """``dis`` ((N, discrete_dim) indices), ``cont`` ((N, continuous_dim))
        and ``z`` ((N, noise_dim)) replace the draws; both phases use them."""
        imgs = self.preprocess(batch[0])
        if dis is None or cont is None or z is None:
            d0, c0, z0 = self.draw_codes(imgs.shape[0], state.generator)
            dis, cont, z = (d0 if dis is None else dis, c0 if cont is None else cont,
                            z0 if z is None else z)
        state, _, metrics = self.optimizers.grad_step(state, "g",
                                                      lambda: self.g_loss(dis, cont, z))
        latent = self.make_latent(dis, cont, z)
        state, _, d_metrics = self.optimizers.grad_step(state, "d",
                                                        lambda: self.d_loss(imgs, latent))
        state.step += 1
        return state, {**metrics, **d_metrics}

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None, sample: bool = False):
        imgs = self.preprocess(batch[0])
        return ValidationResult(real_image=imgs,
                                fake_image=self.decode(imgs.shape[0], generator)), {}

    # ----------------------------------------------------------- epoch hook
    @torch.no_grad()
    def on_train_epoch_end(self, trainer) -> None:
        """The sample grid and the traversals over the discrete values and
        the first two continuous codes (``igm_tpu``'s tags), from a
        generator seeded with the epoch."""
        from ..callbacks.visualization import get_grid_images
        if trainer.state is None:
            return
        hp = self.hparams
        epoch, logger = trainer.current_epoch, trainer.logger
        gen = torch.Generator(device=self.device).manual_seed(int(epoch))

        def log(tag: str, imgs: torch.Tensor, n: int, nrow: int) -> None:
            logger.log_image(tag, get_grid_images(imgs.float().cpu().numpy(), self, n, nrow),
                             epoch)

        log("images/sample", self.decode(64, gen), 64, 8)
        n_rows, a, b, c = 8, hp.discrete_value, hp.continuous_dim, hp.noise_dim
        dev = self.device

        def rows(shape, width):       # one draw a row, repeated across the row
            x = torch.randn((n_rows, 1) + shape, generator=gen, device=dev)
            return x.expand(n_rows, width, *shape).reshape(n_rows * width, *shape)

        disc = torch.arange(a, device=dev).repeat(n_rows).reshape(-1, 1)
        cont, z = rows((b,), a), rows((c,), a)
        log("visual/traverse over discrete values", self.decode(n_rows * a, gen, disc, cont, z),
            n_rows * a, a)
        col = 10
        disc = torch.randint(0, a, (n_rows, 1), generator=gen, device=dev)
        disc = disc.expand(n_rows, col).reshape(-1, 1)
        variation = torch.linspace(-2, 2, col, device=dev).repeat(n_rows)
        cont, z = rows((b,), col), rows((c,), col)
        for i, tag in zip(range(min(2, b)), ("visual/traverse over first continuous values",
                                             "visual/traverse over second continuous values")):
            cont_mix = cont.clone()
            cont_mix[:, i] = variation
            log(tag, self.decode(n_rows * col, gen, disc, cont_mix, z), n_rows * col, col)

