"""Latent diffusion: DDPM over a frozen VQ-VAE's continuous latent space.
Counterpart of ``igm_tpu/models/latent_ddpm.py``.

The VQ-VAE encoder maps images to a 4x-downsampled latent grid; the DDPM
(everything inherited: schedules, loss, EMA, samplers, guidance) learns the
distribution of those latents; decoding quantises through the codebook (on
the card: one nearest-codebook kernel launch per decode) before the
convolutional decoder, the VQ-VAE's own eval path.

The first stage arrives through ``first_stage_ckpt``, a directory of the
port's checkpoints written by ``experiment=vqvae/*`` (or an ``igm_tpu``
VQ-VAE checkpoint converted to an ``.npz``): its encoder, decoder
and codebook (parameters and buffers) are spliced into this model's modules,
frozen (no optimizer owns them; they run under ``no_grad`` in eval mode),
so a latent-DDPM checkpoint holds everything afterwards.  The first stage
computes in float32 whatever the denoiser's compute dtype.

The latent scale is the buffer ``modules["latent"].scale``, so it rides the
checkpoints into the sampling CLI: ``latent_scale=auto`` is resolved once in
``on_fit_start`` and every later user reads the calibrated value.

The samplers decode their latents; ``inpaint`` takes pixel-space images and
masks; ``interpolate`` is DDPM's, on latents.  On the card the samplers'
denoiser is DDPM's CUDA graph, and the train step, the first-stage encode
included, is captured by ``train_step_n`` (``models/base.py``); the decode
(quantise and decoder, once a sample) stays eager.
"""
from __future__ import annotations

import logging
from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.state import TrainState
from ..ops import diffusion as gd
from .base import ValidationResult
from .ddpm import DDPM
from .vqvae import VectorQuantizer

log = logging.getLogger(__name__)

FIRST_STAGE = ("encoder", "decoder", "vq")


class LatentScale(nn.Module):
    """The resolved latent scale, a float32 buffer ``scale`` of shape ()."""

    def __init__(self, value: float):
        super().__init__()
        self.value = float(value)
        self.register_buffer("scale", torch.tensor(self.value))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(self.value)


class LatentDDPM(DDPM):
    def __init__(self, datamodule: Any, encoder: Any = None, decoder: Any = None,
                 latent_dim: int = 64, num_embeddings: int = 512,
                 first_stage_ckpt: str = "", latent_scale="auto",
                 codebook_update: str = "gradient", **ddpm_kwargs):
        """Same keyword arguments as ``igm_tpu``'s LatentDDPM; the DDPM ones
        (``device`` included) go to :class:`DDPM`."""
        # the UNet is built inside DDPM.__init__ with denoise_channels
        self._latent_dim = int(latent_dim)
        super().__init__(datamodule, **ddpm_kwargs)
        # a float fixes the scale; "auto" (or 0) calibrates it to 1/std of
        # the encoder latents in on_fit_start
        self._cfg_scale = 0.0 if str(latent_scale) == "auto" else float(latent_scale)
        self.save_hyperparameters(latent_dim=self._latent_dim,
                                  num_embeddings=int(num_embeddings),
                                  latent_scale=self._cfg_scale,
                                  codebook_update=str(codebook_update),
                                  first_stage_ckpt=str(first_stage_ckpt or ""))
        self.latent_h = self.height // 4          # the vqvae nets downsample 4x
        self.latent_w = self.width // 4
        self.modules = nn.ModuleDict({
            "denoise": self.modules["denoise"],
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=self._latent_dim),
            "decoder": instantiate(decoder, input_channel=self._latent_dim,
                                   output_channel=self.channels),
            "vq": VectorQuantizer(int(num_embeddings), self._latent_dim,
                                  ema=(codebook_update == "ema")),
            "latent": LatentScale(self._cfg_scale if self._cfg_scale > 0 else 1.0)})
        self.modules.eval()
        self.init_params(0)

    # ----------------------------------------------------- DDPM space hooks
    @property
    def x0_bound(self) -> float:
        """0: no implied-x0 clip.  The calibrated unit-variance latents are
        unbounded (the LDM recipe clips nothing in latent space), so DDIM's
        clip-consistent branch is skipped too."""
        return 0.0

    @property
    def denoise_channels(self) -> int:
        return self._latent_dim

    def _sample_shape(self, n: int) -> tuple:
        return (n, self.latent_h, self.latent_w, self._latent_dim)

    def _to_diffusion_space(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.encode(imgs)

    # -------------------------------------------------------- first stage
    @property
    def scale(self) -> torch.Tensor:
        return self.modules["latent"].scale

    @torch.no_grad()
    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """Preprocessed images -> latents times the scale (the encoder only:
        no quantisation)."""
        return self.modules["encoder"](imgs.float()) * self.scale

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> images: divide by the scale, quantise through the
        codebook (float32, the kernel's type), decode."""
        z = z.float() / self.scale
        quant, *_ = self.modules["vq"](z, train=False)
        imgs = self.modules["decoder"](quant)
        return imgs.reshape(z.shape[0], self.height, self.width, self.channels)

    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the denoiser only; the latent scale at its configured
        value (1.0 for auto, until on_fit_start); the first stage from
        ``first_stage_ckpt`` where one is named."""
        state = super().init_state(seed)
        ckpt = str(self.hparams.first_stage_ckpt or "")
        if ckpt:
            self._load_first_stage(ckpt)
        return state

    @torch.no_grad()
    def on_fit_start(self, state: TrainState, train_arrays) -> TrainState:
        """``latent_scale=auto``: 1/std of the frozen encoder's latents over
        the first 256 training images (the LDM ``scale_factor`` recipe), the
        population std as ``jnp.std`` takes it.  Deterministic for the same
        first stage and data, and the trainer restores a checkpoint after
        this, so a resumed run keeps its saved value."""
        if self._cfg_scale > 0:
            return state
        imgs = self.preprocess(torch.from_numpy(train_arrays[0][:256]))
        z = self.modules["encoder"](imgs)
        std = torch.clamp(z.std(correction=0), min=1e-6)
        self.scale.copy_(1.0 / std)
        log.info(
            "latent_scale=auto: encoder latent std %.4f -> scale %.4f",
            float(std), float(self.scale))
        return state

    def _load_first_stage(self, ckpt: str) -> None:
        """Splice the encoder, decoder and codebook of the newest checkpoint
        in the port's checkpoint directory ``ckpt``, or of the converted
        ``igm_tpu`` checkpoint ``ckpt`` (an ``.npz``)."""
        from ..core.checkpoint import read_checkpoint
        raw = read_checkpoint(ckpt)["params"]
        for name in FIRST_STAGE:
            prefix = f"{name}."
            got = {k[len(prefix):]: v for k, v in raw.items() if k.startswith(prefix)}
            if not got:
                raise ValueError(f"first_stage_ckpt {ckpt} has no '{name}' "
                                 "params - not a vqvae checkpoint?")
            module = self.modules[name]
            have_shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
            got_shapes = {k: tuple(v.shape) for k, v in got.items()}
            if have_shapes != got_shapes:
                raise ValueError(
                    f"first-stage '{name}' shape mismatch (config vs "
                    f"checkpoint):\n  config    {have_shapes}\n  checkpoint {got_shapes}")
            module.load_state_dict(got, strict=True)

    # -------------------------------------------------------------- output
    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        return self.decode(super().sample(n, generator, y=y))

    @torch.no_grad()
    def ddim_sample(self, n: int, steps: int = 50, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None, y=None,
                    guidance: float = 1.0, clip_denoised: bool = True,
                    x_T: Optional[torch.Tensor] = None, noises=None) -> torch.Tensor:
        return self.decode(super().ddim_sample(
            n, steps=steps, eta=eta, generator=generator, y=y, guidance=guidance,
            clip_denoised=clip_denoised, x_T=x_T, noises=noises))

    @torch.no_grad()
    def dpm_sample(self, n: int, steps: int = 20, y=None, guidance: float = 1.0,
                   schedule: Optional[str] = None,
                   generator: Optional[torch.Generator] = None,
                   x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(super().dpm_sample(
            n, steps=steps, y=y, guidance=guidance, schedule=schedule,
            generator=generator, x_T=x_T))

    @torch.no_grad()
    def inpaint(self, x0: torch.Tensor, mask: torch.Tensor, resample: int = 1,
                y=None, guidance: float = 1.0,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None, draws=None) -> torch.Tensor:
        """Latent-space RePaint: x0 (preprocessed images) is encoded, the
        pixel mask is min-pooled to the latent grid (a latent cell is known
        only where every pixel it covers is known), DDPM's ``inpaint`` runs
        on the latents (``x_T`` and ``draws`` in latent shape), the result is
        decoded and the known pixels are composited back exactly."""
        mask = torch.broadcast_to(mask, x0.shape).to(x0.dtype)
        n, h, w = x0.shape[:3]
        fh, fw = h // self.latent_h, w // self.latent_w
        zmask = (mask.amin(dim=-1)
                 .reshape(n, self.latent_h, fh, self.latent_w, fw)
                 .amin(dim=(2, 4))[..., None])
        z = super().inpaint(self._to_diffusion_space(x0), zmask, resample=resample,
                            y=y, guidance=guidance, generator=generator, x_T=x_T,
                            draws=draws)
        return mask * x0 + (1.0 - mask) * self.decode(z)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: torch.Generator, sample: bool = False):
        """The batch, its first-stage reconstruction (the ceiling of what the
        diffusion can give), the latents diffused to t = T-1 and decoded,
        and with ``sample`` decoded samples from ``val_sampler``."""
        imgs = self.preprocess(batch[0])
        z = self.encode(imgs)
        recon = self.decode(z)
        metrics = {"val/first_stage_recon_mse": ((recon - imgs) ** 2).mean()}
        t = torch.full((imgs.shape[0],), self.timesteps - 1, dtype=torch.long,
                       device=self.device)
        zt = gd.q_sample(self.tables, z, t, self._noise(z.shape, generator))
        result = ValidationResult(real_image=imgs, others={
            "first_stage_recon": recon, "diffusion": self.decode(zt)})
        if sample:
            result.fake_image = self._validation_samples(generator)
        return result, metrics
