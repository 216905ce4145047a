"""DDPM sampling: counterpart of ``igm_tpu/models/ddpm.py``'s constructor,
denoiser call, classifier-free guidance, and the ancestral and DDIM samplers.

``igm_tpu`` runs each chain as one ``lax.scan``; here it is a Python loop
over the timesteps, one UNet forward per step.  Random draws take an
explicit ``torch.Generator``; for tests, the samplers also take the initial
``x`` and the per-step noise as tensors.

Not yet ported (they wait for later slices): ``train_step``,
``validation_step``, ``dpm_sample``, ``interpolate``, ``inpaint``, and the
DiT backbone.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..networks.unet import Unet
from ..ops import diffusion as gd
from .base import BaseModel


class DDPM(BaseModel):
    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 timesteps: int = 1000, loss_type: str = "l1",
                 dim_mults: Sequence[int] = (1, 2, 4, 8), lr: float = 2e-4,
                 b1: float = 0.5, b2: float = 0.999, optim: str = "adam",
                 beta_schedule: str = "cosine", sample_batch: int = 64,
                 compute_dtype: str = "auto", remat: bool = False,
                 ema_decay: float = 0.0, val_sampler: str = "ancestral",
                 ddim_steps: int = 50, dpm_steps: int = 20,
                 dpm_schedule: str = "uniform",
                 pallas_gn: str | bool = "auto",
                 num_classes: int | None = 0, cond_drop_prob: float = 0.1,
                 guidance_scale: float = 2.0, network: str = "unet",
                 parameterization: str = "eps", snr_gamma: float = 0.0,
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s DDPM, plus ``device``
        (the card unless the CPU is asked for).

        ``compute_dtype="auto"`` is bfloat16 on CUDA and float32 on the CPU.
        ``pallas_gn`` and ``remat`` are accepted and have no effect: on the
        card the GroupNorm+Mish kernel always runs, and nothing here trains.
        The DiT-only keywords (``depth``, ``heads``, ``moe_*``, ...) land in
        ``kwargs`` and are ignored with the unet backbone.
        """
        super().__init__(datamodule, device)
        if parameterization not in ("eps", "v"):
            raise ValueError(f"parameterization must be eps|v, "
                             f"got {parameterization!r}")
        if network != "unet":
            raise NotImplementedError(
                f"network={network!r}: the port has the unet backbone only")
        self.num_classes = int(num_classes or 0)
        self.save_hyperparameters(hidden_dim=hidden_dim, timesteps=timesteps,
                                  loss_type=loss_type,
                                  dim_mults=list(dim_mults), lr=lr, b1=b1,
                                  b2=b2, beta_schedule=beta_schedule,
                                  sample_batch=sample_batch,
                                  ema_decay=ema_decay,
                                  val_sampler=val_sampler,
                                  ddim_steps=ddim_steps, dpm_steps=dpm_steps,
                                  dpm_schedule=dpm_schedule,
                                  num_classes=self.num_classes,
                                  cond_drop_prob=cond_drop_prob,
                                  guidance_scale=guidance_scale,
                                  network=network,
                                  parameterization=parameterization,
                                  snr_gamma=snr_gamma)
        self.timesteps = int(timesteps)
        self.tables = gd.make_tables(self.timesteps, beta_schedule, self.device)
        if compute_dtype == "auto":
            compute_dtype = ("bfloat16" if self.device.type == "cuda"
                             else "float32")
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.modules = nn.ModuleDict({"denoise": Unet(
            dim=hidden_dim, channels=self.channels, dim_mults=tuple(dim_mults),
            num_classes=self.num_classes, dtype=dtype)})
        self.modules.eval()
        self.init_params(0)

    def _sample_shape(self, n: int) -> tuple:
        return (n, self.height, self.width, self.channels)

    def _noise(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    # --------------------------------------------------------------- sampling
    def _denoise(self, x: torch.Tensor, t: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.num_classes and y is None:
            # unconditional generation from a conditional model = the
            # trained null token
            y = torch.full((x.shape[0],), self.num_classes, dtype=torch.long,
                           device=x.device)
        return self.modules["denoise"](x, t, y)

    @torch.no_grad()
    def _eps(self, x: torch.Tensor, t: torch.Tensor,
             y: Optional[torch.Tensor] = None,
             guidance: float = 1.0) -> torch.Tensor:
        """Noise prediction with optional classifier-free guidance,
        ``eps = eps_null + s * (eps_y - eps_null)``; the two branches run as
        one doubled batch.  A v-predicting network is converted to eps here,
        the one choke point every sampler goes through."""
        if self.num_classes == 0 or y is None or guidance == 1.0:
            out = self._denoise(x, t, y)
        else:
            null = torch.full_like(y, self.num_classes)
            out2 = self._denoise(torch.cat([x, x]), torch.cat([t, t]),
                                 torch.cat([y, null]))
            out_y, out_null = torch.chunk(out2, 2)
            out = out_null + guidance * (out_y - out_null)
        if self.hparams.parameterization == "v":
            out = gd.eps_from_v(self.tables, x, t.long(), out)
        return out

    @property
    def x0_bound(self) -> float:
        """Clamp for implied-x0 predictions inside the samplers: images are
        normalized to [-1, 1]."""
        return 1.0

    def _clip_x0(self, x0: torch.Tensor) -> torch.Tensor:
        b = self.x0_bound
        return torch.clamp(x0, -b, b) if b > 0 else x0

    @torch.no_grad()
    def p_sample(self, x: torch.Tensor, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 clip_denoised: bool = True, y=None, guidance: float = 1.0,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step p(x_{t-1} | x_t); ``t`` is a (N,) integer batch.
        ``noise`` replaces the step's N(0, I) draw."""
        eps = self._eps(x, t.float(), y, guidance)
        x_recon = gd.predict_start_from_noise(self.tables, x, t, eps)
        if clip_denoised:
            x_recon = self._clip_x0(x_recon)
        mean, _var, log_var = gd.q_posterior(self.tables, x_recon, x, t)
        if noise is None:
            noise = self._noise(x.shape, generator)
        nonzero = (t > 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    @torch.no_grad()
    def p_sample_loop(self, shape, generator: Optional[torch.Generator] = None,
                      t_start: Optional[int] = None,
                      init_x: Optional[torch.Tensor] = None, y=None,
                      guidance: float = 1.0,
                      noises: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """The full ancestral chain.  ``noises[i]`` replaces the i-th step's
        draw (steps counted from t_start - 1 down to 0)."""
        t_start = self.timesteps if t_start is None else t_start
        x = self._noise(shape, generator) if init_x is None else init_x
        for i, t in enumerate(range(t_start - 1, -1, -1)):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=self.device)
            x = self.p_sample(x, tb, generator, y=y, guidance=guidance,
                              noise=None if noises is None else noises[i])
        return x

    def _default_labels(self, n: int) -> torch.Tensor:
        """Contiguous class blocks: with n a multiple of the grid row the
        sample grid shows one class per row."""
        return torch.arange(n, device=self.device) * self.num_classes // n

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        guidance = 1.0
        if self.num_classes:
            if y is None:
                y = self._default_labels(n)
            guidance = float(self.hparams.guidance_scale)
        return self.p_sample_loop(self._sample_shape(n), generator, y=y,
                                  guidance=guidance)

    @torch.no_grad()
    def ddim_sample(self, n: int, steps: int = 50, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None, y=None,
                    guidance: float = 1.0, clip_denoised: bool = True,
                    x_T: Optional[torch.Tensor] = None,
                    noises: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """DDIM (Song et al. 2021) over an evenly spaced timestep
        subsequence; eta=0 is the deterministic sampler.  When
        ``clip_denoised`` bounds the implied x0, eps is re-derived from the
        clipped x0 so the (x0, eps) pair stays consistent, as in
        ``igm_tpu``.  ``x_T`` replaces the initial draw and ``noises[i]``
        the i-th step's."""
        shape = self._sample_shape(n)
        x = self._noise(shape, generator) if x_T is None else x_T
        seq = np.round(np.linspace(0, self.timesteps - 1, steps)).astype(np.int64)
        seq_prev = np.concatenate([[-1], seq[:-1]])
        acp = self.tables.alphas_cumprod
        one = torch.ones((), device=self.device)
        for i, (t, t_prev) in enumerate(zip(seq[::-1], seq_prev[::-1])):
            tb = torch.full((n,), int(t), dtype=torch.long, device=self.device)
            eps = self._eps(x, tb.float(), y, guidance)
            a_t = acp[int(t)]
            a_prev = acp[int(t_prev)] if t_prev >= 0 else one
            x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
            if clip_denoised and self.x0_bound > 0:
                x0 = self._clip_x0(x0)
                eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
            sigma = (eta * torch.sqrt((1 - a_prev) / (1 - a_t))
                     * torch.sqrt(1 - a_t / a_prev))
            dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
            if t_prev >= 0 and eta > 0:
                noise = (self._noise(shape, generator) if noises is None
                         else noises[i])
                x = x + sigma * noise
        return x
