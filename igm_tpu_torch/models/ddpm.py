"""DDPM: counterpart of ``igm_tpu/models/ddpm.py``'s constructor, train
state, train step (l1/l2 loss on an eps or v target, Min-SNR weight,
classifier-free-guidance label drop, EMA shadow), validation step, denoiser
call, classifier-free guidance, and the ancestral and DDIM samplers.

``igm_tpu`` runs each chain as one ``lax.scan``; here it is a Python loop
over the timesteps, one UNet forward per step.  Random draws take an
explicit ``torch.Generator`` (training: the TrainState's); for tests, the
train step also takes its timesteps, noise and label drop as tensors, and
the samplers the initial ``x`` and the per-step noise.

``denoise_channels``, ``_sample_shape`` and ``_to_diffusion_space`` are the
hooks through which ``LatentDDPM`` diffuses in a VQ-VAE's latent space.

Not yet ported (they wait for later slices): ``dpm_sample`` (and so
``val_sampler=dpm``), ``interpolate``, ``inpaint``, and the DiT backbone.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.unet import Unet
from ..ops import diffusion as gd
from .base import BaseModel, ValidationResult


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
        ``pallas_gn`` is accepted and has no effect: on the card the
        GroupNorm+Mish kernels always run.  ``remat`` recomputes each UNet
        ResnetBlock in the backward.  ``optim`` is accepted; the optimizer is
        Adam, as in ``igm_tpu``.  The DiT-only keywords (``depth``,
        ``heads``, ``moe_*``, ...) land in ``kwargs`` and are ignored with
        the unet backbone.
        """
        super().__init__(datamodule, device)
        if parameterization not in ("eps", "v"):
            raise ValueError(f"parameterization must be eps|v, "
                             f"got {parameterization!r}")
        if loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type={loss_type!r}")
        if val_sampler == "dpm":
            raise NotImplementedError("val_sampler=dpm: the port has no "
                                      "dpm_sample yet (ancestral|ddim)")
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
            dim=hidden_dim, channels=self.denoise_channels, dim_mults=tuple(dim_mults),
            num_classes=self.num_classes, dtype=dtype, remat=bool(remat))})
        self.modules.eval()
        self.init_params(0)

    # hooks overridden by LatentDDPM (diffusion in a learned latent space)
    @property
    def denoise_channels(self) -> int:
        return self.channels

    def _sample_shape(self, n: int) -> tuple:
        return (n, self.height, self.width, self.channels)

    def _to_diffusion_space(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs

    # ------------------------------------------------------------------ train
    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the denoiser; with ``ema_decay > 0`` the EMA shadow of
        its parameters under ``opt_states["ema"]``."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add(
            "opt", adam(hp.lr, hp.b1, hp.b2), ["denoise"])
        state = self.make_state(seed)
        if hp.ema_decay > 0:
            state.opt_states["ema"] = {
                k: p.detach().clone()
                for k, p in self.modules["denoise"].named_parameters()}
        self.state = state
        return state

    def loss(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             y: Optional[torch.Tensor] = None):
        """The training loss for clean images ``x_start`` (model space),
        integer timesteps ``t``, noise and (conditional) labels ``y`` ->
        (loss, metrics)."""
        hp = self.hparams
        x_noisy = gd.q_sample(self.tables, x_start, t, noise)
        if hp.parameterization == "v":
            target = gd.v_target(self.tables, x_start, t, noise)
        else:
            target = noise
        w = gd.loss_weight(self.tables, t, x_start.ndim, str(hp.parameterization),
                           float(hp.snr_gamma))
        pred = self.modules["denoise"](x_noisy, t, y)
        if hp.loss_type == "l1":
            loss = (w * torch.abs(target - pred)).mean()
        else:
            loss = (w * (target - pred) ** 2).mean()
        return loss, {"train_loss/loss": loss.detach()}

    def train_step(self, state: TrainState, batch,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None):
        """One Adam step on the denoiser, then the EMA update.

        Draws, from ``state.generator`` in this order, what is not given:
        the timesteps ``t`` ~ U{0..T-1}, the noise, and (conditional) the
        label-drop mask with probability ``cond_drop_prob``: dropped labels
        become the null token."""
        imgs_raw, labels = batch
        imgs = self._to_diffusion_space(self.preprocess(imgs_raw))
        n = imgs.shape[0]
        gen = state.generator
        if t is None:
            t = torch.randint(0, self.timesteps, (n,), generator=gen,
                              device=self.device)
        if noise is None:
            noise = torch.randn(imgs.shape, generator=gen, device=self.device)
        y = None
        if self.num_classes:
            if drop is None:
                drop = (torch.rand(n, generator=gen, device=self.device)
                        < float(self.hparams.cond_drop_prob))
            labels = labels.to(self.device, non_blocking=True).long()
            y = torch.where(drop, torch.full_like(labels, self.num_classes), labels)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(imgs, t, noise, y))
        finally:
            self.modules.eval()
        d = float(self.hparams.ema_decay)
        if d > 0:
            ema = state.opt_states["ema"]
            params = dict(self.modules["denoise"].named_parameters())
            with torch.no_grad():
                shadow = list(ema.values())
                torch._foreach_mul_(shadow, d)
                torch._foreach_add_(shadow, [params[k] for k in ema], alpha=1.0 - d)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: torch.Generator, sample: bool = False):
        """The batch, the batch diffused to t = T-1, and with ``sample`` a
        ``sample_batch`` of samples from ``val_sampler`` (ancestral|ddim)."""
        imgs = self.preprocess(batch[0])
        n = imgs.shape[0]
        t = torch.full((n,), self.timesteps - 1, dtype=torch.long,
                       device=self.device)
        diffused = gd.q_sample(self.tables, imgs, t,
                               self._noise(imgs.shape, generator))
        result = ValidationResult(real_image=imgs, others={"diffusion": diffused})
        if sample:
            result.fake_image = self._validation_samples(generator)
        return result, {}

    def _validation_samples(self, generator: torch.Generator) -> torch.Tensor:
        """``sample_batch`` samples from ``val_sampler`` (ancestral|ddim)."""
        n_s = int(self.hparams.sample_batch)
        if self.hparams.val_sampler == "ddim":
            cond = {}
            if self.num_classes:
                cond = dict(y=self._default_labels(n_s),
                            guidance=float(self.hparams.guidance_scale))
            return self.ddim_sample(n_s, steps=int(self.hparams.ddim_steps),
                                    generator=generator, **cond)
        return self.sample(n_s, generator)

    def _noise(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    # --------------------------------------------------------------- sampling
    def _denoise(self, x: torch.Tensor, t: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoiser; with an EMA shadow in the train state, run with the
        shadow's weights, as ``igm_tpu`` samples from them."""
        if self.num_classes and y is None:
            # unconditional generation from a conditional model = the
            # trained null token
            y = torch.full((x.shape[0],), self.num_classes, dtype=torch.long,
                           device=x.device)
        net = self.modules["denoise"]
        if (self.hparams.ema_decay > 0 and self.state is not None
                and "ema" in self.state.opt_states):
            return torch.func.functional_call(net, self.state.opt_states["ema"],
                                              (x, t, y))
        return net(x, t, y)

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
