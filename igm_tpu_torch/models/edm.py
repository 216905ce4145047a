"""EDM (Karras et al. 2022): counterpart of ``igm_tpu/models/edm.py``.

Training: sigma ~ LogNormal(p_mean, p_std), x_sigma = x + sigma * n, the
preconditioned denoiser

    D(x; sigma) = c_skip(sigma) x + c_out(sigma) F(c_in(sigma) x, c_noise(sigma))

and the loss mean(lambda * (D(x_sigma; sigma) - x)^2) with lambda =
1 / c_out^2; conditional models drop labels to the null token with
``cond_drop_prob``; an EMA shadow with ``ema_decay > 0``.  ``F`` is the
shared backbone (``build_denoiser``: the UNet or the DiT) under the module
key ``denoise``.  c_noise = ln(sigma)/4 is mapped affinely onto the
backbones' timestep range, ``(ln(sigma)/4 + 2) * 250``, as in ``igm_tpu``.

Sampling: the deterministic Heun sampler over the Karras sigma grid
(Alg. 1, churn-free): ``sample_steps - 1`` Heun pairs, then one final D
at the last nonzero sigma (the Euler step to 0 is exactly D), so 18 steps
make 35 network forwards; classifier-free guidance runs both branches as
one doubled batch.  ``igm_tpu`` runs the chain as one ``lax.scan``; here
it is a Python loop whose network call is ``BaseModel.network`` (on the
card a CUDA graph per input signature, with the EMA weights).  The step
coefficients are float32, as the scan computes them.  For tests, the
train step takes its draws as tensors and ``heun_sample`` its initial
N(0, I) draw.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from .base import BaseModel, ValidationResult, draw_labels
from .ddpm import build_denoiser

# c_noise = ln(sigma)/4 mapped onto the timestep embedding's [0, 1000) range
_CN_SHIFT, _CN_SCALE = 2.0, 250.0


def _c_skip(sigma, sd):
    return sd ** 2 / (sigma ** 2 + sd ** 2)


def _c_out(sigma, sd):
    return sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)


def _c_in(sigma, sd):
    return 1.0 / torch.sqrt(sigma ** 2 + sd ** 2)


def _c_noise(sigma):
    return (torch.log(sigma) / 4.0 + _CN_SHIFT) * _CN_SCALE


def karras_sigmas(steps: int, sigma_min: float, sigma_max: float,
                  rho: float) -> np.ndarray:
    """Descending Karras sigma grid with the terminal 0 appended (paper
    eq. 5), float32."""
    i = np.linspace(0.0, 1.0, steps)
    grid = (sigma_max ** (1 / rho)
            + i * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.append(grid, 0.0).astype(np.float32)


class EDM(BaseModel):
    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4), lr: float = 2e-4,
                 b1: float = 0.9, b2: float = 0.999, sigma_data: float = 0.5,
                 p_mean: float = -1.2, p_std: float = 1.2, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, rho: float = 7.0, sample_steps: int = 18,
                 sample_batch: int = 64, compute_dtype: str = "auto",
                 remat: bool = False, ema_decay: float = 0.0,
                 num_classes: int | None = 0, cond_drop_prob: float = 0.1,
                 guidance_scale: float = 2.0, network: str = "unet", depth: int = 8,
                 heads: int = 6, patch: int = 2, attention: str = "auto",
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s EDM, plus ``device`` (the
        card unless the CPU is asked for).  ``compute_dtype="auto"`` is
        bfloat16 on CUDA and float32 on the CPU."""
        super().__init__(datamodule, device)
        self.num_classes = int(num_classes or 0)
        self.save_hyperparameters(
            hidden_dim=hidden_dim, dim_mults=list(dim_mults), lr=lr, b1=b1, b2=b2,
            sigma_data=sigma_data, p_mean=p_mean, p_std=p_std, sigma_min=sigma_min,
            sigma_max=sigma_max, rho=rho, sample_steps=sample_steps,
            sample_batch=sample_batch, ema_decay=ema_decay,
            num_classes=self.num_classes, cond_drop_prob=cond_drop_prob,
            guidance_scale=guidance_scale, network=network, depth=depth, heads=heads,
            patch=patch)
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.modules = nn.ModuleDict({"denoise": build_denoiser(
            network, hidden_dim=hidden_dim, channels=self.channels, dim_mults=dim_mults,
            dtype=dtype, num_classes=self.num_classes, remat=bool(remat), depth=depth,
            heads=heads, patch=patch, attention=attention)})
        self.modules.eval()
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the denoiser; with ``ema_decay > 0`` the EMA shadow."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add("opt", adam(hp.lr, hp.b1, hp.b2), ["denoise"])
        state = self.make_state(seed)
        self.init_ema(state, "denoise")
        self.state = state
        return state

    # ------------------------------------------------------------ denoiser D
    def _D(self, x: torch.Tensor, sigma: torch.Tensor, y=None,
           guidance: float = 1.0) -> torch.Tensor:
        """Preconditioned denoiser D(x; sigma), ``sigma`` a (N,) batch, with
        optional classifier-free guidance (D is linear in F, so it combines
        identically before or after the preconditioning)."""
        sd = float(self.hparams.sigma_data)
        sb = sigma.reshape(-1, *([1] * (x.ndim - 1)))
        x_in = _c_in(sb, sd) * x
        cn = _c_noise(sigma)
        if self.num_classes == 0 or y is None or guidance == 1.0:
            f = self.network("denoise", x_in, cn, y)
        else:
            null = torch.full_like(y, self.num_classes)
            f2 = self.network("denoise", torch.cat([x_in, x_in]), torch.cat([cn, cn]),
                              torch.cat([y, null]))
            f_y, f_null = torch.chunk(f2, 2)
            f = f_null + guidance * (f_y - f_null)
        return _c_skip(sb, sd) * x + _c_out(sb, sd) * f.to(x.dtype)

    # ------------------------------------------------------------------ train
    def loss(self, x: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor,
             y: Optional[torch.Tensor] = None):
        """The EDM loss for clean images ``x`` at noise levels ``sigma`` (N,)
        -> (loss, metrics)."""
        sd = float(self.hparams.sigma_data)
        sb = sigma.reshape(-1, *([1] * (x.ndim - 1)))
        x_sigma = x + sb * noise
        lam = (sb ** 2 + sd ** 2) / (sb * sd) ** 2            # = 1 / c_out^2
        f = self.modules["denoise"](_c_in(sb, sd) * x_sigma, _c_noise(sigma), y)
        d = _c_skip(sb, sd) * x_sigma + _c_out(sb, sd) * f.to(x.dtype)
        loss = torch.mean(lam * (d - x) ** 2)
        return loss, {"train_loss/loss": loss.detach()}

    def train_step(self, state: TrainState, batch,
                   sigma_draw: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None):
        """One Adam step on the denoiser, then the EMA update.  Draws from
        ``state.generator``, in this order, what is not given: the N(0, 1)
        ``sigma_draw`` behind ln(sigma) = p_mean + p_std * sigma_draw, the
        noise, and (conditional) the label-drop mask."""
        imgs_raw, labels = batch
        x = self.preprocess(imgs_raw)
        n = x.shape[0]
        gen = state.generator
        hp = self.hparams
        if sigma_draw is None:
            sigma_draw = self.batch_draw(torch.randn, (n,), gen)
        if noise is None:
            noise = self.batch_draw(torch.randn, x.shape, gen)
        y = draw_labels(self, labels, n, gen, drop)
        sigma = torch.exp(float(hp.p_mean) + float(hp.p_std) * sigma_draw)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(x, sigma, noise, y))
        finally:
            self.modules.eval()
        self.update_ema(state, "denoise")
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def heun_sample(self, n: int, steps: Optional[int] = None, y=None,
                    guidance: float = 1.0, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic Heun over the Karras grid of ``steps`` (default
        ``sample_steps``) sigmas; ``noise`` replaces the initial N(0, I)
        draw, which is scaled by sigma_max."""
        hp = self.hparams
        steps = int(hp.sample_steps) if steps is None else int(steps)
        sigmas = karras_sigmas(steps, float(hp.sigma_min), float(hp.sigma_max),
                               float(hp.rho))
        shape = (n, self.height, self.width, self.channels)
        if noise is None:
            noise = self.batch_draw(torch.randn, shape, generator)
        x = noise * float(sigmas[0])
        for s_cur, s_next in zip(sigmas[:-2], sigmas[1:-1]):
            ds = float(s_next - s_cur)                        # float32, as the scan's
            d = (x - self._D(x, torch.full((n,), float(s_cur), device=self.device),
                             y, guidance)) / float(s_cur)
            x_euler = x + ds * d
            d2 = (x_euler - self._D(x_euler, torch.full((n,), float(s_next),
                                                        device=self.device),
                                    y, guidance)) / float(s_next)
            x = x + ds * 0.5 * (d + d2)
        return self._D(x, torch.full((n,), float(sigmas[-2]), device=self.device),
                       y, guidance)

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        guidance = 1.0
        if self.num_classes:
            if y is None:
                y = self._default_labels(n)
            guidance = float(self.hparams.guidance_scale)
        return torch.clamp(self.heun_sample(n, y=y, guidance=guidance,
                                            generator=generator), -1.0, 1.0)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        result = ValidationResult(real_image=self.preprocess(batch[0]))
        if sample:
            result.fake_image = self.sample(int(self.hparams.sample_batch), generator)
        return result, {}
