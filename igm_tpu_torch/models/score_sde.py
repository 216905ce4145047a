"""Score-SDE (Song et al., ICLR 2021): counterpart of
``igm_tpu/models/score_sde.py``, with its three SDEs (``sde=ve|vp|subvp``).

The data is perturbed by the kernel ``x_t = m(t) x_0 + sigma(t) z``: VE
m = 1, sigma(t) = sigma_min (sigma_max / sigma_min)^t; VP m = exp(-B/2),
sigma = sqrt(1 - exp(-B)); sub-VP the same m, sigma = 1 - exp(-B), with
B(t) the integral of the linear beta(t).  The network ``F`` (the shared
backbone from ``build_denoiser`` under the module key ``denoise``) is
conditioned on the scale-free level sigma/m through EDM's ``_c_noise`` and
regresses -z, so the score is F / sigma and the sigma^2-weighted
denoising score matching loss is ``mean((F + z)^2)``.  Training draws
t ~ U(0, 1) for VE and U(t_eps, 1) for VP and sub-VP.

Samplers: the predictor-corrector loop (VE: the reverse-diffusion
predictor over the geometric sigma grid; VP: the ancestral predictor with
the kernel-exact per-step beta; sub-VP: Euler-Maruyama; then
``corrector_steps`` annealed-Langevin steps with the per-sample SNR step
size, and a Tweedie denoise at the end), and the probability-flow ODE
(Heun).  A PC chain of ``steps`` levels with M correctors makes
(steps - 1)(1 + M) + 1 network forwards; the ODE 2 (steps - 1) + 1.
``igm_tpu`` runs each chain as one ``lax.scan``; here it is a Python loop
whose network call is ``BaseModel.network`` (on the card a CUDA graph per
input signature, with the EMA weights).  The coefficient grids are
computed in float64 numpy and cast to float32, and the per-step
coefficients are float32 numpy scalars, as the scan computes them.  For
tests, the train step takes its draws as tensors and the samplers their
N(0, I) draws as a list ``noises``, in the order they are drawn.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from .base import BaseModel, ValidationResult, noise_source
from .ddpm import build_denoiser
from .edm import _c_noise

F32 = np.float32


def ve_sigma_grid(steps: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """Descending geometric sigma grid sigma_max -> sigma_min, float32."""
    return np.geomspace(sigma_max, sigma_min, steps).astype(np.float32)


def vp_B(t, beta_min: float, beta_max: float):
    """``B(t)``, the integral of the linear ``beta(t) = beta_min + t (beta_max
    - beta_min)`` from 0 to t; numpy or torch."""
    return beta_min * t + 0.5 * (beta_max - beta_min) * t * t


def _xp(t):
    return torch if isinstance(t, torch.Tensor) else np


class ScoreSDE(BaseModel):
    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4), lr: float = 2e-4,
                 b1: float = 0.9, b2: float = 0.999,
                 sigma_min: float = 0.01, sigma_max: float = 50.0,
                 sample_steps: int = 64, corrector_steps: int = 1,
                 snr: float = 0.16, sampler: str = "pc", sde: str = "ve",
                 beta_min: float = 0.1, beta_max: float = 20.0, t_eps: float = 1e-3,
                 sample_batch: int = 64, compute_dtype: str = "auto",
                 remat: bool = False, ema_decay: float = 0.0,
                 network: str = "unet", depth: int = 8, heads: int = 6,
                 patch: int = 2, attention: str = "auto",
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s ScoreSDE, plus ``device``
        (the card unless the CPU is asked for).  ``compute_dtype="auto"`` is
        bfloat16 on CUDA and float32 on the CPU."""
        super().__init__(datamodule, device)
        if sampler not in ("pc", "ode"):
            raise ValueError(f"sampler must be pc|ode, got {sampler!r}")
        if sde not in ("ve", "vp", "subvp"):
            raise ValueError(f"sde must be ve|vp|subvp, got {sde!r}")
        self.num_classes = 0
        self.save_hyperparameters(
            hidden_dim=hidden_dim, dim_mults=list(dim_mults), lr=lr, b1=b1, b2=b2,
            sigma_min=sigma_min, sigma_max=sigma_max, sample_steps=sample_steps,
            corrector_steps=corrector_steps, snr=snr, sampler=sampler, sde=sde,
            beta_min=beta_min, beta_max=beta_max, t_eps=t_eps,
            sample_batch=sample_batch, ema_decay=ema_decay, network=network,
            depth=depth, heads=heads, patch=patch)
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.modules = nn.ModuleDict({"denoise": build_denoiser(
            network, hidden_dim=hidden_dim, channels=self.channels, dim_mults=dim_mults,
            dtype=dtype, num_classes=0, remat=bool(remat), depth=depth, heads=heads,
            patch=patch, attention=attention)})
        self.modules.eval()
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the network; with ``ema_decay > 0`` the EMA shadow."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add("opt", adam(hp.lr, hp.b1, hp.b2), ["denoise"])
        state = self.make_state(seed)
        self.init_ema(state, "denoise")
        self.state = state
        return state

    # ------------------------------------------------------------ the SDEs
    def _sigma_of_t(self, t):
        lo, hi = float(self.hparams.sigma_min), float(self.hparams.sigma_max)
        return lo * (hi / lo) ** t

    def _kernel(self, t):
        """The perturbation kernel's (m(t), sigma(t)); numpy or torch."""
        hp = self.hparams
        if hp.sde == "ve":
            return t * 0.0 + 1.0, self._sigma_of_t(t)
        xp = _xp(t)
        B = vp_B(t, float(hp.beta_min), float(hp.beta_max))
        m = xp.exp(-0.5 * B)
        sigma = xp.sqrt(1.0 - xp.exp(-B)) if hp.sde == "vp" else 1.0 - xp.exp(-B)
        return m, sigma

    def _beta(self, t):
        hp = self.hparams
        return float(hp.beta_min) + t * (float(hp.beta_max) - float(hp.beta_min))

    def _g2(self, t):
        """g(t)^2 of the forward SDE: VP beta(t); sub-VP beta(t)(1 - exp(-2B))."""
        hp = self.hparams
        if hp.sde == "vp":
            return self._beta(t)
        B = vp_B(t, float(hp.beta_min), float(hp.beta_max))
        return self._beta(t) * (1.0 - _xp(t).exp(-2.0 * B))

    def _beta_g2_f32(self, t: F32) -> tuple:
        """(beta(t), g(t)^2) at one float32 time, in float32 with float32
        constants, as the scan evaluates ``_beta`` and ``_g2`` on a traced
        time."""
        hp = self.hparams
        lo = F32(hp.beta_min)
        span = float(hp.beta_max) - float(hp.beta_min)
        beta = lo + t * F32(span)
        if hp.sde == "vp":
            return beta, beta
        B = lo * t + F32(0.5 * span) * t * t
        return beta, beta * (F32(1.0) - np.exp(F32(-2.0) * B))

    # ----------------------------------------------------------- the score
    def score(self, x: torch.Tensor, sigma: torch.Tensor, m: float = 1.0) -> torch.Tensor:
        """s(x, sigma) = F(x, c_noise(sigma / m)) / sigma, ``sigma`` (N,),
        through ``BaseModel.network``."""
        f = self.network("denoise", x, _c_noise(sigma / m))
        return f.to(x.dtype) / sigma.reshape(-1, *([1] * (x.ndim - 1)))

    def _full(self, n: int, value) -> torch.Tensor:
        return torch.full((n,), float(value), device=self.device)

    # ------------------------------------------------------------------ train
    def loss(self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor):
        """The DSM loss mean((F + z)^2) for clean images ``x``, times ``t``
        (N,) and noise ``z`` -> (loss, metrics)."""
        mean_c, sigma = self._kernel(t)
        bshape = (-1, *([1] * (x.ndim - 1)))
        x_t = mean_c.reshape(bshape) * x + sigma.reshape(bshape) * z
        f = self.modules["denoise"](x_t, _c_noise(sigma / mean_c))
        loss = torch.mean((f.to(x.dtype) + z) ** 2)
        return loss, {"train_loss/loss": loss.detach()}

    def train_step(self, state: TrainState, batch, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """One Adam step, then the EMA update.  Draws from
        ``state.generator``, in this order, what is not given: t (U(0, 1)
        for VE, U(t_eps, 1) otherwise) and the noise."""
        x = self.preprocess(batch[0])
        n = x.shape[0]
        gen = state.generator
        if t is None:
            t = self.batch_draw(torch.rand, (n,), gen)
            if self.hparams.sde != "ve":
                lo = float(self.hparams.t_eps)
                t = t * (1.0 - lo) + lo
        if noise is None:
            noise = self.batch_draw(torch.randn, x.shape, gen)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(x, t, noise))
        finally:
            self.modules.eval()
        self.update_ema(state, "denoise")
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    def _langevin(self, x, sig, m, alpha, n: int, r: float, draw):
        """One annealed-Langevin corrector step, eps = 2 alpha (r |z| / |s|)^2
        per sample."""
        axes = tuple(range(1, x.ndim))
        s = self.score(x, self._full(n, sig), m)
        z = draw()
        z_norm = torch.sqrt(torch.sum(z ** 2, dim=axes, keepdim=True))
        s_norm = torch.sqrt(torch.sum(s ** 2, dim=axes, keepdim=True))
        eps = (2.0 * alpha) * (r * z_norm / torch.clamp(s_norm, min=1e-12)) ** 2
        return x + eps * s + torch.sqrt(2.0 * eps) * z

    @torch.no_grad()
    def pc_sample(self, n: int, steps: Optional[int] = None,
                  corrector_steps: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Predictor-corrector sampling over ``steps`` levels (default
        ``sample_steps``) with ``corrector_steps`` Langevin steps each."""
        hp = self.hparams
        steps = int(hp.sample_steps) if steps is None else int(steps)
        m_corr = int(hp.corrector_steps) if corrector_steps is None else int(corrector_steps)
        r = float(hp.snr)
        shape = (n, self.height, self.width, self.channels)
        draw = noise_source(self, shape, generator, noises)
        if hp.sde != "ve":
            return self._pc_sample_vp(n, steps, m_corr, r, draw)
        grid = ve_sigma_grid(steps, float(hp.sigma_min), float(hp.sigma_max))
        x = draw() * float(grid[0])
        for s_cur, s_next in zip(grid[:-1], grid[1:]):
            var = s_cur * s_cur - s_next * s_next               # float32
            s = self.score(x, self._full(n, s_cur))
            x = x + float(var) * s + float(np.sqrt(var)) * draw()
            for _ in range(m_corr):
                x = self._langevin(x, s_next, 1.0, 1.0, n, r, draw)
        s = self.score(x, self._full(n, grid[-1]))
        return x + float(grid[-1] * grid[-1]) * s

    def _pc_sample_vp(self, n: int, steps: int, m_corr: int, r: float, draw):
        """VP / sub-VP over the linear t grid 1 -> t_eps: the ancestral
        predictor with beta_i = 1 - exp(-(B(t_i) - B(t_i+1))) (VP) or
        Euler-Maruyama of the reverse SDE (sub-VP), Langevin with alpha_i =
        exp(-dB), then the scaled Tweedie denoise."""
        hp = self.hparams
        tg = np.linspace(1.0, float(hp.t_eps), steps, dtype=np.float64)
        m_g, s_g = self._kernel(tg)
        B = vp_B(tg, float(hp.beta_min), float(hp.beta_max))
        alpha_d = np.exp(-(B[:-1] - B[1:]))
        coefs = np.stack([m_g[:-1], s_g[:-1], m_g[1:], s_g[1:], 1.0 - alpha_d,
                          self._beta(tg[:-1]), self._g2(tg[:-1]), tg[:-1] - tg[1:]],
                         axis=1).astype(np.float32)
        x = draw()
        one = F32(1.0)
        for m_cur, s_cur, m_next, s_next, beta_d, beta_t, g2, dt in coefs:
            s = self.score(x, self._full(n, s_cur), float(m_cur))
            z = draw()
            if hp.sde == "vp":
                x = (float(F32(2.0) - np.sqrt(one - beta_d)) * x + float(beta_d) * s
                     + float(np.sqrt(beta_d)) * z)
            else:
                x = (x + (float(F32(0.5) * beta_t) * x + float(g2) * s) * float(dt)
                     + float(np.sqrt(g2 * dt)) * z)
            for _ in range(m_corr):
                x = self._langevin(x, s_next, float(m_next), float(one - beta_d), n, r, draw)
        s = self.score(x, self._full(n, s_g[-1]), float(m_g[-1]))
        return (x + float(s_g[-1] ** 2) * s) / float(m_g[-1])

    @torch.no_grad()
    def ode_sample(self, n: int, steps: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Heun on the probability-flow ODE: VE dx/dsigma = -sigma s over the
        geometric grid, VP / sub-VP dx/dt = -beta/2 x - g^2/2 s over the
        linear t grid; then the Tweedie denoise."""
        hp = self.hparams
        steps = int(hp.sample_steps) if steps is None else int(steps)
        shape = (n, self.height, self.width, self.channels)
        x = noise_source(self, shape, generator, noises)()
        if hp.sde != "ve":
            return self._ode_sample_vp(n, steps, x)
        grid = ve_sigma_grid(steps, float(hp.sigma_min), float(hp.sigma_max))
        x = x * float(grid[0])

        def d(x, sigma):
            return float(-sigma) * self.score(x, self._full(n, sigma))

        for s_cur, s_next in zip(grid[:-1], grid[1:]):
            ds = s_next - s_cur
            d1 = d(x, s_cur)
            d2 = d(x + float(ds) * d1, s_next)
            x = x + float(ds * F32(0.5)) * (d1 + d2)
        s = self.score(x, self._full(n, grid[-1]))
        return x + float(grid[-1] * grid[-1]) * s

    def _ode_sample_vp(self, n: int, steps: int, x: torch.Tensor) -> torch.Tensor:
        hp = self.hparams
        tg = np.linspace(1.0, float(hp.t_eps), steps, dtype=np.float64)
        m_g, s_g = self._kernel(tg)
        coefs = np.stack([tg[:-1], tg[1:], m_g[:-1], s_g[:-1], m_g[1:], s_g[1:]],
                         axis=1).astype(np.float32)

        def d(x, t, sig, mc):
            s = self.score(x, self._full(n, sig), float(mc))
            beta, g2 = self._beta_g2_f32(t)
            return float(F32(-0.5) * beta) * x - float(F32(0.5) * g2) * s

        for t_cur, t_next, m_cur, s_cur, m_next, s_next in coefs:
            dt = t_next - t_cur
            d1 = d(x, t_cur, s_cur, m_cur)
            d2 = d(x + float(dt) * d1, t_next, s_next, m_next)
            x = x + float(dt * F32(0.5)) * (d1 + d2)
        s = self.score(x, self._full(n, s_g[-1]), float(m_g[-1]))
        return (x + float(s_g[-1] ** 2) * s) / float(m_g[-1])

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               **kw) -> torch.Tensor:
        """``model.sampler``'s chain (pc or ode), clipped to [-1, 1]."""
        fn = self.pc_sample if self.hparams.sampler == "pc" else self.ode_sample
        return torch.clamp(fn(n, generator=generator, **kw), -1.0, 1.0)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        result = ValidationResult(real_image=self.preprocess(batch[0]))
        if sample:
            result.fake_image = self.sample(int(self.hparams.sample_batch), generator)
        return result, {}
