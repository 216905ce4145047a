"""Consistency models trained by consistency training (Song et al. 2023,
with the iCT recipe of Song & Dhariwal 2023): counterpart of
``igm_tpu/models/consistency.py``.

The network learns the probability-flow ODE's solution map f(x_sigma,
sigma) -> x_0 in EDM's preconditioning, with the boundary anchored at
sigma_min so that f(x, sigma_min) = x exactly:

    f(x, sigma) = c_skip(sigma) x + c_out(sigma) F(c_in(sigma) x, c_noise(sigma))
    c_skip = sd^2 / ((sigma - sigma_min)^2 + sd^2)
    c_out  = sd (sigma - sigma_min) / sqrt(sigma^2 + sd^2)

Training over the fixed ascending Karras grid s_0 < ... < s_{N-1}: an
adjacent pair index i ~ p(i), iCT's discrete lognormal, x_hi = x + s_{i+1}
z and x_lo = x + s_i z with the same z, and the loss mean(lambda d(f(x_hi,
s_{i+1}), f-(x_lo, s_i))) with lambda = 1 / (s_{i+1} - s_i) and the
pseudo-Huber d = sqrt(|.|^2 + c^2) - c, c = 0.00054 sqrt(D).  The teacher
branch f- is the live network under ``no_grad`` (iCT's stop-gradient,
EMA decay 0), not the EMA shadow.  The index is drawn by Gumbel-max over
log p from the state's generator (the law of ``jax.random.categorical``),
so the whole step stays capturable as a CUDA graph.

Sampling (Algorithm 1, multistep): x ~ N(0, sigma_max^2 I), f = f(x,
sigma_max); then for each refinement level t_k, evenly spaced in grid
index strictly between sigma_max and sigma_min and deduplicated, x = f +
sqrt(t_k^2 - sigma_min^2) z and f = f(x, t_k): ``sample_steps`` network
forwards.  The network call is ``BaseModel.network`` (on the card a CUDA
graph per input signature, with the EMA weights).  For tests, the train
step takes its draws as tensors and ``multistep_sample`` its N(0, I)
draws as a list ``noises``, in the order they are drawn.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from .base import BaseModel, ValidationResult, noise_source
from .ddpm import build_denoiser
from .edm import _c_in, _c_noise, karras_sigmas

_erf = np.vectorize(math.erf, otypes=[np.float64])


def _c_skip_b(sigma, sd, smin):
    return sd ** 2 / ((sigma - smin) ** 2 + sd ** 2)


def _c_out_b(sigma, sd, smin):
    return sd * (sigma - smin) / torch.sqrt(sigma ** 2 + sd ** 2)


def lognormal_index_weights(sigmas: np.ndarray, p_mean: float, p_std: float) -> np.ndarray:
    """iCT eq. 13: the discrete lognormal weights of the adjacent grid pairs
    (len(sigmas) - 1 of them), float32."""
    z = (np.log(sigmas) - p_mean) / (np.sqrt(2.0) * p_std)
    w = _erf(z[1:]) - _erf(z[:-1])
    return (w / w.sum()).astype(np.float32)


class ConsistencyModel(BaseModel):
    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4), lr: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.995, sigma_data: float = 0.5,
                 sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0,
                 n_grid: int = 64, p_mean: float = -1.1, p_std: float = 2.0,
                 sample_steps: int = 2, sample_batch: int = 64,
                 compute_dtype: str = "auto", remat: bool = False,
                 ema_decay: float = 0.9995, num_classes: int | None = 0,
                 network: str = "unet", depth: int = 8, heads: int = 6,
                 patch: int = 2, attention: str = "auto",
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s ConsistencyModel, plus
        ``device`` (the card unless the CPU is asked for).
        ``compute_dtype="auto"`` is bfloat16 on CUDA and float32 on the CPU."""
        super().__init__(datamodule, device)
        self.num_classes = int(num_classes or 0)
        self.save_hyperparameters(
            hidden_dim=hidden_dim, dim_mults=list(dim_mults), lr=lr, b1=b1, b2=b2,
            sigma_data=sigma_data, sigma_min=sigma_min, sigma_max=sigma_max, rho=rho,
            n_grid=n_grid, p_mean=p_mean, p_std=p_std, sample_steps=sample_steps,
            sample_batch=sample_batch, ema_decay=ema_decay,
            num_classes=self.num_classes, network=network, depth=depth, heads=heads,
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
        grid = self._grid()
        hp = self.hparams
        # the grid and the index law, device constants of the train step
        self._sigmas = torch.from_numpy(grid.copy()).to(self.device)
        self._logp = torch.from_numpy(np.log(lognormal_index_weights(
            grid, float(hp.p_mean), float(hp.p_std)))).to(self.device)

    def _grid(self) -> np.ndarray:
        """The ascending Karras grid sigma_min .. sigma_max, float32."""
        hp = self.hparams
        return karras_sigmas(int(hp.n_grid), float(hp.sigma_min), float(hp.sigma_max),
                             float(hp.rho))[:-1][::-1]

    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the network; with ``ema_decay > 0`` the EMA shadow."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add("opt", adam(hp.lr, hp.b1, hp.b2), ["denoise"])
        state = self.make_state(seed)
        self.init_ema(state, "denoise")
        self.state = state
        return state

    # ------------------------------------------------------------ f(x, sigma)
    def _f(self, net, x: torch.Tensor, sigma: torch.Tensor, y=None) -> torch.Tensor:
        """The boundary-anchored consistency function through ``net(x_in,
        c_noise, y)``; ``sigma`` is (N,)."""
        hp = self.hparams
        sd, smin = float(hp.sigma_data), float(hp.sigma_min)
        sb = sigma.reshape(-1, *([1] * (x.ndim - 1)))
        out = net(_c_in(sb, sd) * x, _c_noise(sigma), y)
        return _c_skip_b(sb, sd, smin) * x + _c_out_b(sb, sd, smin) * out.to(x.dtype)

    def _f_ema(self, x: torch.Tensor, sigma: torch.Tensor, y=None) -> torch.Tensor:
        return self._f(lambda *a: self.network("denoise", *a), x, sigma, y)

    # ------------------------------------------------------------------ train
    def loss(self, x: torch.Tensor, i: torch.Tensor, z: torch.Tensor,
             y: Optional[torch.Tensor] = None):
        """The consistency-training loss for clean images ``x``, pair
        indices ``i`` (N,) and noise ``z`` -> (loss, metrics)."""
        s_lo, s_hi = self._sigmas[i], self._sigmas[i + 1]
        bshape = (-1, *([1] * (x.ndim - 1)))
        x_lo = x + s_lo.reshape(bshape) * z
        x_hi = x + s_hi.reshape(bshape) * z
        lam = 1.0 / (s_hi - s_lo)
        hub_c = 0.00054 * math.sqrt(float(np.prod(x.shape[1:])))
        net = self.modules["denoise"]
        f_hi = self._f(net, x_hi, s_hi, y)
        with torch.no_grad():
            f_lo = self._f(net, x_lo, s_lo, y)
        sq = torch.sum((f_hi - f_lo) ** 2, dim=tuple(range(1, x.ndim)))
        d = torch.sqrt(sq + hub_c ** 2) - hub_c
        loss = torch.mean(lam * d)
        return loss, {"train_loss/loss": loss.detach(),
                      "train_loss/raw_l2": torch.mean(sq).detach()}

    def draw_index(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n pair indices ~ p(i), by Gumbel-max over log p: on the device,
        without a host sync, so a CUDA graph can capture it."""
        u = self.batch_draw(torch.rand, (n, self._logp.shape[0]), generator)
        return torch.argmax(self._logp - torch.log(-torch.log(u)), dim=1)

    def train_step(self, state: TrainState, batch, i: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """One Adam step, then the EMA update.  Draws from
        ``state.generator``, in this order, what is not given: the pair
        index i (Gumbel-max over log p) and the noise."""
        imgs_raw, labels = batch
        x = self.preprocess(imgs_raw)
        n = x.shape[0]
        gen = state.generator
        if i is None:
            i = self.draw_index(n, gen)
        if noise is None:
            noise = self.batch_draw(torch.randn, x.shape, gen)
        y = labels.to(self.device, non_blocking=True).long() if self.num_classes else None
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(x, i, noise, y))
        finally:
            self.modules.eval()
        self.update_ema(state, "denoise")
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    def refinement_sigmas(self, steps: int) -> np.ndarray:
        """The descending float32 levels of the ``steps - 1`` refinements:
        evenly spaced in grid index strictly between sigma_max and
        sigma_min, deduplicated (fewer when ``steps`` nears ``n_grid``)."""
        grid = self._grid()[::-1]
        idx = np.linspace(0, len(grid) - 1, steps + 1).round().astype(int)
        return grid[np.unique(idx[1:-1])]

    @torch.no_grad()
    def multistep_sample(self, n: int, steps: Optional[int] = None,
                         generator: Optional[torch.Generator] = None, y=None,
                         noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Algorithm 1: one forward at sigma_max, then a refinement at each
        of :meth:`refinement_sigmas` (``steps`` default ``sample_steps``)."""
        hp = self.hparams
        steps = int(hp.sample_steps) if steps is None else int(steps)
        smin, smax = float(hp.sigma_min), float(hp.sigma_max)
        shape = (n, self.height, self.width, self.channels)
        draw = noise_source(self, shape, generator, noises)
        x = draw() * smax
        f = self._f_ema(x, torch.full((n,), smax, device=self.device), y)
        if steps <= 1:
            return f
        for t_k in self.refinement_sigmas(steps):
            scale = np.sqrt(np.maximum(t_k * t_k - np.float32(smin ** 2), np.float32(0.0)))
            f = self._f_ema(f + float(scale) * draw(),
                            torch.full((n,), float(t_k), device=self.device), y)
        return f

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        if self.num_classes and y is None:
            y = self._default_labels(n)
        return torch.clamp(self.multistep_sample(n, generator=generator, y=y), -1.0, 1.0)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        result = ValidationResult(real_image=self.preprocess(batch[0]))
        if sample:
            result.fake_image = self.sample(int(self.hparams.sample_batch), generator)
        return result, {}
