"""Rectified flow / conditional flow matching: counterpart of
``igm_tpu/models/flow_matching.py``.

    x_t = (1 - (1 - sigma_min) t) x0 + t x1,   x0 ~ N(0, I), x1 = data
    v*(x_t, t) = x1 - (1 - sigma_min) x0,      loss = mean((v* - v(x_t, t))^2)

with t ~ U[0, 1) scaled by ``TIME_SCALE`` onto the backbones' timestep
range.  The network (``build_denoiser``: the UNet or the DiT) sits under
the module key ``velocity``.  Conditional models drop labels to the null
token with ``cond_drop_prob``; ``ema_decay > 0`` keeps an EMA shadow.

Sampling integrates dx/dt = v(x, t) from t = 0 (noise) to 1 (data) with
``sample_steps`` fixed steps of Euler (one forward a step) or Heun (two,
the slopes at both ends averaged; the last sub-step evaluates at exactly
t = 1): 100 forwards at the default 50 Heun steps.  Guidance runs both
branches as one doubled batch; an unlabelled call of a conditional model
takes the null token.  ``igm_tpu`` runs the chain as one ``lax.scan``;
here it is a Python loop whose network call is ``BaseModel.network`` (on
the card a CUDA graph per input signature, with the EMA weights), the
times computed in float32 as the scan computes them.  For tests, the train
step takes its draws as tensors and ``ode_sample`` its initial draw.
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

# flow time lives in [0, 1]; the backbones' embedding is laid out for [0, 1000)
TIME_SCALE = 999.0


class FlowMatching(BaseModel):
    weights_module = "velocity"

    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4), lr: float = 2e-4,
                 b1: float = 0.9, b2: float = 0.999, sigma_min: float = 0.0,
                 sample_steps: int = 50, sampler: str = "heun", sample_batch: int = 64,
                 compute_dtype: str = "auto", remat: bool = False,
                 ema_decay: float = 0.0, num_classes: int | None = 0,
                 cond_drop_prob: float = 0.1, guidance_scale: float = 2.0,
                 network: str = "unet", depth: int = 8, heads: int = 6, patch: int = 2,
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s FlowMatching, plus
        ``device`` (the card unless the CPU is asked for).
        ``compute_dtype="auto"`` is bfloat16 on CUDA and float32 on the CPU."""
        super().__init__(datamodule, device)
        self.num_classes = int(num_classes or 0)
        self.save_hyperparameters(
            hidden_dim=hidden_dim, dim_mults=list(dim_mults), lr=lr, b1=b1, b2=b2,
            sigma_min=sigma_min, sample_steps=sample_steps, sampler=sampler,
            sample_batch=sample_batch, ema_decay=ema_decay,
            num_classes=self.num_classes, cond_drop_prob=cond_drop_prob,
            guidance_scale=guidance_scale, network=network, depth=depth, heads=heads,
            patch=patch)
        if sampler not in ("euler", "heun"):
            raise ValueError(f"sampler must be euler|heun, got {sampler!r}")
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.modules = nn.ModuleDict({"velocity": build_denoiser(
            network, hidden_dim=hidden_dim, channels=self.channels, dim_mults=dim_mults,
            dtype=dtype, num_classes=self.num_classes, remat=bool(remat), depth=depth,
            heads=heads, patch=patch)})
        self.modules.eval()
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the velocity network; with ``ema_decay > 0`` the EMA
        shadow."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add("opt", adam(hp.lr, hp.b1, hp.b2), ["velocity"])
        state = self.make_state(seed)
        self.init_ema(state, "velocity")
        self.state = state
        return state

    # ------------------------------------------------------------------ train
    def loss(self, x1: torch.Tensor, t: torch.Tensor, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None):
        """The flow-matching loss for data ``x1``, times ``t`` (N,) in [0, 1]
        and noise ``x0`` -> (loss, metrics)."""
        sm = float(self.hparams.sigma_min)
        tb = t.reshape(-1, *([1] * (x1.ndim - 1)))
        x_t = (1.0 - (1.0 - sm) * tb) * x0 + tb * x1
        target = x1 - (1.0 - sm) * x0
        pred = self.modules["velocity"](x_t, t * TIME_SCALE, y)
        loss = torch.mean((target - pred) ** 2)
        return loss, {"train_loss/loss": loss.detach()}

    def train_step(self, state: TrainState, batch, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None):
        """One Adam step, then the EMA update.  Draws from
        ``state.generator``, in this order, what is not given: t ~ U[0, 1),
        the noise x0, and (conditional) the label-drop mask."""
        imgs_raw, labels = batch
        x1 = self.preprocess(imgs_raw)
        n = x1.shape[0]
        gen = state.generator
        if t is None:
            t = self.batch_draw(torch.rand, (n,), gen)
        if noise is None:
            noise = self.batch_draw(torch.randn, x1.shape, gen)
        y = draw_labels(self, labels, n, gen, drop)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(x1, t, noise, y))
        finally:
            self.modules.eval()
        self.update_ema(state, "velocity")
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    def _velocity(self, x: torch.Tensor, t: np.float32, y=None,
                  guidance: float = 1.0) -> torch.Tensor:
        """v(x, t) at one float32 time ``t`` for the whole batch, with
        optional classifier-free guidance."""
        n = x.shape[0]
        tb = torch.full((n,), float(np.float32(t) * np.float32(TIME_SCALE)),
                        device=x.device)
        if self.num_classes == 0:
            return self.network("velocity", x, tb)
        if y is None:
            y = torch.full((n,), self.num_classes, dtype=torch.long, device=x.device)
        if guidance == 1.0:
            return self.network("velocity", x, tb, y)
        null = torch.full_like(y, self.num_classes)
        v2 = self.network("velocity", torch.cat([x, x]), torch.cat([tb, tb]),
                          torch.cat([y, null]))
        v_y, v_null = torch.chunk(v2, 2)
        return v_null + guidance * (v_y - v_null)

    @torch.no_grad()
    def ode_sample(self, n: int, steps: Optional[int] = None, y=None,
                   guidance: float = 1.0, generator: Optional[torch.Generator] = None,
                   x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Euler or Heun (``hparams.sampler``) over ``steps`` (default
        ``sample_steps``) fixed steps; ``x0`` replaces the initial draw."""
        steps = int(self.hparams.sample_steps) if steps is None else int(steps)
        shape = (n, self.height, self.width, self.channels)
        x = self.batch_draw(torch.randn, shape, generator) if x0 is None else x0
        dt = np.float32(1.0 / steps)
        heun = self.hparams.sampler == "heun"
        for i in range(steps):
            t = np.float32(i) * dt
            v = self._velocity(x, t, y, guidance)
            if heun:
                v2 = self._velocity(x + float(dt) * v, t + dt, y, guidance)
                v = 0.5 * (v + v2)
            x = x + float(dt) * v
        return x

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        guidance = 1.0
        if self.num_classes:
            if y is None:
                y = self._default_labels(n)
            guidance = float(self.hparams.guidance_scale)
        return torch.clamp(self.ode_sample(n, y=y, guidance=guidance,
                                           generator=generator), -1.0, 1.0)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        result = ValidationResult(real_image=self.preprocess(batch[0]))
        if sample:
            result.fake_image = self.sample(int(self.hparams.sample_batch), generator)
        return result, {}
