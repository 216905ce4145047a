"""Gaussian-diffusion schedule tables + transition math.

Counterpart of ``igm_tpu/ops/diffusion.py``.  The tables are computed in
float64 numpy and cast to float32 once, exactly as there, so the two
packages hold bit-equal tables; the per-step math is elementwise torch on
whatever device the tables live on.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


class DiffusionTables(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor


def make_tables(timesteps: int, schedule: str = "cosine",
                device: torch.device | str = "cpu") -> DiffusionTables:
    betas = (cosine_beta_schedule(timesteps) if schedule == "cosine"
             else linear_beta_schedule(timesteps))
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return DiffusionTables(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev)
                                 / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                 / (1.0 - alphas_cumprod)),
    )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] broadcast to an image batch of rank ``ndim``."""
    out = table[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(tables: DiffusionTables, x_start, t, noise):
    """Forward noising q(x_t | x_0)."""
    return (extract(tables.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(tables.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
            * noise)


def predict_start_from_noise(tables: DiffusionTables, x_t, t, noise):
    return (extract(tables.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(tables.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def q_posterior(tables: DiffusionTables, x_start, x_t, t):
    mean = (extract(tables.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(tables.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = extract(tables.posterior_variance, t, x_t.ndim)
    log_var = extract(tables.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def eps_from_v(tables: DiffusionTables, x_t, t, v):
    """Convert a v prediction (v = sqrt(ac)*eps - sqrt(1-ac)*x0) to an eps
    prediction (exact identity)."""
    return (extract(tables.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * x_t
            + extract(tables.sqrt_alphas_cumprod, t, x_t.ndim) * v)


def v_target(tables: DiffusionTables, x_start, t, noise):
    """Training target for parameterization="v":
    sqrt(ac) * eps - sqrt(1-ac) * x0."""
    return (extract(tables.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - extract(tables.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
            * x_start)


def snr(tables: DiffusionTables, t, ndim: int):
    """Signal-to-noise ratio ac_t / (1 - ac_t), broadcast to rank ndim."""
    ac = extract(tables.alphas_cumprod, t, ndim)
    return ac / (1.0 - ac)


def loss_weight(tables: DiffusionTables, t, ndim: int, parameterization: str,
                snr_gamma: float):
    """Min-SNR-gamma per-timestep loss weight (Hang et al. 2023):
    min(SNR, gamma) / SNR for eps, min(SNR, gamma) / (SNR + 1) for v.
    ``snr_gamma <= 0`` gives weight 1, a (1,)*ndim tensor of ones."""
    if snr_gamma <= 0:
        return torch.ones((1,) * ndim, device=tables.betas.device)
    s = snr(tables, t, ndim)
    capped = torch.clamp(s, max=snr_gamma)
    if parameterization == "v":
        return capped / (s + 1.0)
    return capped / s
