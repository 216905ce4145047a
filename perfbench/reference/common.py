"""Plain PyTorch pieces the references share: the cosine diffusion tables,
the DDPM l1 eps-loss train step under Adam, DPM-Solver++(2M) and the
precisions a reference computes in.

Nothing here imports the program (``igm_tpu_torch``) or JAX: the
references are written from the published descriptions and the
configuration's sizes, and work out again whatever the program derives
from the benchmark's inputs (the tables, the step coefficients, the
timestep and noise draws from the generator seed).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

TIMESTEPS = 1000
ADAM_EPS = 1e-8


# ------------------------------------------------------------- precisions
class _FakeFP8(torch.autograd.Function):
    """A tensor rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude maps to 448), its gradient rounded to float8 e5m2 the same way
    (largest to 57344): the arithmetic of an fp8 training step whose
    products accumulate in float32."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FakeFP8.apply(x)


#: what a reference rounds the operands of each product to: ``float32``
#: computes in float32 (TF32 off); ``fp8`` is the control, the step below
#: the configuration's bfloat16
PRECISIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": identity, "fp8": fp8}


def full_float32() -> None:
    """Products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------- the schedule
def cosine_tables(timesteps: int = TIMESTEPS) -> Dict[str, np.ndarray]:
    """Nichol & Dhariwal's cosine schedule (s = 0.008, betas clipped at
    0.999), in float64, then float32 as the tables are kept."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    acp = np.cos(((x / steps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    acp = acp / acp[0]
    betas = np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)
    acp = np.cumprod(1.0 - betas)
    return {"alphas_cumprod": acp.astype(np.float32),
            "sqrt_acp": np.sqrt(acp).astype(np.float32),
            "sqrt_1m_acp": np.sqrt(1.0 - acp).astype(np.float32),
            "sqrt_recip_acp": np.sqrt(1.0 / acp).astype(np.float32),
            "sqrt_recipm1_acp": np.sqrt(1.0 / acp - 1.0).astype(np.float32)}


def _col(table: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(t.device)[t].reshape(-1, 1, 1, 1)


def images(raw: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 in [-1, 1]."""
    return raw.float() / 255.0 * 2.0 - 1.0


def draw_step(generator: torch.Generator, n: int, shape: Sequence[int], device
              ) -> tuple:
    """A train step's draws, in the order the step makes them: the
    timesteps U{0..T-1}, then N(0, I) noise of the image batch's shape."""
    t = torch.randint(0, TIMESTEPS, (n,), generator=generator, device=device)
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    return t, noise


# ------------------------------------------------------------ train steps
def train_steps(forward: Callable, params0: Dict[str, torch.Tensor],
                batches: Sequence[torch.Tensor], generator: torch.Generator,
                lr: float, b1: float, b2: float, aux_weight: float = 0.0,
                precision: str = "float32", steps: int = 3,
                rows: Optional[slice] = None) -> dict:
    """``steps`` Adam steps of the l1 eps-loss from ``params0`` on the uint8
    ``batches`` (each the global batch), the draws made from ``generator``
    at the global batch.  ``forward(params, x, t, q)`` -> (eps prediction,
    mean MoE aux or 0).  ``rows`` takes the loss over those rows alone (the
    fault of a rank whose gradient is not exchanged, or half a batch).

    Returns each step's loss, the first step's gradient by leaf and the
    parameters after the last step."""
    q = PRECISIONS[precision]
    tables = cosine_tables()
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for step in range(steps):
        x0 = images(batches[step].to(generator.device))
        t, noise = draw_step(generator, x0.shape[0], x0.shape, x0.device)
        x_t = _col(tables["sqrt_acp"], t) * x0 + _col(tables["sqrt_1m_acp"], t) * noise
        pred, aux = forward(params, x_t, t, q)
        err = (noise - pred).abs()
        if rows is not None:
            err = err[rows]
        loss = err.mean() + aux_weight * aux
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        count = step + 1
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if step == 0:
                    grad1 = grad1 or {}
                    grad1[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** count)
                vhat = v2[k] / (1 - b2 ** count)
                p.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
        del grads
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()}}


# ------------------------------------------------------- DPM-Solver++(2M)
def dpm_timesteps(steps: int, timesteps: int = TIMESTEPS) -> np.ndarray:
    """The uniform schedule's ascending timesteps."""
    return np.linspace(0, timesteps - 1, steps).round().astype(np.int32)


@torch.no_grad()
def dpm_sample(eps_fn: Callable, x_t: torch.Tensor, steps: int = 20) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095), data
    prediction, half-log-SNR steps: first order at the first and the last
    step, the last to alpha 1, sigma 0; the implied x0 clamped to [-1, 1]
    at every step; the sample clamped to [-1, 1] at the end, as the sampler
    service returns it.  ``eps_fn(x, t)`` is the network."""
    tables = cosine_tables()
    acp = tables["alphas_cumprod"].astype(np.float64)
    seq = dpm_timesteps(steps)
    t_next = np.concatenate([[-1], seq[:-1]])

    def lam(a):
        return 0.5 * (math.log(a) - math.log1p(-a))

    x = x_t.float()
    x0_prev, h_prev = None, 0.0
    for t, tn in zip(seq[::-1].tolist(), t_next[::-1].tolist()):
        a_cur = float(acp[t])
        sigma_cur, lam_cur = math.sqrt(1 - a_cur), lam(a_cur)
        final = tn < 0
        if final:
            alpha_n, sigma_n, lam_n = 1.0, 0.0, lam_cur + 30.0
        else:
            a_next = float(acp[tn])
            alpha_n, sigma_n, lam_n = math.sqrt(a_next), math.sqrt(1 - a_next), lam(a_next)
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, tb)
        x0 = (_col(tables["sqrt_recip_acp"], tb) * x
              - _col(tables["sqrt_recipm1_acp"], tb) * eps).clamp(-1.0, 1.0)
        h = lam_n - lam_cur
        d = x0
        if h_prev != 0 and not final:
            r = h_prev / h
            d = x0 + (x0 - x0_prev) / max(2.0 * r, 1e-12)
        x = (sigma_n / sigma_cur) * x - (alpha_n * math.expm1(-h)) * d
        x0_prev, h_prev = x0, h
    return x.clamp(-1.0, 1.0)


# ----------------------------------------------------------- comparisons
def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> tuple:
    """The widest gap between two leaf norms, over the leaves (all of
    ``want``'s by default), against the larger of the reference's leaf norm
    and the median of its leaf norms -> (gap, leaf)."""
    keys = list(want) if leaves is None else leaves
    median = float(np.median([want[k] for k in want])) if want else 0.0
    worst, name = 0.0, None
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], median, 1e-30)
        if gap > worst or name is None:
            worst, name = gap, k
    return worst, name


def moving_leaves(grad_norms: Dict[str, float], floor: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``floor`` times the median leaf's.  The others (a bias under a
    normalisation) move under Adam by round-off alone."""
    median = float(np.median(list(grad_norms.values())))
    return [k for k, g in grad_norms.items() if g >= floor * median]
