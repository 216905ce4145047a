"""Decoder output distributions of the VAE family: counterpart of
``igm_tpu/utils/distributions.py``.  ``prob`` is log p(x|z) summed over the
pixel axes, one value a sample; the callers take the batch mean."""
from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def get_decode_dist(name: str):
    if name == "gaussian":
        return GaussianDistribution()
    if name == "bernoulli":
        return BernoulliDistribution()
    raise NotImplementedError(f"decoder_dist={name!r}")


class GaussianDistribution:
    """Unit-variance Gaussian likelihood; ``sample`` is the mean."""

    def prob(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        ll = -0.5 * (target - pred) ** 2 - _LOG_SQRT_2PI
        return ll.reshape(ll.shape[0], -1).sum(dim=-1)

    def sample(self, pred: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return pred


class BernoulliDistribution:
    """Bernoulli likelihood on probabilities in [0, 1] (clipped to [1e-7,
    1 - 1e-7]); ``sample`` draws from ``generator``, or is the mean image
    without one."""

    def prob(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        eps = 1e-7
        p = torch.clamp(pred, eps, 1.0 - eps)
        ll = target * torch.log(p) + (1.0 - target) * torch.log1p(-p)
        return ll.reshape(ll.shape[0], -1).sum(dim=-1)

    def sample(self, pred: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            return pred
        u = torch.rand(pred.shape, generator=generator, device=pred.device)
        return (u < pred).to(pred.dtype)
