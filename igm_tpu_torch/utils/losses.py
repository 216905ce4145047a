"""Losses of the VAE/GAN zoo: counterpart of ``igm_tpu/utils/losses.py``.

The hinge loss is the standard one (both branches ``max(0, 1 -+ pred)``),
as ``igm_tpu`` fixed the reference's real branch.
"""
from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy, ``igm_tpu``'s stable form:
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def adversarial_loss(pred: torch.Tensor, target_is_real: bool = True,
                     loss_mode: str = "vanilla") -> torch.Tensor:
    """GAN adversarial loss: vanilla (BCE), lsgan (MSE), hinge."""
    if loss_mode == "vanilla":
        target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
        return bce_with_logits(pred, target).mean()
    if loss_mode == "lsgan":
        target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
        return ((pred - target) ** 2).mean()
    if loss_mode == "hinge":
        if target_is_real:
            return torch.clamp(1.0 - pred, min=0.0).mean()
        return torch.clamp(1.0 + pred, min=0.0).mean()
    raise NotImplementedError(f"loss_mode={loss_mode!r}")


def normal_kld(mu: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)), summed over the latent axis, mean over
    the batch."""
    kl = -0.5 * torch.sum(1.0 + 2.0 * log_sigma - mu ** 2 - torch.exp(2.0 * log_sigma),
                          dim=-1)
    return kl.mean()


def symmetry_contra_loss(feat1: torch.Tensor, feat2: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """CLIP-style symmetric InfoNCE over a batch of paired features: the
    mean of the row-wise and column-wise cross-entropies of
    ``feat1 @ feat2.T / temperature`` against the diagonal (no config uses
    it)."""
    logits = feat1 @ feat2.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (torch.nn.functional.cross_entropy(logits, labels)
            + torch.nn.functional.cross_entropy(logits.T, labels)) / 2.0
