"""The Frechet distance machinery of the FID callback: the port's own copy
of ``igm_tpu/callbacks/fid.py``.

``FeatureStats`` and ``frechet_distance`` run on the host in float64 (scipy's
``sqrtm``), as there.  The feature extractors run on the model's device:

- ``inception``: :class:`InceptionFeatures`, InceptionV3 pool3 features
  from the npz ``IGM_INCEPTION_WEIGHTS`` names, read only when that file
  exists (no weights are fetched);
- ``random_torch``: :class:`RandomConvFeatures`, a frozen random conv net
  (4 x conv 3x3 stride 2 SAME + ReLU, the global mean).  ``igm_tpu`` draws
  its weights with ``jax.random.PRNGKey(0)``, which the port cannot; the
  port draws them from a seeded ``torch.Generator``, so its distances are
  not ``igm_tpu``'s ``metrics/fid_random`` and are logged under a tag of
  their own, ``metrics/fid_random_torch``.  Given ``igm_tpu``'s weights
  (``net``'s ``Conv_i`` hold them as OIHW) it computes ``igm_tpu``'s
  features.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.platform import resolve_device

log = logging.getLogger(__name__)


class FeatureStats:
    """Streaming mean / second moment accumulator in float64 (host)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(axis=0)
        self.outer += feats.T @ feats

    def finalize(self):
        mu = self.sum / max(self.n, 1)
        cov = (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(c1 + c2 - 2 sqrt(c1 c2)) (torchmetrics' math)."""
    import scipy.linalg
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


def _on_device(imgs, device) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs.to(device)
    return torch.from_numpy(np.ascontiguousarray(imgs)).to(device)


def _rgb(x: torch.Tensor) -> torch.Tensor:
    """Grayscale tiled to RGB (torchmetrics' FID takes 3 channels)."""
    return x.expand(*x.shape[:3], 3) if x.shape[-1] == 1 else x


def _same_pad(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """Flax's ``padding="SAME"`` on NCHW: out = ceil(n / s), the extra pixel
    at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _RandomNet(nn.Module):
    WIDTHS = (64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        cin = 3
        for i, c in enumerate(self.WIDTHS):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, c, 3, 2))
            cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(len(self.WIDTHS)):
            x = F.relu(getattr(self, f"Conv_{i}")(_same_pad(x)))
        return x.mean(dim=(2, 3))


class RandomConvFeatures:
    """A frozen random conv net on ``device``: lecun_normal kernels drawn
    from ``torch.Generator().manual_seed(seed)`` on the CPU (the same weights
    on every device), zero biases."""

    DIM = 512

    def __init__(self, seed: int = 0, device: str | torch.device | None = None):
        from ..networks.base import lecun_normal_
        self.net = _RandomNet()
        generator = torch.Generator().manual_seed(int(seed))
        for m in self.net.children():
            w = m.weight
            lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
            with torch.no_grad():
                m.bias.zero_()
        self.device = resolve_device(device)
        self.net.to(self.device).requires_grad_(False)

    @torch.no_grad()
    def __call__(self, imgs_uint8) -> np.ndarray:
        """uint8 NHWC -> (N, 512) float32 features on the host."""
        x = _on_device(imgs_uint8, self.device).float() / 127.5 - 1.0
        return self.net(_rgb(x)).cpu().numpy()


class InceptionFeatures:
    """InceptionV3 pool3 features on ``device`` from a local weights npz."""

    DIM = 2048

    def __init__(self, weights_path: str, device: str | torch.device | None = None):
        from ..networks.inception import load_weights_npz
        self.device = resolve_device(device)
        self.net = load_weights_npz(weights_path).to(self.device).requires_grad_(False)

    @torch.no_grad()
    def __call__(self, imgs_uint8) -> np.ndarray:
        """uint8 NHWC -> (N, 2048): [0, 1], bilinear to 299 x 299
        (``align_corners=False``, no antialias: ``jax.image.resize``'s
        bilinear when it upsamples, as every FID input here does), then
        2x - 1."""
        x = _rgb(_on_device(imgs_uint8, self.device).float() / 255.0)
        if x.shape[1] > 299 or x.shape[2] > 299:
            raise ValueError(f"{tuple(x.shape)}: the resize to 299 matches "
                             "jax.image.resize only when it upsamples")
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=False).permute(0, 2, 3, 1)
        return self.net(2.0 * x - 1.0).cpu().numpy()


_BACKEND_CACHE: dict = {}


def get_feature_backend(name: Optional[str] = None,
                        device: str | torch.device | None = None):
    """(extractor, dim, backend name) on ``device``.  ``name`` None picks
    ``inception`` when ``IGM_INCEPTION_WEIGHTS`` is set; ``inception`` with
    no such file warns and takes the random net, as ``igm_tpu`` does;
    ``random`` is the port's own random net, ``random_torch``.  ``device``
    None is the card (``utils.platform.resolve_device``)."""
    device = resolve_device(device)
    if name is None:
        name = "inception" if os.environ.get("IGM_INCEPTION_WEIGHTS") else "random_torch"
    if name == "random":
        name = "random_torch"
    if name == "inception":
        weights = os.environ.get("IGM_INCEPTION_WEIGHTS", "")
        if weights and os.path.exists(weights):
            key = ("inception", weights, str(device))
            if key not in _BACKEND_CACHE:
                fe = InceptionFeatures(weights, device)
                _BACKEND_CACHE[key] = (fe, fe.DIM, "inception")
            return _BACKEND_CACHE[key]
        log.warning("inception backend requested but IGM_INCEPTION_WEIGHTS=%r does not "
                    "exist: the random backend stands in (its distances are not "
                    "comparable to published Inception FIDs)", weights)
        name = "random_torch"
    if name != "random_torch":
        raise ValueError(f"FID backend {name!r} (expected inception or random)")
    key = ("random_torch", str(device))
    if key not in _BACKEND_CACHE:
        fe = RandomConvFeatures(device=device)
        _BACKEND_CACHE[key] = (fe, fe.DIM, "random_torch")
    return _BACKEND_CACHE[key]
