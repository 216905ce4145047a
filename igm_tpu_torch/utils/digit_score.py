"""Offline sample-quality score (digit IS): the port's counterpart of
``igm_tpu/utils/digit_score.py``.

A small CNN digit classifier, trained deterministically on the packaged
real digit scans (``data/packaged.py``: 1,437 for training, 360 for
validation, upscaled to the samples' geometry), scores generated samples:

- ``mean_confidence``: E[max_y p(y|x)]; blobs and noise score about
  0.1-0.4, clean digits 0.9 and more;
- ``coverage``: the distinct classes among confident (> 0.5) predictions;
  a collapsed generator scores low;
- ``inception_score``: exp(E[KL(p(y|x) || p(y))]), the Inception score
  with the digit classifier in Inception's place.

The weights are trained once a geometry and cached on disk as
``<cache_dir>/digit_classifier_torch_<h>x<w>.npz``, a name of the port's
own: ``igm_tpu``'s cache (``digit_classifier_<h>x<w>.npz``, leaves
``p0..p7``) never feeds the port, nor the port's it.
:func:`params_from_igm_tpu` reads ``igm_tpu``'s params when a caller asks.

The network is Flax's layer for layer: ``SAME`` padding at stride 2 pads
(0, 1) where the padding is odd (28 -> 14 -> 7), and ``Dense_0`` takes its
inputs in HWC order, as Flax flattens NHWC.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..networks.base import lecun_normal_

N_TRAIN = 1437
BATCH = 128
# the leaves of igm_tpu's param tree in Flax's order (its cache's p0..p7)
FLAX_PATHS = ("Conv_0/bias", "Conv_0/kernel", "Conv_1/bias", "Conv_1/kernel",
              "Dense_0/bias", "Dense_0/kernel", "Dense_1/bias", "Dense_1/kernel")

Params = Dict[str, torch.Tensor]


def _same(size: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """Flax's ``SAME`` padding (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class DigitCNN(nn.Module):
    """Two strided 3x3 convs (16, 32 channels, ReLU), then dense 64 (ReLU)
    and dense 10, on (N, H, W, 1) images in [-1, 1]."""

    def __init__(self, h: int = 28, w: int = 28):
        super().__init__()
        h2, w2 = -(-h // 2), -(-w // 2)
        h4, w4 = -(-h2 // 2), -(-w2 // 2)
        self.pads = ((_same(h), _same(w)), (_same(h2), _same(w2)))
        self.Conv_0 = nn.Conv2d(1, 16, 3, stride=2)
        self.Conv_1 = nn.Conv2d(16, 32, 3, stride=2)
        self.Dense_0 = nn.Linear(32 * h4 * w4, 64)
        self.Dense_1 = nn.Linear(64, 10)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's defaults: lecun_normal kernels, zero biases."""
        for layer in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv, ((hl, hh), (wl, wh)) in zip((self.Conv_0, self.Conv_1), self.pads):
            x = F.relu(conv(F.pad(x, (wl, wh, hl, hh))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)       # Flax's HWC order
        return self.Dense_1(F.relu(self.Dense_0(x)))


def classifier(params: Params, h: int, w: int) -> DigitCNN:
    """A ``DigitCNN`` for (h, w) holding ``params``, on their device, in
    eval mode."""
    device = next(iter(params.values())).device
    net = DigitCNN(h, w).to(device)
    net.load_state_dict(params, strict=True)
    return net.eval()


def params_from_igm_tpu(leaves: Sequence[np.ndarray] | Dict[str, np.ndarray],
                        device: str | torch.device = "cpu") -> Params:
    """``igm_tpu``'s DigitCNN params as the port's: its leaves in Flax's
    order (a list from ``jax.tree_util.tree_leaves``, or its cache's dict
    ``p0..p7``), or a dict by ``/``-joined path (a leading ``params/`` is
    dropped), converted through ``interop.flax_to_torch``."""
    from ..interop import flax_to_torch
    if isinstance(leaves, dict) and "p0" in leaves:
        leaves = [leaves[f"p{i}"] for i in range(len(leaves))]
    if isinstance(leaves, dict):
        flat = {k.removeprefix("params/"): np.asarray(v) for k, v in leaves.items()}
    elif len(leaves) == len(FLAX_PATHS):
        flat = dict(zip(FLAX_PATHS, (np.asarray(v) for v in leaves)))
    else:
        raise ValueError(f"expected {len(FLAX_PATHS)} leaves, got {len(leaves)}")
    return {k: v.to(device) for k, v in flax_to_torch(flat).items()}


def _digits_at(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real digit scans upscaled to (h, w), normalized to [-1, 1]."""
    from ..data.packaged import load_real_digits, upscale

    imgs, labels = load_real_digits()                  # (1797, 8, 8) uint8
    f = max(min(h, w) // 8, 1)
    imgs = upscale(imgs, f)
    hh, ww = imgs.shape[1:3]
    canvas = np.zeros((len(imgs), h, w), np.uint8)
    y0, x0 = max((h - hh) // 2, 0), max((w - ww) // 2, 0)
    canvas[:, y0:y0 + min(hh, h), x0:x0 + min(ww, w)] = \
        imgs[:, :min(hh, h), :min(ww, w)]
    x = canvas.astype(np.float32)[..., None] / 127.5 - 1.0
    return x, labels


def train_classifier(h: int = 28, w: int = 28, epochs: int = 30, seed: int = 0,
                     device: str | torch.device = "cpu",
                     init: Optional[Params] = None) -> Tuple[Params, float]:
    """Train on the first 1,437 scans and validate on the other 360:
    Adam at 1e-3 (optax's formula), softmax cross-entropy, batches of 128
    in a ``np.random.default_rng(seed)`` permutation an epoch, the remainder
    dropped.  ``init`` replaces the seeded Flax-style init.  Returns
    (params, validation accuracy)."""
    from ..core.optim import adam

    device = torch.device(device)
    x, y = _digits_at(h, w)
    xtr = torch.from_numpy(x[:N_TRAIN]).to(device)
    ytr = torch.from_numpy(y[:N_TRAIN].astype(np.int64)).to(device)
    net = DigitCNN(h, w)
    if init is None:
        net.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict({k: v.detach().cpu() for k, v in init.items()}, strict=True)
    net.to(device)
    opt = adam(1e-3).create(net.parameters())
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(N_TRAIN)).to(device)
        for i in range(0, N_TRAIN - BATCH + 1, BATCH):
            idx = order[i:i + BATCH]
            loss = F.cross_entropy(net(xtr[idx]), ytr[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    params = {k: v.detach() for k, v in net.state_dict().items()}
    return params, validation_accuracy(params, h, w)


@torch.no_grad()
def validation_logits(params: Params, h: int, w: int) -> torch.Tensor:
    """The classifier's logits on the 360 validation scans."""
    x, _ = _digits_at(h, w)
    net = classifier(params, h, w)
    return net(torch.from_numpy(x[N_TRAIN:]).to(next(net.parameters()).device))


def validation_accuracy(params: Params, h: int, w: int) -> float:
    _, y = _digits_at(h, w)
    pred = validation_logits(params, h, w).argmax(-1).cpu().numpy()
    return float((pred == y[N_TRAIN:]).mean())


def cache_path(cache_dir: str | Path, h: int, w: int) -> Path:
    return Path(cache_dir) / f"digit_classifier_torch_{h}x{w}.npz"


def load_or_train(cache_dir: str | Path, h: int = 28, w: int = 28,
                  device: str | torch.device = "cpu") -> Params:
    """The classifier's params for (h, w), from the port's cache in
    ``cache_dir`` or trained (validation accuracy > 0.90) and cached."""
    path = cache_path(cache_dir, h, w)
    if path.exists():
        with np.load(path) as npz:
            return {k: torch.from_numpy(npz[k]).to(device) for k in npz.files}
    params, acc = train_classifier(h, w, device=device)
    if acc <= 0.90:
        raise RuntimeError(f"digit classifier underfit: val acc {acc}")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **{k: v.cpu().numpy() for k, v in params.items()})
    os.replace(tmp, path)                   # concurrent first trainings: last one wins
    return params


def _gray(imgs) -> np.ndarray:
    x = np.asarray(imgs, np.float32)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] > 1:
        x = x.mean(axis=-1, keepdims=True)
    return x


@torch.no_grad()
def class_probs(params: Params, imgs) -> np.ndarray:
    """p(y|x) of (N, H, W, C) images in [-1, 1] (C > 1 averaged to gray),
    float32 on the host."""
    x = _gray(imgs)
    net = classifier(params, x.shape[1], x.shape[2])
    logits = net(torch.from_numpy(np.ascontiguousarray(x)).to(
        next(net.parameters()).device))
    return torch.softmax(logits, dim=-1).cpu().numpy()


def scores_from_probs(probs: np.ndarray) -> Dict[str, float]:
    conf = probs.max(axis=-1)
    pred = probs.argmax(axis=-1)
    covered = np.unique(pred[conf > 0.5])
    marginal = probs.mean(axis=0)
    kl = (probs * (np.log(probs + 1e-12)
                   - np.log(marginal + 1e-12)[None])).sum(-1)
    return {
        "mean_confidence": float(conf.mean()),
        "coverage": int(len(covered)),
        "inception_score": float(np.exp(kl.mean())),
        "n": int(len(probs)),
    }


def score_samples(params: Params, imgs) -> Dict[str, float]:
    """Score generated samples: (N, H, W, C) float in [-1, 1]."""
    return scores_from_probs(class_probs(params, imgs))
