"""Gated PixelCNN: counterpart of ``igm_tpu/models/pixelcnn.py``.

Vertical and horizontal masked conv stacks with the v->h connection, the
dilation schedule (1, 2, 1, 4, ...), class conditioning by 1x1 projections of
the one-hot label, 256-way logits with the class-major ``(N, H, W, C, 256)``
factorisation, and bits/dim.  Masks are applied in the forward (``weight *
mask``), kernels are stored unmasked, as in ``igm_tpu``.  The horizontal gate
is tanh * tanh (``igm_tpu``'s quirk, kept), the vertical tanh * sigmoid.

Modules carry Flax's names (``conv_vstack``, ``conv_hstack``,
``conv_layers_<i>/{vert_conv, horiz_conv, conv1x1_1, conv1x1_2,
cond_proj_*}``, ``conv_out``); a kernel is ``weight`` in OIHW, so
``igm_tpu_torch.interop`` carries an ``igm_tpu`` tree over.

``sample_rows`` is ``igm_tpu``'s row-causal fast sampler: the vertical stack
of row r depends only on rows < r, so it runs once per row over the whole
image; within a row the horizontal stack is column-causal with at most 2
left taps per layer, and advances one pixel per step (``horiz_step``).  It
runs eagerly here (the row and column are host integers): one vertical pass
per row, then per column 11 layers of one-pixel products.  Gumbel draws
``(H, W, N, C, 256)`` can be given; pixels that are not -1 are kept.
``row_logits`` is the same machinery on a fixed image, the exact-logits
check of the full forward.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.optim import OptimizerSet, adam, step_lr
from ..core.state import TrainState
from ..networks.base import _uniform
from .base import BaseModel, ValidationResult, gumbel_noise
from .made import pixel_targets

LOG2 = math.log(2.0)
N_CLASS = 256


def vertical_mask(k: int, mask_center: bool) -> np.ndarray:
    m = np.ones((k, k), np.float32)
    m[k // 2 + 1:, :] = 0
    if mask_center:
        m[k // 2] = 0
    return m


def horizontal_mask(k: int, mask_center: bool) -> np.ndarray:
    m = np.ones((1, k), np.float32)
    m[0, k // 2 + 1:] = 0
    if mask_center:
        m[0, k // 2] = 0
    return m


class MaskedConv(nn.Module):
    """A conv with a static ``(kh, kw)`` weight mask and torch's symmetric
    padding ``dilation * (k - 1) // 2``, on NHWC input."""

    def __init__(self, in_features: int, features: int, mask: np.ndarray, dilation: int = 1):
        super().__init__()
        kh, kw = mask.shape
        self.dilation = dilation
        self.padding = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
        self.register_buffer("mask", torch.from_numpy(mask.copy()), persistent=False)
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _uniform(self.weight, fan_in, generator)
        _uniform(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight * self.mask, self.bias,
                     padding=self.padding, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)

    def h_taps(self, taps: torch.Tensor) -> torch.Tensor:
        """taps (N, T, C): the input at the T unmasked tap positions, left to
        right (1-row masks only) -> (N, features)."""
        sub = self.weight[:, :, 0, :taps.shape[1]]          # (F, C, T)
        return torch.einsum("ntc,fct->nf", taps, sub) + self.bias


class Pointwise(nn.Module):
    """A 1x1 conv as a dense map on (..., C); ``weight`` (F, C, 1, 1)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        _uniform(self.weight, fan_in, generator)
        if self.bias is not None:
            _uniform(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.weight[:, :, 0, 0].t()
        return out if self.bias is None else out + self.bias


class GatedMaskedConv(nn.Module):
    """The full layer (``forward``) and its incremental parts."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 cond_channel: Optional[int] = None):
        super().__init__()
        c = channels
        self.dilation = dilation
        self.vert_conv = MaskedConv(c, 2 * c, vertical_mask(kernel_size, False), dilation)
        self.horiz_conv = MaskedConv(c, 2 * c, horizontal_mask(kernel_size, False), dilation)
        self.conv1x1_1 = Pointwise(2 * c, 2 * c)
        self.conv1x1_2 = Pointwise(c, c)
        self.cond = cond_channel is not None
        if self.cond:
            for name in ("cond_proj_vert1", "cond_proj_vert2", "cond_proj_horiz1",
                         "cond_proj_horiz2"):
                self.add_module(name, Pointwise(cond_channel, c, use_bias=False))

    def vert_part(self, vert_x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        """-> (out_vert, vert_conv_x): the row-causal half."""
        vert_conv_x = self.vert_conv(vert_x)
        v1, v2 = vert_conv_x.chunk(2, dim=-1)
        if cond is None:
            return torch.tanh(v1) * torch.sigmoid(v2), vert_conv_x
        return (torch.tanh(v1 + self.cond_proj_vert1(cond))
                * torch.sigmoid(v2 + self.cond_proj_vert2(cond))), vert_conv_x

    def horiz_gate(self, h_in: torch.Tensor, cond: Optional[torch.Tensor] = None):
        h1, h2 = h_in.chunk(2, dim=-1)
        if cond is None:
            return torch.tanh(h1) * torch.tanh(h2)          # tanh * tanh quirk
        return (torch.tanh(h1 + self.cond_proj_horiz1(cond))
                * torch.tanh(h2 + self.cond_proj_horiz2(cond)))

    def forward(self, vert_x, horiz_x, cond=None):
        out_vert, vert_conv_x = self.vert_part(vert_x, cond)
        h_in = self.horiz_conv(horiz_x) + self.conv1x1_1(vert_conv_x)
        out_horiz = self.conv1x1_2(self.horiz_gate(h_in, cond)) + horiz_x
        return out_vert, out_horiz

    def horiz_step(self, vert_conv_x_px, h_taps, h_center, cond_px=None):
        """One pixel's horizontal update: vert_conv_x_px (N, 2C) the vertical
        conv at the pixel, h_taps (N, T, C) this layer's input at its
        unmasked taps (the last is the pixel), h_center (N, C) the input at
        the pixel (the residual)."""
        h_in = self.horiz_conv.h_taps(h_taps) + self.conv1x1_1(vert_conv_x_px)
        return self.conv1x1_2(self.horiz_gate(h_in, cond_px)) + h_center


class PixelCNNNet(nn.Module):
    DILATIONS = (1, 2, 1, 4, 1, 2, 1, 4, 1, 2, 1)

    def __init__(self, channels: int, hidden_dim: int, n_classes: Optional[int] = None,
                 class_condition: bool = False):
        super().__init__()
        self.channels, self.hidden_dim = channels, hidden_dim
        self.n_classes = n_classes
        self.class_condition = class_condition
        cond_ch = n_classes if class_condition else None
        self.conv_vstack = MaskedConv(channels, hidden_dim, vertical_mask(5, True))
        self.conv_hstack = MaskedConv(channels, hidden_dim, horizontal_mask(5, True))
        for i, d in enumerate(self.DILATIONS):
            self.add_module(f"conv_layers_{i}", GatedMaskedConv(hidden_dim, 3, d, cond_ch))
        self.conv_out = Pointwise(hidden_dim, channels * N_CLASS)

    def layers(self) -> List[GatedMaskedConv]:
        return [getattr(self, f"conv_layers_{i}") for i in range(len(self.DILATIONS))]

    def _cond4d(self, y):
        if self.class_condition and y is not None:
            return y.reshape(y.shape[0], 1, 1, self.n_classes)
        return None

    def _logits_px(self, h_px: torch.Tensor) -> torch.Tensor:
        """(N, hidden) -> (N, C, 256)."""
        out = self.conv_out(F.elu(h_px))
        return out.reshape(out.shape[0], N_CLASS, self.channels).transpose(1, 2)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None, pixel=None):
        """x (N, H, W, C) float, y (N, n_classes) one-hot or None ->
        logits (N, H, W, C, 256); with ``pixel=(hh, ww)`` that position's
        logits (N, C, 256)."""
        n = x.shape[0]
        cond = self._cond4d(y)
        v, h = self.conv_vstack(x), self.conv_hstack(x)
        for layer in self.layers():
            v, h = layer(v, h, cond)
        if pixel is not None:
            return self._logits_px(h[:, pixel[0], pixel[1]])
        out = self.conv_out(F.elu(h)).reshape(n, x.shape[1], x.shape[2], N_CLASS,
                                              self.channels)
        return out.permute(0, 1, 2, 4, 3)                   # class-major parity

    def vert_features(self, x, y=None) -> List[torch.Tensor]:
        """Per layer, the vertical conv's output (N, H, W, 2C), valid at row
        r once input rows < r are final."""
        cond = self._cond4d(y)
        v = self.conv_vstack(x)
        outs = []
        for layer in self.layers():
            v, vert_conv_x = layer.vert_part(v, cond)
            outs.append(vert_conv_x)
        return outs

    def _row(self, img_row, vert_rows, cond_px, step):
        """The column steps of one row: the horizontal stack pixel by pixel
        from the row's input (N, W, C) and its vertical features; ``step(w,
        logits)`` gets each pixel's logits (N, C, 256) and returns the
        pixel's final input value (N, C) or None (the row is fixed)."""
        n, w_dim, _ = img_row.shape
        layers = self.layers()
        h_buf = img_row.new_zeros(len(layers) + 1, n, w_dim, self.hidden_dim)

        def taps(buf, w, offsets):
            return torch.stack([buf[:, w + o] if w + o >= 0 else torch.zeros_like(buf[:, 0])
                                for o in offsets], dim=1)

        for w in range(w_dim):
            h_buf[0, :, w] = self.conv_hstack.h_taps(taps(img_row, w, (-2, -1)))
            for i, layer in enumerate(layers):
                h_buf[i + 1, :, w] = layer.horiz_step(
                    vert_rows[i][:, w], taps(h_buf[i], w, (-layer.dilation, 0)),
                    h_buf[i, :, w], cond_px)
            value = step(w, self._logits_px(h_buf[len(layers), :, w]))
            if value is not None:
                img_row[:, w] = value

    @torch.no_grad()
    def sample_rows(self, img: torch.Tensor, normalize: bool, y=None,
                    generator: Optional[torch.Generator] = None,
                    gumbels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fill every -1 pixel of ``img`` (N, H, W, C) in raster order: per
        row one vertical pass over the whole image, then the column steps
        and draws.  ``gumbels`` (H, W, N, C, 256) replaces the draws."""
        img = img.clone()
        n, h_dim, w_dim, c = img.shape
        cond4 = self._cond4d(y)
        cond_px = y if (self.class_condition and y is not None) else None
        if gumbels is None:
            gumbels = gumbel_noise((h_dim, w_dim, n, c, N_CLASS), generator, img.device)
        for row in range(h_dim):
            v = self.conv_vstack(img)
            vert_rows = []
            for layer in self.layers():
                v, vert_conv_x = layer.vert_part(v, cond4)
                vert_rows.append(vert_conv_x[:, row])
            img_row = img[:, row].clone()

            def draw(w, logits, row=row, img_row=img_row):
                value = torch.argmax(logits + gumbels[row, w], dim=-1).float() / 255.0
                if normalize:
                    value = value * 2.0 - 1.0
                cur = img_row[:, w]
                return torch.where(cur != -1.0, cur, value)

            self._row(img_row, vert_rows, cond_px, draw)
            img[:, row] = img_row
        return img

    @torch.no_grad()
    def row_logits(self, img: torch.Tensor, y=None) -> torch.Tensor:
        """The causal logits of a fixed image through the incremental
        machinery: (N, H, W, C, 256)."""
        n, h_dim, w_dim, c = img.shape
        cond_px = y if (self.class_condition and y is not None) else None
        vert_all = self.vert_features(img, y)
        out = img.new_empty(n, h_dim, w_dim, c, N_CLASS)
        for row in range(h_dim):
            def keep(w, logits, row=row):
                out[:, row, w] = logits

            self._row(img[:, row].clone(), [v[:, row] for v in vert_all], cond_px, keep)
        return out


class PixelCNN(BaseModel):
    weights_module = "net"

    def __init__(self, datamodule: Any, hidden_dim: int = 64, class_condition: bool = False,
                 n_classes: Any = None, lr: float = 1e-3,
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s PixelCNN, plus ``device``
        (the card unless the CPU is asked for).  ``n_classes`` that is not
        an int (the CelebA config's string "None") counts as 0."""
        super().__init__(datamodule, device)
        self.save_hyperparameters(hidden_dim=hidden_dim, class_condition=bool(class_condition),
                                  n_classes=n_classes, lr=lr)
        self.n_classes = n_classes if isinstance(n_classes, int) else 0
        self.modules = nn.ModuleDict({"net": PixelCNNNet(
            self.channels, int(hidden_dim), self.n_classes or None, bool(class_condition))})
        self.init_params(0)

    @property
    def net(self) -> PixelCNNNet:
        return self.modules["net"]

    def init_state(self, seed: int = 0) -> TrainState:
        self.optimizers = OptimizerSet().add(
            "opt", adam(step_lr(self.hparams.lr, 0.99, self.steps_per_epoch)), ["net"])
        self.state = self.make_state(seed)
        return self.state

    def _one_hot(self, labels) -> Optional[torch.Tensor]:
        if not self.hparams.class_condition:
            return None
        return F.one_hot(labels.to(self.device).long(), self.n_classes).float()

    def _targets(self, imgs: torch.Tensor) -> torch.Tensor:
        return pixel_targets(imgs, self.input_normalize)

    @staticmethod
    def _bpd(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return nll.reshape(nll.shape[0], -1).mean(dim=1).mean() / LOG2

    def bpd(self, imgs_raw: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The batch's mean bits/dim (uint8 NHWC images; the labels are
        read when class-conditional)."""
        imgs = self.preprocess(imgs_raw)
        return self._bpd(self.net(imgs, self._one_hot(labels)), self._targets(imgs))

    def train_step(self, state: TrainState, batch):
        imgs_raw, labels = batch

        def loss_fn():
            bpd = self.bpd(imgs_raw, labels)
            return bpd, {"train_bpd": bpd.detach()}

        state, _, metrics = self.optimizers.grad_step(state, "opt", loss_fn)
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample_images(self, n: int, generator: Optional[torch.Generator] = None,
                      cond: Optional[torch.Tensor] = None,
                      init_img: Optional[torch.Tensor] = None,
                      gumbels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The row-causal fast sampler from ``init_img`` (all -1 when not
        given); ``cond`` (n, n_classes) one-hot labels."""
        img = (torch.full((n, self.height, self.width, self.channels), -1.0,
                          device=self.device)
               if init_img is None else init_img.to(self.device).float())
        if gumbels is None:          # batch axis 2: on a mesh, the global batch's draw
            gumbels = gumbel_noise((self.height, self.width, img.shape[0], self.channels,
                                    N_CLASS), generator, self.device, self.mesh, axis=2)
        return self.net.sample_rows(img, self.input_normalize, cond, generator, gumbels)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        """bpd; with ``sample`` a batch of samples, or 8 of each class when
        class-conditional."""
        imgs_raw, labels = batch
        imgs = self.preprocess(imgs_raw)
        bpd = self.bpd(imgs_raw, labels)
        result = ValidationResult(real_image=imgs)
        if sample:
            if self.hparams.class_condition:
                labels = torch.arange(self.n_classes, device=self.device).repeat_interleave(8)
                result.fake_image = self.sample_images(len(labels), generator,
                                                       cond=self._one_hot(labels))
            else:
                result.fake_image = self.sample_images(imgs.shape[0], generator)
        return result, {"val_bpd": bpd}
