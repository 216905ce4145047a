"""MADE, the masked autoencoder for distribution estimation: counterpart of
``igm_tpu/models/made.py``.

A masked MLP over the flattened image (``(h w c)`` order) with a 256-way
softmax per pixel, sigmoid between the hidden layers, trained on bits/dim.
The degree masks come from ``build_masks``, the same numpy draws as
``igm_tpu``'s, so the masks are equal bit for bit.

The kernels are stored in Flax's ``(in, out)`` layout (``weight``, the
forward computes ``x @ weight``), so ``igm_tpu_torch.interop`` carries them
over without a transpose and the counter of the stochastic rounding
(the element's linear index) is the same as ``igm_tpu``'s.  Their masked
entries are zeroed at init and stay zero: the forward reads the kernel
directly, and the gradient is masked in the backward
(``_GradMaskHidden``, ``_GradMaskOut``, the counterparts of the custom
VJPs ``_grad_mask_hidden`` and ``_grad_mask_out``), so masked gradients,
Adam moments and weights stay exactly 0.  The output layer's mask is kept in
its compact ``(in_dim, hidden)`` form and broadcast over the 256 classes.

``compute_dtype="auto"`` is bfloat16 on CUDA and float32 on the CPU; in
bfloat16 the products take float32 results (``networks.dit._product_f32``,
the counterpart of ``preferred_element_type=float32``).  With bfloat16
compute, ``weight_dtype="auto"`` (or ``IGM_MADE_WDTYPE``) stores the
output kernel in bfloat16, updated with ``igm_tpu``'s counter-hash
stochastic rounding (``core.optim.stochastic_round_bf16``; one seed per
parameter drawn from the train state's generator on the device, so the step
captures into a CUDA graph), and the Adam moments of the whole net in
bfloat16.  ``IGM_MADE_SR=0`` applies the bfloat16 updates rounded to
nearest instead (a measurement arm, as in ``igm_tpu``).

``sample_images`` is the pixel-by-pixel chain, eager: one ``pixel_logits``
(hidden layers in full, the output layer sliced to the pixel) per pixel.
``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel)``;
the Gumbel draws ``(D, N, 256)`` can be given.
"""
from __future__ import annotations

import math
import os
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam, step_lr
from ..core.state import TrainState
from ..networks.base import _uniform
from ..networks.dit import _product_f32
from .base import BaseModel, ValidationResult, gumbel_noise

LOG2 = math.log(2.0)
N_CLASS = 256


def build_masks(in_dim: int, hidden_dim: int, n_layer: int, seed: int = 0):
    """Degree-based autoregressive masks (``igm_tpu``'s ``build_masks``):
    hidden masks ``(out_features, in_features)``, the output mask compact
    ``(in_dim, hidden_dim)``; float32 numpy."""
    rng = np.random.default_rng(seed)
    units = [np.arange(in_dim)]
    low = 0
    for _ in range(n_layer):
        hidden = rng.integers(low, in_dim, size=(hidden_dim,))
        units.append(hidden)
        low = int(hidden.min())
    masks = [(out_u[:, None] >= in_u[None, :]).astype(np.float32)
             for in_u, out_u in zip(units[:-1], units[1:])]
    out_small = (np.arange(in_dim)[:, None] - 1 >= units[-1][None, :]).astype(np.float32)
    return masks, out_small


def pixel_targets(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    """Model-space pixels -> their integer values 0..255 (int64).
    ``igm_tpu`` truncates ``(x + 1) / 2 * 255`` (``x * 255``): its compiled
    step (the trainer's ``jax.jit``) gives the integer or one less, as XLA's
    fusion around it falls, and the same float32 ops one by one give one
    less for 63 of the 256 values (``x / 255 * 2 - 1 + 1`` lands below
    ``2 x / 255``).  The port takes the integer: it rounds."""
    y = (x + 1.0) / 2.0 * 255.0 if normalize else x * 255.0
    return torch.round(y).to(torch.int64)


class _GradMaskHidden(torch.autograd.Function):
    """Identity on the kernel; its cotangent multiplied by the mask in
    float32, cast back to the kernel's dtype."""

    @staticmethod
    def forward(ctx, kernel, mask_t):
        ctx.save_for_backward(mask_t)
        return kernel.view_as(kernel)

    @staticmethod
    def backward(ctx, g):
        (mask_t,) = ctx.saved_tensors
        return (g.float() * mask_t).to(g.dtype), None


class _GradMaskOut(torch.autograd.Function):
    """The output kernel's: the compact ``(in_dim, hidden)`` mask broadcast
    over the classes of the ``(hidden, in_dim * n_class)`` cotangent."""

    @staticmethod
    def forward(ctx, kernel, mask_small):
        ctx.save_for_backward(mask_small)
        return kernel.view_as(kernel)

    @staticmethod
    def backward(ctx, g):
        (mask_small,) = ctx.saved_tensors
        in_dim, hidden = mask_small.shape
        g3 = g.float().reshape(hidden, in_dim, -1) * mask_small.t()[:, :, None]
        return g3.reshape(g.shape).to(g.dtype), None


def _matmul(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ w`` with a float32 result: in ``dtype`` (bfloat16) operands
    when given, else as the tensors are."""
    if dtype is None:
        return x @ w
    return _product_f32(x.to(dtype)[None], w.to(dtype)[None])[0]


class MaskedLinear(nn.Module):
    """``mask`` ``(out, in)``; ``weight`` ``(in, out)`` (Flax's layout)."""

    def __init__(self, mask: np.ndarray, dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_f, in_f = mask.shape
        self.dtype = dtype
        self.register_buffer("mask_t", torch.from_numpy(np.ascontiguousarray(mask.T)),
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(in_f, out_f))
        self.bias = nn.Parameter(torch.empty(out_f))

    def reset_parameters(self, generator: torch.Generator) -> None:
        in_f = self.weight.shape[0]
        _uniform(self.weight, in_f, generator)
        _uniform(self.bias, in_f, generator)
        with torch.no_grad():
            self.weight.mul_(self.mask_t.to(self.weight.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _GradMaskHidden.apply(self.weight, self.mask_t)
        return _matmul(x, w, self.dtype) + self.bias


class MaskedPixelOutput(nn.Module):
    """hidden -> (in_dim, n_class) logits; ``weight`` ``(hidden, in_dim *
    n_class)`` in ``param_dtype``, the mask compact ``(in_dim, hidden)``."""

    def __init__(self, mask_small: np.ndarray, n_class: int,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        in_dim, hidden = mask_small.shape
        self.n_class, self.dtype = n_class, dtype
        self.register_buffer("mask_small", torch.from_numpy(mask_small.copy()),
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(hidden, in_dim * n_class, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(in_dim * n_class))

    def expanded_mask(self) -> torch.Tensor:
        """The mask of ``weight``, ``(hidden, in_dim * n_class)`` (for
        ``on_restore``; the forward and backward never build it)."""
        return self.mask_small.t().repeat_interleave(self.n_class, dim=1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        hidden, in_dim = self.mask_small.shape[1], self.mask_small.shape[0]
        w = torch.empty(self.weight.shape)
        _uniform(w, hidden, generator)
        _uniform(self.bias, hidden, generator)
        w.view(hidden, in_dim, self.n_class).mul_(self.mask_small.t().cpu()[:, :, None])
        with torch.no_grad():
            self.weight.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dim = self.mask_small.shape[0]
        w = _GradMaskOut.apply(self.weight, self.mask_small)
        y = _matmul(x, w, self.dtype)
        return (y.reshape(x.shape[0], in_dim, self.n_class)
                + self.bias.reshape(in_dim, self.n_class))

    def pixel(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """(N, hidden), pixel index -> (N, n_class) logits for pixel ``i``:
        float32 products of the masked input and the pixel's kernel slice."""
        in_dim, hidden = self.mask_small.shape
        w_i = self.weight.reshape(hidden, in_dim, self.n_class)[:, i]
        b_i = self.bias.reshape(in_dim, self.n_class)[i]
        return (x * self.mask_small[i]) @ w_i.float() + b_i


class MADENet(nn.Module):
    """The layers ``layers_<i>`` and ``out_layer``, Flax's names."""

    def __init__(self, in_dim: int, hidden_dim: int, n_class: int, n_layer: int,
                 mask_seed: int = 0, dtype: Optional[torch.dtype] = None,
                 out_param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layer = n_layer
        hidden_masks, out_small = build_masks(in_dim, hidden_dim, n_layer, mask_seed)
        for i, m in enumerate(hidden_masks):
            self.add_module(f"layers_{i}", MaskedLinear(m, dtype))
        self.out_layer = MaskedPixelOutput(out_small, n_class, dtype, out_param_dtype)

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.n_layer)]

    def hidden(self, x_flat: torch.Tensor) -> torch.Tensor:
        x = x_flat
        for layer in self.layers():
            x = torch.sigmoid(layer(x))
        return x

    def forward(self, x_flat: torch.Tensor) -> torch.Tensor:
        """(N, D) floats -> logits (N, D, n_class), float32."""
        return self.out_layer(self.hidden(x_flat))

    def pixel_logits(self, x_flat: torch.Tensor, i: int) -> torch.Tensor:
        """Logits of pixel ``i`` only, (N, n_class): the hidden layers in
        full, the output layer sliced to the pixel."""
        return self.out_layer.pixel(self.hidden(x_flat), i)


class MADE(BaseModel):
    weights_module = "net"

    def __init__(self, datamodule: Any, hidden_dim: int = 1024, n_layer: int = 3,
                 lr: float = 1e-3, compute_dtype: str = "auto", weight_dtype: str = "auto",
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s MADE, plus ``device``
        (the card unless the CPU is asked for)."""
        super().__init__(datamodule, device)
        self.save_hyperparameters(hidden_dim=hidden_dim, n_layer=n_layer, lr=lr,
                                  compute_dtype=compute_dtype, weight_dtype=weight_dtype)
        self.in_dim = self.width * self.height * self.channels
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        if weight_dtype == "auto":
            weight_dtype = os.environ.get("IGM_MADE_WDTYPE",
                                          "bfloat16" if dtype is not None else "float32")
        self.bf16_weights = weight_dtype == "bfloat16" and dtype is not None
        self.modules = nn.ModuleDict({"net": MADENet(
            self.in_dim, int(hidden_dim), N_CLASS, int(n_layer), dtype=dtype,
            out_param_dtype=torch.bfloat16 if self.bf16_weights else torch.float32)})
        self.init_params(0)

    @property
    def net(self) -> MADENet:
        return self.modules["net"]

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        # bfloat16 moments whenever the compute is bfloat16 (made.py:275-277)
        moments = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        self.optimizers = OptimizerSet().add(
            "opt", adam(step_lr(hp.lr, 0.99, self.steps_per_epoch), mu_dtype=moments,
                        nu_dtype=moments), ["net"])
        self.state = self.make_state(seed)
        return self.state

    def on_restore(self, state: TrainState) -> TrainState:
        """Re-zero the masked entries of every kernel and of its Adam
        moments, in place (idempotent): a checkpoint written without the
        invariant is migrated, one with it passes through unchanged."""
        net = self.net
        masks = [(layer.weight, layer.mask_t) for layer in net.layers()]
        masks.append((net.out_layer.weight, net.out_layer.expanded_mask()))
        opt = state.opt_states["opt"]
        with torch.no_grad():
            for weight, mask in masks:
                for t in (weight, *(opt.state.get(weight, {}).get(k) for k in
                                    ("exp_avg", "exp_avg_sq"))):
                    if t is not None:
                        t.mul_(mask.to(t.dtype))
        return state

    # ---------------------------------------------------------------- helpers
    def _flatten(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs.reshape(imgs.shape[0], -1)

    def _targets(self, imgs_flat: torch.Tensor) -> torch.Tensor:
        return pixel_targets(imgs_flat, self.input_normalize)

    @staticmethod
    def _bpd(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return nll.mean(dim=1).mean() / LOG2

    def bpd(self, imgs_raw: torch.Tensor) -> torch.Tensor:
        """The batch's mean bits/dim (uint8 NHWC images)."""
        imgs = self._flatten(self.preprocess(imgs_raw))
        return self._bpd(self.net(imgs), self._targets(imgs))

    def sr_active(self) -> bool:
        """Stochastic rounding of the bfloat16 output kernel's updates."""
        return self.bf16_weights and os.environ.get("IGM_MADE_SR", "1") == "1"

    # ------------------------------------------------------------------ steps
    def train_step(self, state: TrainState, batch, sr_seeds: Optional[torch.Tensor] = None):
        """One Adam step on the net.  With bfloat16 weights the SR seeds,
        one per parameter (``net.parameters()`` order), are drawn from
        ``state.generator`` on the device; ``sr_seeds`` replaces them."""
        imgs_raw, _ = batch
        if self.sr_active() and sr_seeds is None:
            n = len(list(self.net.parameters()))
            sr_seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=state.generator,
                                     device=self.device)

        def loss_fn():
            bpd = self.bpd(imgs_raw)
            return bpd, {"train_bpd": bpd.detach()}

        state, _, metrics = self.optimizers.grad_step(
            state, "opt", loss_fn, sr_seeds=sr_seeds if self.sr_active() else None)
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample_images(self, n: int, generator: Optional[torch.Generator] = None,
                      init_flat: Optional[torch.Tensor] = None,
                      gumbels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pixel-by-pixel chain: every -1 entry of ``init_flat`` (N, D)
        (all of them when not given) is drawn in raster order, the others
        kept.  ``gumbels`` (D, N, 256) replaces the draws.  Returns
        (N, H, W, C) in model space."""
        d = self.in_dim
        img = (torch.full((n, d), -1.0, device=self.device) if init_flat is None
               else init_flat.to(self.device).float().clone())
        if gumbels is None:
            gumbels = gumbel_noise((d, n, N_CLASS), generator, self.device, self.mesh, axis=1)
        for i in range(d):
            logits = self.net.pixel_logits(img, i)
            value = torch.argmax(logits + gumbels[i], dim=-1).float() / 255.0
            if self.input_normalize:
                value = value * 2.0 - 1.0
            cur = img[:, i]
            img[:, i] = torch.where(cur != -1.0, cur, value)
        return img.reshape(img.shape[0], self.height, self.width, self.channels)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        imgs_raw, _ = batch
        result = ValidationResult(real_image=self.preprocess(imgs_raw))
        if sample:
            result.fake_image = self.sample_images(imgs_raw.shape[0], generator)
        return result, {"val_bpd": self.bpd(imgs_raw)}
