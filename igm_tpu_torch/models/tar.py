"""TAR, the transformer autoregressive model over binarised pixels:
counterpart of ``igm_tpu/models/tar.py``.

``TransformerEncoderLayer`` (post-LN, ReLU FFN of 1024, dropout on the
attention output, the FFN hidden and the FFN output) and ``TARNet`` (the
shared ``<sos>``/class embedding, factored H/W positional embeddings, the
float32 logits head) carry Flax's module names, so ``igm_tpu_torch.interop``
maps an ``igm_tpu`` tree onto them.  ``TAR`` holds the net under ``net``,
with the Adam train state, ``img2tokens`` (thresholding the normalised
pixel at 0.5, the reference's quirk), ``cal_loss``, ``train_step``, the
KV-cached ``sample_tokens``, ``sample`` and ``validation_step``.

Random draws take an explicit ``torch.Generator``: the residual and FFN
dropout masks (``torch.rand(..., generator=g) < keep``, since
``torch.nn.functional.dropout`` takes no generator), the attention dropout
(the ``off`` mode's broadcast mask, or one uint32 seed per layer call for
``dropout``/``hashdrop``), and the sampler's Gumbel noise.  For tests,
``train_step`` takes the per-layer attention seeds and ``sample_tokens``
the Gumbel draws: ``jax.random.categorical(key, logits)`` is
``argmax(logits + gumbel(key, logits.shape))``.

Every training draw (dropout masks, attention seeds) is made on the card
from the state's generator, so ``train_step_n`` captures the train step
(``models/base.py``); its ``step_lr`` learning rate is written into the
graph before each launch.  The KV-cached decode stays eager: its cache
position is a host integer.

``flash_attention`` keeps ``igm_tpu``'s modes (``networks/attention.py``),
with one difference: ``dropout`` launches the hand-written CUDA kernels on
the card and never falls back to ``off`` (``igm_tpu`` does off a TPU,
``tar.py:210-217``).  ``auto`` is ``off``, as there.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.optim import OptimizerSet, adam, step_lr
from ..core.state import TrainState
from ..networks.attention import MultiHeadDotProductAttention
from ..networks.base import Dense, Embed, LayerNorm
from ..parallel.mesh import batch_draw
from .base import BaseModel, ValidationResult, gumbel_noise

LOG2 = math.log(2.0)
FFN = 1024                       # igm_tpu's TARNet hard-codes the FFN width


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: Optional[torch.Generator], mesh=None) -> torch.Tensor:
    """Flax ``nn.Dropout``: ``where(kept, x / keep, 0)``, the keep mask drawn
    from ``generator`` (on a data-axis mesh at the global batch, this rank's
    rows kept)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = batch_draw(mesh, torch.rand, x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def flash_mode(flash_attention: Any) -> str:
    """``model.flash_attention`` -> the layer's attention mode."""
    if flash_attention in (True, "true"):
        return "always"
    if flash_attention in ("eval", "dropout", "hashdrop"):
        return flash_attention
    return "off"


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = FFN,
                 dropout: float = 0.1, dtype: torch.dtype | None = None,
                 flash: str = "off"):
        super().__init__()
        self.dropout, self.dtype = float(dropout), dtype
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, nhead, dropout, flash, dtype)
        self.LayerNorm_0 = LayerNorm(d_model, 1e-5, dtype)
        self.Dense_0 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.Dense_1 = Dense(dim_feedforward, d_model, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d_model, 1e-5, dtype)
        self.mesh = None

    def bind_mesh(self, mesh) -> None:
        """A data-axis mesh: x then holds this rank's rows of the global
        batch, and the dropout masks are the global batch's (None: one
        process)."""
        self.mesh = mesh

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_seed: Optional[torch.Tensor] = None,
                decode: bool = False) -> torch.Tensor:
        x = x.to(self.dtype) if self.dtype is not None else x
        a = self.MultiHeadDotProductAttention_0(x, train=train, generator=generator,
                                                seed=attn_seed, decode=decode)
        a = _dropout(a, self.dropout, train, generator, self.mesh)
        x = self.LayerNorm_0(x + a)
        f = F.relu(self.Dense_0(x))
        f = _dropout(f, self.dropout, train, generator, self.mesh)
        f = _dropout(self.Dense_1(f), self.dropout, train, generator, self.mesh)
        return self.LayerNorm_1(x + f)


class TARNet(nn.Module):
    def __init__(self, n_tokens: int, d_model: int, nhead: int, num_layers: int,
                 height: int, width: int, class_cond: bool, n_classes: int,
                 dtype: torch.dtype | None = None, flash: str = "off",
                 dropout: float = 0.1):
        super().__init__()
        self.n_tokens, self.height, self.width = n_tokens, height, width
        self.n_cond = n_classes if class_cond else 1
        self.num_layers = num_layers
        self.Embed_0 = Embed(n_tokens, d_model)            # pixels
        self.Embed_1 = Embed(self.n_cond, d_model)         # <sos> / class
        self.h_pe = nn.Parameter(torch.empty(height, d_model))
        self.w_pe = nn.Parameter(torch.empty(width, d_model))
        self.first_pe = nn.Parameter(torch.empty(1, d_model))
        for i in range(num_layers):
            self.add_module(f"TransformerEncoderLayer_{i}", TransformerEncoderLayer(
                d_model, nhead, FFN, dropout=dropout, dtype=dtype, flash=flash))
        self.Dense_0 = Dense(d_model, n_tokens)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.h_pe, self.w_pe, self.first_pe):
                p.normal_(0.0, 1.0, generator=generator)

    def layers(self):
        return [getattr(self, f"TransformerEncoderLayer_{i}") for i in range(self.num_layers)]

    def positions(self) -> torch.Tensor:
        """(1 + H*W, d): position i > 0 is pixel i-1 in (h, w) raster order."""
        h_full = self.h_pe.repeat_interleave(self.width, dim=0)
        w_full = self.w_pe.repeat(self.height, 1)
        return (torch.cat([self.first_pe, h_full]) + torch.cat([self.first_pe, w_full]))

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_seeds: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """tokens (N, S) integers, S <= 1 + H*W -> logits (N, S, n_tokens)
        float32.  ``attn_seeds[i]`` replaces layer i's attention seed."""
        s = tokens.shape[1]
        emb = torch.cat([self.Embed_1(tokens[:, :1]), self.Embed_0(tokens[:, 1:])], dim=1)
        x = emb + self.positions()[:s][None]
        for i, layer in enumerate(self.layers()):
            x = layer(x, train=train, generator=generator,
                      attn_seed=None if attn_seeds is None else attn_seeds[i])
        return self.Dense_0(x.float())

    def init_cache(self, n: int, max_length: int) -> None:
        for layer in self.layers():
            layer.MultiHeadDotProductAttention_0.init_cache(n, max_length,
                                                             self.first_pe.device)

    def clear_cache(self) -> None:
        for layer in self.layers():
            layer.MultiHeadDotProductAttention_0.clear_cache()

    def decode_step(self, tokens: torch.Tensor, pos_idx: int) -> torch.Tensor:
        """tokens (N, 1): the tokens at position ``pos_idx`` (the ``<sos>``
        embedding at 0) -> logits (N, 1, n_tokens) for position pos_idx + 1,
        through the KV caches."""
        tok = tokens.clamp(min=0)
        if pos_idx == 0:
            emb = self.Embed_1(tok.clamp(max=self.n_cond - 1))
        else:
            emb = self.Embed_0(tok.clamp(max=self.n_tokens - 1))
        x = emb + self.positions()[pos_idx][None, None]
        for layer in self.layers():
            x = layer(x, train=False, decode=True)
        return self.Dense_0(x.float())


class TAR(BaseModel):
    weights_module = "net"

    def __init__(self, datamodule: Any, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, d_model: int = 256, nhead: int = 4,
                 num_layers: int = 4, class_cond: bool = False, n_classes: int = 10,
                 compute_dtype: str = "auto", flash_attention: Any = "auto",
                 dropout: float = 0.1, device: str | torch.device | None = None,
                 **kwargs):
        """Same keyword arguments as ``igm_tpu``'s TAR, plus ``device`` (the
        card unless the CPU is asked for).  ``compute_dtype="auto"`` is
        bfloat16 on CUDA and float32 on the CPU (the logits head and the
        loss stay float32)."""
        super().__init__(datamodule, device)
        self.save_hyperparameters(lr=lr, b1=b1, b2=b2, d_model=d_model, nhead=nhead,
                                  num_layers=num_layers, class_cond=bool(class_cond),
                                  n_classes=int(n_classes), compute_dtype=compute_dtype,
                                  flash_attention=flash_attention, dropout=dropout)
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.flash = flash_mode(flash_attention)
        self.n_tokens = 2                # binary pixels; <sos> shares the class embedding
        self.seq_len = 1 + self.height * self.width * self.channels
        self.modules = nn.ModuleDict({"net": TARNet(
            self.n_tokens, d_model, nhead, num_layers, self.height, self.width,
            bool(class_cond), int(n_classes), dtype=dtype, flash=self.flash,
            dropout=float(dropout))})
        self.modules.eval()
        self.init_params(0)

    @property
    def net(self) -> TARNet:
        return self.modules["net"]

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = OptimizerSet().add(
            "opt", adam(step_lr(hp.lr, 0.99, self.steps_per_epoch), hp.b1, hp.b2), ["net"])
        self.state = self.make_state(seed)
        return self.state

    # ---------------------------------------------------------------- tokens
    def img2tokens(self, imgs: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """(N, H, W, C) model-space images -> (N, S) tokens: ``<sos>`` (the
        label when class-conditional, else 0), then the pixels thresholded
        at 0.5 after the normalisation (the reference's quirk), raster order."""
        n = imgs.shape[0]
        toks = (imgs >= 0.5).long().reshape(n, -1)
        if self.hparams.class_cond:
            sos = labels.to(imgs.device).long().reshape(n, 1)
        else:
            sos = torch.zeros(n, 1, dtype=torch.long, device=imgs.device)
        return torch.cat([sos, toks], dim=1)

    def tokens2img(self, tokens: torch.Tensor) -> torch.Tensor:
        n = tokens.shape[0]
        return tokens[:, 1:].reshape(n, self.height, self.width, self.channels).float()

    def cal_loss(self, tokens: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None,
                 attn_seeds: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Mean over the batch of the summed next-token NLL (nats)."""
        logits = self.net(tokens, train=train, generator=generator, attn_seeds=attn_seeds)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return nll.sum(dim=1).mean()

    # ----------------------------------------------------------------- steps
    def train_step(self, state: TrainState, batch,
                   attn_seeds: Optional[Sequence[torch.Tensor]] = None):
        """One Adam step on the net.  Dropout masks and the attention seeds
        are drawn from ``state.generator``; ``attn_seeds`` (one per layer)
        replaces the seeds of the ``dropout``/``hashdrop`` modes."""
        imgs_raw, labels = batch
        tokens = self.img2tokens(self.preprocess(imgs_raw), labels)
        denom = self.height * self.width * self.channels

        def loss_fn():
            loss = self.cal_loss(tokens, True, state.generator, attn_seeds)
            nll = loss.detach()
            return loss, {"train_log/nll": nll, "train_log/bpd": nll / denom / LOG2}

        state, _, metrics = self.optimizers.grad_step(state, "opt", loss_fn)
        state.step += 1
        return state, metrics

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample_tokens(self, init_tokens: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      gumbels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fill every -1 position of (N, S) tokens autoregressively, one KV
        decode step per position.  ``gumbels`` (S-1, N, n_tokens) replaces
        the Gumbel draws; a position that is not -1 keeps its token."""
        n, s = init_tokens.shape
        net = self.net
        tokens = init_tokens.to(self.device).long().clone()
        if gumbels is None:
            gumbels = gumbel_noise((s - 1, n, self.n_tokens), generator, self.device,
                                   self.mesh, axis=1)
        net.init_cache(n, s)
        try:
            for i in range(s - 1):
                logits = net.decode_step(tokens[:, i:i + 1], i)[:, 0]
                draw = torch.argmax(logits + gumbels[i], dim=-1)
                cur = tokens[:, i + 1]
                tokens[:, i + 1] = torch.where(cur != -1, cur, draw)
        finally:
            net.clear_cache()
        return tokens

    def start_tokens(self, n: int, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, S) tokens to sample: ``<sos>`` (the labels when
        class-conditional and given, else 0), then -1 everywhere."""
        tokens = torch.full((n, self.seq_len), -1, dtype=torch.long, device=self.device)
        if self.hparams.class_cond and labels is not None:
            tokens[:, 0] = labels.to(self.device).long()
        else:
            tokens[:, 0] = 0
        return tokens

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, H, W, C) images in {0, 1}; class-conditional models start from
        ``labels`` (class 0 when none are given)."""
        return self.tokens2img(self.sample_tokens(self.start_tokens(n, labels), generator))

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator: torch.Generator,
                        sample: bool = False):
        """bpd and the bpd of uniform random tokens; with ``sample`` the
        sample grid (8 per class when class-conditional, else a batch) and
        the completion of the batch's lower half in ``others``."""
        imgs_raw, labels = batch
        imgs = self.preprocess(imgs_raw)
        n = imgs.shape[0]
        denom = self.height * self.width * self.channels
        tokens = self.img2tokens(imgs, labels)
        loss = self.cal_loss(tokens, train=False)
        random_tokens = torch.randint(0, 2, tokens.shape, generator=generator,
                                      device=self.device)
        random_tokens[:, 0] = 0
        rand_loss = self.cal_loss(random_tokens, train=False)
        metrics = {"val_log/bpd": loss / denom / LOG2,
                   "val_log/rand_bpd": rand_loss / denom / LOG2}
        result = ValidationResult(real_image=imgs)
        if sample:
            hp = self.hparams
            if hp.class_cond:
                fake_labels = torch.arange(hp.n_classes, device=self.device
                                           ).repeat_interleave(8)
                fake = self.sample(hp.n_classes * 8, generator, fake_labels)
            else:
                fake = self.sample(n, generator)
            masked = tokens.clone()
            masked[:, 1 + denom // 2:] = -1
            result.fake_image = fake
            result.others = {"mask_image": self.tokens2img(
                self.sample_tokens(masked, generator))}
        return result, metrics
