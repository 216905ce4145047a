"""VQ-VAE: counterpart of ``igm_tpu/models/vqvae.py``.

The codebook (K, D) starts U(-1/K, 1/K); the loss is the reconstruction MSE
+ the vq loss + beta * the commitment loss, through the straight-through
estimator ``z + (quant - z).detach()``.  The nearest-code search is
``ops.vq.quantize``: on the card it launches the nearest-codebook kernel,
once per forward.

The train step updates everything in place (parameters, Adam state, the
EMA codebook's buffers) and draws nothing, so ``train_step_n`` captures it
on the card (``models/base.py``), the nearest-codebook kernel inside.

Quirk kept: the reference config passes ``K: 512``, which lands in
``**kwargs`` while ``num_embeddings`` keeps its default; both spellings are
accepted.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import nn

from ..config import instantiate
from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..ops.vq import quantize
from ..parallel.mesh import all_reduce_
from .base import BaseModel, ValidationResult


class VectorQuantizer(nn.Module):
    """Holds the codebook; ``forward(z, train)`` quantises an NHWC latent
    grid -> (quant, vq_loss, commit_loss, idx).

    ``ema=False`` (the reference's mode): the codebook is the parameter
    ``embedding``, pulled toward the encoder outputs by the vq loss.
    ``ema=True``: exponential-moving-average cluster means (van den Oord
    2017, appendix A.1).  ``embedding``, ``cluster_size`` and
    ``cluster_sum`` are buffers, where ``igm_tpu`` keeps its ``codebook``
    mutable collection, so they ride the state_dict and the checkpoints;
    each training forward moves every used code toward the mean of the
    encoder vectors assigned to it, with Laplace-smoothed counts.  Bound to
    a data-axis mesh (``bind_mesh``), the batch's counts and sums are summed
    over the ranks first, so every rank moves the codebook as one process
    on the global batch does.
    """

    def __init__(self, num_embeddings: int, latent_dim: int, ema: bool = False,
                 ema_decay: float = 0.99, ema_eps: float = 1e-5):
        super().__init__()
        k, d = int(num_embeddings), int(latent_dim)
        self.num_embeddings, self.ema = k, bool(ema)
        self.ema_decay, self.ema_eps = float(ema_decay), float(ema_eps)
        if self.ema:
            self.register_buffer("embedding", torch.empty(k, d))
            self.register_buffer("cluster_size", torch.zeros(k))
            self.register_buffer("cluster_sum", torch.empty(k, d))
        else:
            self.embedding = nn.Parameter(torch.empty(k, d))
        self.mesh = None

    def bind_mesh(self, mesh, blocks: int = 1) -> None:
        self.mesh = mesh

    def reset_parameters(self, generator: torch.Generator) -> None:
        k = self.num_embeddings
        with torch.no_grad():
            self.embedding.uniform_(-1.0 / k, 1.0 / k, generator=generator)
            if self.ema:
                self.cluster_size.zero_()
                self.cluster_sum.copy_(self.embedding)

    def forward(self, z: torch.Tensor, train: bool = True):
        n, h, w, d = z.shape
        flat = z.reshape(-1, d)
        quant, idx = quantize(flat, self.embedding)
        commit_loss = ((flat - quant.detach()) ** 2).mean()
        if not self.ema:
            vq_loss = ((flat.detach() - quant) ** 2).mean()
            return quant.reshape(n, h, w, d), vq_loss, commit_loss, idx
        if train:
            self._ema_update(flat.detach(), idx)
        vq_loss = torch.zeros((), dtype=flat.dtype, device=flat.device)
        return quant.reshape(n, h, w, d), vq_loss, commit_loss, idx

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        """``igm_tpu/models/vqvae.py:86-100``: the counts and sums as one-hot
        contractions (a fixed summation order on the card, no atomics)."""
        k, g = self.num_embeddings, self.ema_decay
        onehot = torch.nn.functional.one_hot(idx.long(), k).float()   # (M, K)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ flat.float()
        if self.mesh is not None:
            counts, sums = all_reduce_(self.mesh, [counts, sums], mean=False)
        cs = g * self.cluster_size + (1.0 - g) * counts
        csum = g * self.cluster_sum + (1.0 - g) * sums
        total = cs.sum()
        smoothed = (cs + self.ema_eps) / (total + k * self.ema_eps) * total
        self.cluster_size.copy_(cs)
        self.cluster_sum.copy_(csum)
        self.embedding.copy_(csum / smoothed[:, None])


class VQVAE(BaseModel):
    def __init__(self, datamodule: Any, encoder: Any = None, decoder: Any = None,
                 latent_dim: int = 100, lr: float = 2e-4, b1: float = 0.5,
                 b2: float = 0.999, num_embeddings: int = 512, beta: float = 0.25,
                 optim: str = "adam", codebook_update: str = "gradient",
                 ema_decay: float = 0.99,
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s VQVAE, plus ``device``
        (the card unless the CPU is asked for).  ``optim`` is accepted; the
        optimizer is Adam, as there.  The networks compute in float32."""
        super().__init__(datamodule, device)
        num_embeddings = int(kwargs.pop("K", num_embeddings))
        if codebook_update not in ("gradient", "ema"):
            raise ValueError(f"codebook_update={codebook_update!r} "
                             "(expected 'gradient' or 'ema')")
        self.save_hyperparameters(latent_dim=latent_dim, lr=lr, b1=b1, b2=b2,
                                  num_embeddings=num_embeddings, beta=beta,
                                  codebook_update=codebook_update,
                                  ema_decay=ema_decay)
        self.modules = nn.ModuleDict({
            "decoder": instantiate(decoder, input_channel=latent_dim,
                                   output_channel=self.channels),
            "encoder": instantiate(encoder, input_channel=self.channels,
                                   output_channel=latent_dim),
            "vq": VectorQuantizer(num_embeddings, latent_dim,
                                  ema=(codebook_update == "ema"),
                                  ema_decay=ema_decay)})
        self.latent_h = self.height // 4
        self.latent_w = self.width // 4
        self.modules.eval()
        self.init_params(0)

    def init_state(self, seed: int = 0) -> TrainState:
        hp = self.hparams
        self.optimizers = OptimizerSet().add(
            "opt", adam(hp.lr, hp.b1, hp.b2), ["encoder", "decoder", "vq"])
        self.state = self.make_state(seed)
        return self.state

    def _autoencode(self, imgs: torch.Tensor, train: bool, straight_through: bool):
        enc_z = self.modules["encoder"](imgs)
        quant, vq_loss, commit, _ = self.modules["vq"](enc_z, train=train)
        dec_in = enc_z + (quant - enc_z).detach() if straight_through else quant
        recon = self.modules["decoder"](dec_in).reshape(imgs.shape)
        return recon, vq_loss, commit

    def loss(self, imgs: torch.Tensor):
        """(total loss, metrics) of a training forward on preprocessed
        images; in ``ema`` mode the forward also moves the codebook."""
        recon, vq_loss, commit = self._autoencode(imgs, train=True,
                                                  straight_through=True)
        recon_loss = ((recon - imgs) ** 2).mean()
        total = recon_loss + vq_loss + float(self.hparams.beta) * commit
        return total, {"train_loss/vq_loss": vq_loss.detach(),
                       "train_loss/recon_loss": recon_loss.detach(),
                       "train_loss/commit_loss": commit.detach()}

    def train_step(self, state: TrainState, batch):
        """One Adam step on the encoder, decoder and (gradient mode) the
        codebook."""
        imgs = self.preprocess(batch[0])
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(imgs))
        finally:
            self.modules.eval()
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def forward(self, state: Optional[TrainState], imgs: torch.Tensor) -> torch.Tensor:
        """Reconstruction of preprocessed images (no codebook update)."""
        recon, _, _ = self._autoencode(imgs, train=False, straight_through=False)
        return recon

    def codebook(self, state: Optional[TrainState] = None) -> torch.Tensor:
        """The (K, D) codebook: a parameter or (ema) a buffer."""
        return self.modules["vq"].embedding

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decode a uniform-random grid of code indices.  A VQ-VAE has no
        learned prior over its codes (the trained prior over this latent
        space is ``experiment=latent_ddpm/*``); this keeps the generic
        sampling tools runnable, as ``igm_tpu``'s override does."""
        idx = self.batch_draw(functools.partial(torch.randint, 0,
                                                int(self.hparams.num_embeddings)),
                              (n, self.latent_h * self.latent_w), generator)
        quant = self.codebook()[idx].reshape(n, self.latent_h, self.latent_w,
                                             int(self.hparams.latent_dim))
        imgs = self.modules["decoder"](quant)
        return imgs.reshape(n, self.height, self.width, self.channels)

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: Optional[torch.Generator] = None,
                        sample: bool = False):
        imgs = self.preprocess(batch[0])
        recon = self.forward(state, imgs)
        mse = ((imgs - recon) ** 2).mean()
        return (ValidationResult(real_image=imgs, recon_image=recon, label=batch[1]),
                {"val/recon_loss": mse})
