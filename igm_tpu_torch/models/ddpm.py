"""DDPM: counterpart of ``igm_tpu/models/ddpm.py``'s constructor, train
state, train step (l1/l2 loss on an eps or v target, Min-SNR weight,
classifier-free-guidance label drop, EMA shadow), validation step, denoiser
call, classifier-free guidance, and the samplers: ancestral, DDIM,
DPM-Solver++(2M), interpolation and RePaint inpainting.

``igm_tpu`` runs each chain as one ``lax.scan``; here it is a Python loop
over the timesteps, one denoiser forward per step.  On a CUDA card (with
``use_graphs``) that forward is a CUDA graph: ``_denoise`` calls
``BaseModel.network``, which replays a graph captured per input signature
(the EMA weights when the state keeps a shadow); the per-step update
arithmetic stays eager.  Random draws take an explicit
``torch.Generator`` (training: the TrainState's); for tests, the train
step also takes its timesteps, noise and label drop as tensors, and the
samplers their initial ``x`` and per-step draws.  The train step draws
only from the state's generator, updates the EMA shadow in place and
changes only ``state.step`` on the host, so ``train_step_n`` can capture
it.

``denoise_channels``, ``_sample_shape`` and ``_to_diffusion_space`` are the
hooks through which ``LatentDDPM`` diffuses in a VQ-VAE's latent space.

``build_denoiser`` is the backbone factory the diffusion-style models share
(``igm_tpu/models/ddpm.py:25-53``): ``network=unet`` the conv UNet,
``network=dit`` the DiT (``hidden_dim`` its token width), with its
Switch-MoE blocks when ``moe_experts > 0``; the train step then adds
``moe_aux_weight`` times the mean load-balance aux over the MoE blocks to
the loss and reports it (``train_loss/moe_aux``) with the router's load
entropy and smallest share (``moe/load_entropy``, ``moe/min_share``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.optim import OptimizerSet, adam
from ..core.state import TrainState
from ..networks.dit import DiT
from ..networks.unet import Unet
from ..ops import diffusion as gd
from .base import BaseModel, ValidationResult, draw_labels


def build_denoiser(network: str, *, hidden_dim: int, channels: int, dim_mults,
                   dtype: torch.dtype | None, num_classes: int, remat: bool,
                   depth: int = 8, heads: int = 6, patch: int = 2, attention: str = "auto",
                   block_mode: str = "unroll", pipe_mesh=None, pipe_microbatches: int = 1,
                   sp_mesh=None, moe_experts: int = 0, moe_every: int = 2,
                   moe_capacity: float = 1.25, moe_dispatch: str = "auto") -> nn.Module:
    """The conv ``Unet`` (``network="unet"``) or the ``DiT`` (``"dit"``,
    ``hidden_dim`` its token width; ``pipe_mesh``, ``pipe_microbatches``
    and ``sp_mesh`` its pipeline and sequence parallelism).  ``igm_tpu``'s
    ``pallas_gn`` is not among the keywords: the kernels always run on the
    card."""
    if network == "unet":
        return Unet(dim=hidden_dim, channels=channels, dim_mults=tuple(dim_mults),
                    num_classes=num_classes, dtype=dtype, remat=remat)
    if network == "dit":
        return DiT(dim=hidden_dim, depth=depth, heads=heads, patch=patch,
                   channels=channels, num_classes=num_classes, dtype=dtype, remat=remat,
                   attn=attention, block_mode=block_mode, pipe_mesh=pipe_mesh,
                   pipe_microbatches=pipe_microbatches, sp_mesh=sp_mesh,
                   moe_experts=moe_experts,
                   moe_every=moe_every, moe_capacity=moe_capacity,
                   moe_dispatch=moe_dispatch)
    raise ValueError(f"network must be unet|dit, got {network!r}")


def moe_loss(net: nn.Module, loss: torch.Tensor, weight: float, metrics: dict):
    """The Switch load-balance aux of a DiT's MoE blocks (their last
    forward) added to ``loss`` with ``weight``, and the router-health
    metrics, as ``igm_tpu``'s train step aggregates them -> (loss,
    metrics).  A network without MoE blocks leaves both as they are."""
    stats = net.take_moe_stats() if isinstance(net, DiT) else []
    if not stats:
        return loss, metrics
    aux = sum(a for a, _ in stats) / len(stats)
    loss = loss + weight * aux
    load = sum(ld for _, ld in stats) / len(stats)           # [E] mean fraction
    e = load.shape[0]
    ent = -torch.sum(load * torch.log(load + 1e-9))
    return loss, {**metrics, "train_loss/loss": loss.detach(),
                  "train_loss/moe_aux": aux.detach(),
                  "moe/load_entropy": (ent / math.log(float(e))).detach(),
                  "moe/min_share": (load.min() * e).detach()}


class DDPM(BaseModel):
    def __init__(self, datamodule: Any, hidden_dim: int = 64,
                 timesteps: int = 1000, loss_type: str = "l1",
                 dim_mults: Sequence[int] = (1, 2, 4, 8), lr: float = 2e-4,
                 b1: float = 0.5, b2: float = 0.999, optim: str = "adam",
                 beta_schedule: str = "cosine", sample_batch: int = 64,
                 compute_dtype: str = "auto", remat: bool = False,
                 ema_decay: float = 0.0, val_sampler: str = "ancestral",
                 ddim_steps: int = 50, dpm_steps: int = 20,
                 dpm_schedule: str = "uniform",
                 pallas_gn: str | bool = "auto",
                 num_classes: int | None = 0, cond_drop_prob: float = 0.1,
                 guidance_scale: float = 2.0, network: str = "unet",
                 depth: int = 8, heads: int = 6, patch: int = 2,
                 parameterization: str = "eps", snr_gamma: float = 0.0,
                 attention: str = "auto", block_mode: str = "unroll",
                 pipe_mesh=None, pipe_microbatches: int = 1, sp_mesh=None,
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity: float = 1.25, moe_aux_weight: float = 0.01,
                 moe_dispatch: str = "auto",
                 device: str | torch.device | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s DDPM, plus ``device``
        (the card unless the CPU is asked for).

        ``compute_dtype="auto"`` is bfloat16 on CUDA and float32 on the CPU.
        ``pallas_gn`` is accepted and has no effect: on the card the
        GroupNorm+Mish kernels always run.  ``remat`` recomputes each UNet
        ResnetBlock in the backward.  ``optim`` is accepted; the optimizer is
        Adam, as in ``igm_tpu``.  The DiT keywords (``depth``, ``heads``,
        ``patch``, ``attention``, ``block_mode``, ``pipe_mesh``,
        ``pipe_microbatches``, ``sp_mesh``, ``moe_*``) are ignored with the
        unet backbone.
        """
        super().__init__(datamodule, device)
        if parameterization not in ("eps", "v"):
            raise ValueError(f"parameterization must be eps|v, "
                             f"got {parameterization!r}")
        if loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type={loss_type!r}")
        self.num_classes = int(num_classes or 0)
        self.save_hyperparameters(hidden_dim=hidden_dim, timesteps=timesteps,
                                  loss_type=loss_type,
                                  dim_mults=list(dim_mults), lr=lr, b1=b1,
                                  b2=b2, beta_schedule=beta_schedule,
                                  sample_batch=sample_batch,
                                  ema_decay=ema_decay,
                                  val_sampler=val_sampler,
                                  ddim_steps=ddim_steps, dpm_steps=dpm_steps,
                                  dpm_schedule=dpm_schedule,
                                  num_classes=self.num_classes,
                                  cond_drop_prob=cond_drop_prob,
                                  guidance_scale=guidance_scale,
                                  network=network, depth=depth, heads=heads,
                                  patch=patch,
                                  parameterization=parameterization,
                                  snr_gamma=snr_gamma, attention=attention,
                                  block_mode=block_mode,
                                  pipe_microbatches=pipe_microbatches,
                                  moe_experts=int(moe_experts),
                                  moe_aux_weight=float(moe_aux_weight))
        self.timesteps = int(timesteps)
        self.tables = gd.make_tables(self.timesteps, beta_schedule, self.device)
        if compute_dtype == "auto":
            compute_dtype = ("bfloat16" if self.device.type == "cuda"
                             else "float32")
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.compute_dtype = dtype or torch.float32
        self.modules = nn.ModuleDict({"denoise": build_denoiser(
            network, hidden_dim=hidden_dim, channels=self.denoise_channels,
            dim_mults=dim_mults, dtype=dtype, num_classes=self.num_classes,
            remat=bool(remat), depth=depth, heads=heads, patch=patch,
            attention=attention, block_mode=block_mode, pipe_mesh=pipe_mesh,
            pipe_microbatches=int(pipe_microbatches), sp_mesh=sp_mesh,
            moe_experts=int(moe_experts),
            moe_every=int(moe_every), moe_capacity=float(moe_capacity),
            moe_dispatch=str(moe_dispatch))})
        self.modules.eval()
        self.init_params(0)

    def enable_sequence_parallel(self, mesh) -> None:
        """Rebuild the denoiser with Megatron-SP over ``mesh``'s model axis
        (``networks/dit.py`` ``sp_mesh``): composes with ``mode=tensor`` on
        the same ``(data, model)`` mesh (and runs on ``mode=fsdp`` too).
        Trainer ``mesh.sequence=true`` calls this."""
        self._rebuild_dit("sequence parallelism", sp_mesh=mesh)

    def enable_pipeline(self, mesh, microbatches: int = 1) -> None:
        """Rebuild the denoiser for GPipe pipeline parallelism
        (``parallel/pipeline.py``): the scan layout, its blocks split over
        ``mesh``'s stages, ``microbatches`` a step.  Call it before
        ``init_state`` on the mesh (the state is then born split).  Trainer
        ``mesh.mode=pipeline`` calls this."""
        self._rebuild_dit("pipeline parallelism", block_mode="scan", pipe_mesh=mesh,
                          pipe_microbatches=int(microbatches))

    def _rebuild_dit(self, what: str, **changes) -> None:
        """``igm_tpu``'s ``den.clone(**changes)``: the denoiser rebuilt
        with ``changes``, the parameters it had loaded into it."""
        if self.hparams.get("network") != "dit":
            raise ValueError(f"{what} needs network=dit "
                             f"(got {self.hparams.get('network')!r})")
        if self.sharding is not None:
            raise ValueError(f"{what}: rebuild the denoiser before its state is sharded "
                             f"(before set_mesh and init_state)")
        den = self.modules["denoise"]
        new = den.clone(**changes)
        new.load_state_dict(den.state_dict())
        self.modules["denoise"] = new.train(den.training).to(self.device)
        self._graphs.clear()

    # hooks overridden by LatentDDPM (diffusion in a learned latent space)
    @property
    def denoise_channels(self) -> int:
        return self.channels

    def _sample_shape(self, n: int) -> tuple:
        return (n, self.height, self.width, self.channels)

    def _to_diffusion_space(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs

    # ------------------------------------------------------------------ train
    def init_state(self, seed: int = 0) -> TrainState:
        """Adam over the denoiser; with ``ema_decay > 0`` the EMA shadow of
        its parameters under ``opt_states["ema"]``."""
        hp = self.hparams
        self.optimizers = OptimizerSet().add(
            "opt", adam(hp.lr, hp.b1, hp.b2), ["denoise"])
        state = self.make_state(seed)
        self.init_ema(state, "denoise")
        self.state = state
        return state

    def loss(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             y: Optional[torch.Tensor] = None):
        """The training loss for clean images ``x_start`` (model space),
        integer timesteps ``t``, noise and (conditional) labels ``y`` ->
        (loss, metrics)."""
        hp = self.hparams
        x_noisy = gd.q_sample(self.tables, x_start, t, noise)
        if hp.parameterization == "v":
            target = gd.v_target(self.tables, x_start, t, noise)
        else:
            target = noise
        w = gd.loss_weight(self.tables, t, x_start.ndim, str(hp.parameterization),
                           float(hp.snr_gamma))
        net = self.modules["denoise"]
        pred = net(x_noisy, t, y)
        if hp.loss_type == "l1":
            loss = (w * torch.abs(target - pred)).mean()
        else:
            loss = (w * (target - pred) ** 2).mean()
        return moe_loss(net, loss, float(hp.moe_aux_weight),
                        {"train_loss/loss": loss.detach()})

    def train_step(self, state: TrainState, batch,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None):
        """One Adam step on the denoiser, then the EMA update.

        Draws, from ``state.generator`` in this order, what is not given:
        the timesteps ``t`` ~ U{0..T-1}, the noise, and (conditional) the
        label-drop mask with probability ``cond_drop_prob``: dropped labels
        become the null token."""
        imgs_raw, labels = batch
        imgs = self._to_diffusion_space(self.preprocess(imgs_raw))
        n = imgs.shape[0]
        gen = state.generator
        if t is None:
            t = self.batch_draw(functools.partial(torch.randint, 0, self.timesteps), (n,), gen)
        if noise is None:
            noise = self.batch_draw(torch.randn, imgs.shape, gen)
        y = draw_labels(self, labels, n, gen, drop)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.loss(imgs, t, noise, y))
        finally:
            self.modules.eval()
        self.update_ema(state, "denoise")
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch,
                        generator: torch.Generator, sample: bool = False):
        """The batch, the batch diffused to t = T-1, and with ``sample`` a
        ``sample_batch`` of samples from ``val_sampler`` (ancestral|ddim|dpm)."""
        imgs = self.preprocess(batch[0])
        n = imgs.shape[0]
        t = torch.full((n,), self.timesteps - 1, dtype=torch.long,
                       device=self.device)
        diffused = gd.q_sample(self.tables, imgs, t,
                               self._noise(imgs.shape, generator))
        result = ValidationResult(real_image=imgs, others={"diffusion": diffused})
        if sample:
            result.fake_image = self._validation_samples(generator)
        return result, {}

    def _validation_samples(self, generator: torch.Generator) -> torch.Tensor:
        """``sample_batch`` samples from ``val_sampler``: ddim and dpm with
        their configured steps (and, conditional, the class blocks under
        ``guidance_scale``), else the ancestral chain."""
        n_s = int(self.hparams.sample_batch)
        fast = {"ddim": (self.ddim_sample, "ddim_steps"),
                "dpm": (self.dpm_sample, "dpm_steps")}
        if self.hparams.val_sampler in fast:
            fn, steps_key = fast[self.hparams.val_sampler]
            cond = {}
            if self.num_classes:
                cond = dict(y=self._default_labels(n_s),
                            guidance=float(self.hparams.guidance_scale))
            return fn(n_s, steps=int(self.hparams[steps_key]), generator=generator,
                      **cond)
        return self.sample(n_s, generator)

    def _noise(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.batch_draw(torch.randn, shape, generator)

    # --------------------------------------------------------------- sampling
    def _denoise(self, x: torch.Tensor, t: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoiser (``BaseModel.network``: the EMA shadow's weights when
        the train state has one; on the card a CUDA graph per input
        signature)."""
        if self.num_classes and y is None:
            # unconditional generation from a conditional model = the
            # trained null token
            y = torch.full((x.shape[0],), self.num_classes, dtype=torch.long,
                           device=x.device)
        return self.network("denoise", x, t, y)

    @torch.no_grad()
    def _eps(self, x: torch.Tensor, t: torch.Tensor,
             y: Optional[torch.Tensor] = None,
             guidance: float = 1.0) -> torch.Tensor:
        """Noise prediction with optional classifier-free guidance,
        ``eps = eps_null + s * (eps_y - eps_null)``; the two branches run as
        one doubled batch.  A v-predicting network is converted to eps here,
        the one choke point every sampler goes through."""
        if self.num_classes == 0 or y is None or guidance == 1.0:
            out = self._denoise(x, t, y)
        else:
            null = torch.full_like(y, self.num_classes)
            out2 = self._denoise(torch.cat([x, x]), torch.cat([t, t]),
                                 torch.cat([y, null]))
            out_y, out_null = torch.chunk(out2, 2)
            out = out_null + guidance * (out_y - out_null)
        if self.hparams.parameterization == "v":
            out = gd.eps_from_v(self.tables, x, t.long(), out)
        return out

    @property
    def x0_bound(self) -> float:
        """Clamp for implied-x0 predictions inside the samplers: images are
        normalized to [-1, 1]."""
        return 1.0

    def _clip_x0(self, x0: torch.Tensor) -> torch.Tensor:
        b = self.x0_bound
        return torch.clamp(x0, -b, b) if b > 0 else x0

    @torch.no_grad()
    def p_sample(self, x: torch.Tensor, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 clip_denoised: bool = True, y=None, guidance: float = 1.0,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step p(x_{t-1} | x_t); ``t`` is a (N,) integer batch.
        ``noise`` replaces the step's N(0, I) draw."""
        eps = self._eps(x, t.float(), y, guidance)
        x_recon = gd.predict_start_from_noise(self.tables, x, t, eps)
        if clip_denoised:
            x_recon = self._clip_x0(x_recon)
        mean, _var, log_var = gd.q_posterior(self.tables, x_recon, x, t)
        if noise is None:
            noise = self._noise(x.shape, generator)
        nonzero = (t > 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    @torch.no_grad()
    def p_sample_loop(self, shape, generator: Optional[torch.Generator] = None,
                      t_start: Optional[int] = None,
                      init_x: Optional[torch.Tensor] = None, y=None,
                      guidance: float = 1.0,
                      noises: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """The full ancestral chain.  ``noises[i]`` replaces the i-th step's
        draw (steps counted from t_start - 1 down to 0)."""
        t_start = self.timesteps if t_start is None else t_start
        x = self._noise(shape, generator) if init_x is None else init_x
        for i, t in enumerate(range(t_start - 1, -1, -1)):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=self.device)
            x = self.p_sample(x, tb, generator, y=y, guidance=guidance,
                              noise=None if noises is None else noises[i])
        return x

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        guidance = 1.0
        if self.num_classes:
            if y is None:
                y = self._default_labels(n)
            guidance = float(self.hparams.guidance_scale)
        return self.p_sample_loop(self._sample_shape(n), generator, y=y,
                                  guidance=guidance)

    @torch.no_grad()
    def ddim_sample(self, n: int, steps: int = 50, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None, y=None,
                    guidance: float = 1.0, clip_denoised: bool = True,
                    x_T: Optional[torch.Tensor] = None,
                    noises: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """DDIM (Song et al. 2021) over an evenly spaced timestep
        subsequence; eta=0 is the deterministic sampler.  When
        ``clip_denoised`` bounds the implied x0, eps is re-derived from the
        clipped x0 so the (x0, eps) pair stays consistent, as in
        ``igm_tpu``.  ``x_T`` replaces the initial draw and ``noises[i]``
        the i-th step's."""
        shape = self._sample_shape(n)
        x = self._noise(shape, generator) if x_T is None else x_T
        seq = np.round(np.linspace(0, self.timesteps - 1, steps)).astype(np.int64)
        seq_prev = np.concatenate([[-1], seq[:-1]])
        acp = self.tables.alphas_cumprod
        one = torch.ones((), device=self.device)
        for i, (t, t_prev) in enumerate(zip(seq[::-1], seq_prev[::-1])):
            tb = torch.full((n,), int(t), dtype=torch.long, device=self.device)
            eps = self._eps(x, tb.float(), y, guidance)
            a_t = acp[int(t)]
            a_prev = acp[int(t_prev)] if t_prev >= 0 else one
            x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
            if clip_denoised and self.x0_bound > 0:
                x0 = self._clip_x0(x0)
                eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
            sigma = (eta * torch.sqrt((1 - a_prev) / (1 - a_t))
                     * torch.sqrt(1 - a_t / a_prev))
            dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
            if t_prev >= 0 and eta > 0:
                noise = (self._noise(shape, generator) if noises is None
                         else noises[i])
                x = x + sigma * noise
        return x

    def _dpm_timesteps(self, steps: int, schedule: str,
                       rho: float = 7.0) -> np.ndarray:
        """The ascending timestep subsequence of :meth:`dpm_sample`, in numpy
        on the float32 tables upcast to float64, as ``igm_tpu`` computes it:
        ``uniform`` spaces t evenly; ``logsnr`` spaces the half-log-SNR
        lambda evenly; ``karras`` spaces sigma^(1/rho) evenly with sigma_max
        clamped to 80.  Targets map to the nearest discrete t and duplicates
        are dropped, so the result can be shorter than ``steps``."""
        if schedule == "uniform":
            return np.linspace(0, self.timesteps - 1, steps).round().astype(np.int32)
        acp = self.tables.alphas_cumprod.cpu().numpy().astype(np.float64)
        sig = np.sqrt((1.0 - acp) / acp)            # VP sigma(t), ascending in t
        if schedule == "logsnr":
            lam = 0.5 * np.log(acp / (1.0 - acp))
            targets = np.linspace(lam[-1], lam[0], steps)
            t = np.abs(lam[None, :] - targets[:, None]).argmin(axis=1)
        elif schedule == "karras":
            smin, smax = sig[0], min(float(sig[-1]), 80.0)
            frac = np.linspace(0.0, 1.0, steps)
            sk = (smax ** (1 / rho) + frac * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
            t = np.abs(sig[None, :] - sk[:, None]).argmin(axis=1)
        else:
            raise ValueError(f"dpm schedule must be uniform|logsnr|karras, "
                             f"got {schedule!r}")
        return np.unique(t).astype(np.int32)

    @torch.no_grad()
    def dpm_sample(self, n: int, steps: int = 20, y=None, guidance: float = 1.0,
                   schedule: Optional[str] = None,
                   generator: Optional[torch.Generator] = None,
                   x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022): the deterministic second-order
        multistep sampler in half-log-SNR space, data-prediction form, one
        UNet forward per timestep of :meth:`_dpm_timesteps` (``schedule``:
        ``hparams.dpm_schedule`` when None).  The last step goes to a virtual
        t = -1 at lambda + 30 (alpha 1, sigma 0); the first and the last step
        are first order.  The implied x0 is clipped by ``_clip_x0`` every
        step.  ``x_T`` replaces the initial draw."""
        shape = self._sample_shape(n)
        x = self._noise(shape, generator) if x_T is None else x_T
        if schedule is None:
            schedule = str(self.hparams.dpm_schedule)
        seq = self._dpm_timesteps(steps, schedule)
        t_next = np.concatenate([[-1], seq[:-1]])
        # the step coefficients depend on the timesteps alone: float32 numpy
        # scalars on the host, as igm_tpu computes them in float32 in its scan
        acp = self.tables.alphas_cumprod.cpu().numpy()
        one = np.float32(1.0)

        def lam(a):
            return np.float32(0.5) * (np.log(a) - np.log1p(-a))

        x0_prev, h_prev = None, np.float32(0.0)
        for t, tn in zip(seq[::-1].tolist(), t_next[::-1].tolist()):
            a_cur = acp[t]
            sigma_cur, lam_cur = np.sqrt(one - a_cur), lam(a_cur)
            final = tn < 0
            if final:                   # h = 30: expm1(-h) == -1 in float32
                alpha_n, sigma_n, lam_n = one, np.float32(0.0), lam_cur + np.float32(30.0)
            else:
                a_next = acp[tn]
                alpha_n, sigma_n, lam_n = np.sqrt(a_next), np.sqrt(one - a_next), lam(a_next)
            tb = torch.full((n,), t, dtype=torch.long, device=self.device)
            eps = self._eps(x, tb.float(), y, guidance)
            x0 = self._clip_x0(gd.predict_start_from_noise(self.tables, x, tb, eps))
            h = lam_n - lam_cur
            d = x0
            if h_prev != 0 and not final:           # second order
                r = h_prev / (h if h != 0 else one)
                d = x0 + (x0 - x0_prev) / float(max(np.float32(2.0) * r, np.float32(1e-12)))
            x = float(sigma_n / sigma_cur) * x - float(alpha_n * np.expm1(-h)) * d
            x0_prev, h_prev = x0, h
        return x

    @torch.no_grad()
    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None,
                    weight: float = 0.5, generator: Optional[torch.Generator] = None,
                    diffuse_noise: Optional[Sequence[torch.Tensor]] = None,
                    noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Diffuse x1 and x2 to level t (default T-1), lerp by ``weight``,
        then run the ancestral chain from ``t_start = t``: its first step is
        t - 1, as in ``igm_tpu``.  ``diffuse_noise`` replaces the two forward
        draws, ``noises`` the chain's."""
        t = self.timesteps - 1 if t is None else t
        tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=self.device)
        z1, z2 = (diffuse_noise if diffuse_noise is not None else
                  (self._noise(x1.shape, generator), self._noise(x2.shape, generator)))
        img = ((1.0 - weight) * gd.q_sample(self.tables, x1, tb, z1)
               + weight * gd.q_sample(self.tables, x2, tb, z2))
        return self.p_sample_loop(x1.shape, generator, t_start=t, init_x=img,
                                  noises=noises)

    @torch.no_grad()
    def inpaint(self, x0: torch.Tensor, mask: torch.Tensor, resample: int = 1,
                y=None, guidance: float = 1.0,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None,
                draws: Optional[Sequence[tuple]] = None) -> torch.Tensor:
        """RePaint (Lugmayr et al. 2022, Alg. 1): the ancestral chain over all
        T steps, where after every reverse step the known region (``mask`` 1,
        broadcast to x0; 0 = hole) is replaced by x0 diffused to the level
        the step produced (t - 1; x0 itself at t = 0).  ``resample=U`` runs
        each step U times, re-diffusing one beta_t step between passes (not
        after the last pass, nor at t = 0).  Ends with the exact composite,
        so known pixels come back bit for bit.

        ``x_T`` replaces the initial draw and ``draws[i]`` the i-th pass's
        (reverse, known, forward) draws, passes counted over t = T-1 .. 0
        and u = 0 .. U-1."""
        mask = torch.broadcast_to(mask, x0.shape).to(x0.dtype)
        x = self._noise(x0.shape, generator) if x_T is None else x_T
        u_total = max(int(resample), 1)
        betas = self.tables.betas
        n = x0.shape[0]
        i = 0
        for t in range(self.timesteps - 1, -1, -1):
            tb = torch.full((n,), t, dtype=torch.long, device=self.device)
            for u in range(u_total):
                rev, known, fwd = draws[i] if draws is not None else (None,) * 3
                i += 1
                x_un = self.p_sample(x, tb, generator, y=y, guidance=guidance, noise=rev)
                if t > 0:
                    if known is None:
                        known = self._noise(x0.shape, generator)
                    x_kn = gd.q_sample(self.tables, x0, tb - 1, known)
                else:
                    x_kn = x0
                x = mask * x_kn + (1.0 - mask) * x_un
                if u < u_total - 1 and t > 0:
                    if fwd is None:
                        fwd = self._noise(x.shape, generator)
                    x = torch.sqrt(1.0 - betas[t]) * x + torch.sqrt(betas[t]) * fwd
        return mask * x0 + (1.0 - mask) * x
