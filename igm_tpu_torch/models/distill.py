"""Progressive distillation (Salimans & Ho, ICLR 2022): counterpart of
``igm_tpu/models/distill.py``.

One run is one halving phase: a student, initialised from the teacher,
learns to match two deterministic DDIM steps of the frozen teacher with
one of its own, so a 2N-step teacher becomes an N-step student.  The
model is a :class:`~igm_tpu_torch.models.ddpm.DDPM` (l2 loss and
v-prediction by default), so every DDPM sampler keeps working; its
``ddim_steps`` is ``student_steps``.

The frozen teacher lives in ``opt_states["teacher"]``, a dict of tensors
by parameter name like the EMA shadow, so it goes into checkpoints and
resumes with them; its forwards are ``torch.func.functional_call`` of the
denoiser under ``no_grad`` (neither the EMA shadow nor a nested CUDA
graph), and the train step stays capturable by ``train_step_n``.
``teacher_ckpt`` names a directory of the port's own checkpoints (a DDPM
run of the same config) or a converted ``igm_tpu`` checkpoint (an ``.npz``
from ``tools/igm_tpu_ckpt_to_npz.py``): its denoiser, the EMA shadow preferred when the
checkpoint carries one, becomes both the teacher and the student's
initial weights (and the student's EMA shadow's, where ``igm_tpu`` leaves
the shadow at the fresh init).  Without it the teacher is a copy of the
fresh student.

The train step: per sample a student time t = grid[2i], i ~ U{1..N}, on
the 2N+1-point phase grid over the discrete timesteps; x_t = q_sample(x,
t, noise); two clipped teacher DDIM steps t -> grid[2i-1] -> grid[2i-2]
give the implied one-step clean target (paper eq. 9); the loss is the
truncated-SNR weighted, max(alpha^2 / sigma^2, 1), x0-space l2.  Three
network forwards (two teacher, one student) and one backward a step.

``student_sample`` runs N deterministic DDIM steps on the phase grid's
even entries with the implied x0 clipped, as ``igm_tpu``'s code does;
``sample`` clips it to [-1, 1].  For tests, the train step takes its
draws as tensors and ``student_sample`` its initial draw as ``noises``.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..core.state import TrainState
from ..ops import diffusion as gd
from .base import noise_source
from .ddpm import DDPM


class ProgressiveDistillation(DDPM):
    def __init__(self, datamodule: Any, student_steps: int = 8,
                 teacher_ckpt: str | None = None, **kwargs):
        """Same keyword arguments as ``igm_tpu``'s ProgressiveDistillation;
        the DDPM ones (``device`` included) go to :class:`DDPM`."""
        kwargs.setdefault("loss_type", "l2")
        kwargs.setdefault("parameterization", "v")
        super().__init__(datamodule, **kwargs)
        if self.num_classes:
            raise ValueError("progressive distillation is unconditional "
                             "(CFG-aware distillation not implemented)")
        if student_steps < 1 or 2 * student_steps > self.timesteps:
            raise ValueError(f"student_steps must be in [1, timesteps/2], got "
                             f"{student_steps} (timesteps={self.timesteps})")
        self.hparams["student_steps"] = int(student_steps)
        self.hparams["teacher_ckpt"] = str(teacher_ckpt or "")
        self.hparams["ddim_steps"] = int(student_steps)
        self._grid_t = torch.from_numpy(self._phase_grid().astype(np.int64)).to(self.device)

    # ------------------------------------------------------------------ state
    def init_state(self, seed: int = 0) -> TrainState:
        """DDPM's state, then the teacher under ``opt_states["teacher"]``:
        from ``teacher_ckpt`` when one is named (the student and its EMA
        shadow start from it), else a copy of the fresh student."""
        state = super().init_state(seed)
        net = self.modules["denoise"]
        ckpt = self.hparams["teacher_ckpt"]
        if ckpt:
            self._load_teacher(ckpt)
            if "ema" in state.opt_states:
                self.init_ema(state, "denoise")
        state.opt_states["teacher"] = {k: p.detach().clone()
                                       for k, p in net.named_parameters()}
        return state

    def _load_teacher(self, ckpt: str) -> None:
        """The denoiser of the newest checkpoint in the port's checkpoint
        directory ``ckpt`` (or of the converted ``igm_tpu`` checkpoint
        ``ckpt``, an ``.npz``) into the student, with the EMA shadow's
        weights when the checkpoint carries one."""
        from ..core.checkpoint import read_checkpoint
        raw = read_checkpoint(ckpt)
        got = {k[len("denoise."):]: v for k, v in raw["params"].items()
               if k.startswith("denoise.")}
        if not got:
            raise ValueError(f"teacher_ckpt {ckpt} has no 'denoise' params - not a "
                             "ddpm-family checkpoint?")
        net = self.modules["denoise"]
        have_shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        got_shapes = {k: tuple(v.shape) for k, v in got.items()}
        if have_shapes != got_shapes:
            raise ValueError(f"teacher denoiser shape mismatch (config vs ckpt):\n"
                             f"  config    {have_shapes}\n  checkpoint {got_shapes}")
        net.load_state_dict(got, strict=True)
        ema = raw.get("opt_states", {}).get("ema")
        if ema:
            with torch.no_grad():
                for k, p in net.named_parameters():
                    p.copy_(ema[k])

    # ----------------------------------------------------------- phase ladder
    def _phase_grid(self) -> np.ndarray:
        """The ascending 2N+1-point timestep ladder: even entries the
        student's N+1 times, odd entries the teacher's midpoints."""
        big_n = int(self.hparams["student_steps"])
        return np.linspace(0, self.timesteps - 1, 2 * big_n + 1).round().astype(np.int32)

    def _teacher_eps(self, state: TrainState, x: torch.Tensor, t: torch.Tensor):
        """The frozen teacher's eps prediction (a v prediction converted
        exactly)."""
        out = torch.func.functional_call(self.modules["denoise"], state.opt_states["teacher"],
                                         (x, t.float(), None))
        if self.hparams.parameterization == "v":
            out = gd.eps_from_v(self.tables, x, t, out)
        return out

    @staticmethod
    def _ddim_det(tables, x, eps, t, t_prev, clip: bool = True):
        """One deterministic DDIM step t -> t_prev (t_prev may be 0: a_prev
        from the table); ``clip`` bounds the implied x0 to [-1, 1] and
        re-derives eps from it."""
        a_t = gd.extract(tables.alphas_cumprod, t, x.ndim)
        a_p = gd.extract(tables.alphas_cumprod, t_prev, x.ndim)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if clip:
            x0 = torch.clamp(x0, -1.0, 1.0)
            eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        return torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps

    @torch.no_grad()
    def _distill_target(self, state: TrainState, x_t, t, tm, tp):
        """Two teacher DDIM steps t -> tm -> tp, then the implied one-step
        clean target ``(z'' - (sig''/sig_t) x_t) / (alf'' - (sig''/sig_t)
        alf_t)``."""
        tbl = self.tables
        z1 = self._ddim_det(tbl, x_t, self._teacher_eps(state, x_t, t), t, tm)
        z2 = self._ddim_det(tbl, z1, self._teacher_eps(state, z1, tm), tm, tp)
        a_t = gd.extract(tbl.alphas_cumprod, t, x_t.ndim)
        a_p = gd.extract(tbl.alphas_cumprod, tp, x_t.ndim)
        alf_t, sig_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        alf_p, sig_p = torch.sqrt(a_p), torch.sqrt(1.0 - a_p)
        ratio = sig_p / sig_t
        return (z2 - ratio * x_t) / (alf_p - ratio * alf_t)

    # ------------------------------------------------------------------ train
    def distill_loss(self, state: TrainState, x: torch.Tensor, i: torch.Tensor,
                     noise: torch.Tensor):
        """The distillation loss for clean images ``x``, student indices
        ``i`` (N,) in 1..N and noise -> (loss, metrics)."""
        grid = self._grid_t
        t, tm, tp = grid[2 * i], grid[2 * i - 1], grid[2 * i - 2]
        x_t = gd.q_sample(self.tables, x, t, noise)
        target = self._distill_target(state, x_t, t, tm, tp)
        a_t = gd.extract(self.tables.alphas_cumprod, t, x.ndim)
        w = torch.clamp(a_t / (1.0 - a_t), min=1.0)
        pred = self.modules["denoise"](x_t, t.float(), None)
        if self.hparams.parameterization == "v":
            x0_hat = torch.sqrt(a_t) * x_t - torch.sqrt(1.0 - a_t) * pred
        else:
            x0_hat = (x_t - torch.sqrt(1.0 - a_t) * pred) / torch.sqrt(a_t)
        loss = (w * (target - x0_hat) ** 2).mean()
        return loss, {"train_loss/loss": loss.detach()}

    def train_step(self, state: TrainState, batch, i: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """One Adam step on the student, then the EMA update.  Draws from
        ``state.generator``, in this order, what is not given: i ~ U{1..N}
        and the noise."""
        imgs = self._to_diffusion_space(self.preprocess(batch[0]))
        n = imgs.shape[0]
        gen = state.generator
        if i is None:
            i = self.batch_draw(functools.partial(
                torch.randint, 1, int(self.hparams["student_steps"]) + 1), (n,), gen)
        if noise is None:
            noise = self.batch_draw(torch.randn, imgs.shape, gen)
        self.modules.train()
        try:
            state, _, metrics = self.optimizers.grad_step(
                state, "opt", lambda: self.distill_loss(state, imgs, i, noise))
        finally:
            self.modules.eval()
        self.update_ema(state, "denoise")
        state.step += 1
        return state, metrics

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def student_sample(self, n: int, generator: Optional[torch.Generator] = None,
                       noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """N deterministic DDIM steps on the times the student was distilled
        for, the phase grid's even entries from T-1 down to 0."""
        seq = self._phase_grid()[::2][::-1].tolist()
        x = noise_source(self, self._sample_shape(n), generator, noises)()
        for t_cur, t_next in zip(seq[:-1], seq[1:]):
            tb = torch.full((n,), t_cur, dtype=torch.long, device=self.device)
            eps = self._eps(x, tb.float())
            x = self._ddim_det(self.tables, x, eps, tb, torch.full_like(tb, t_next))
        return x

    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        return torch.clamp(self.student_sample(n, generator), -1.0, 1.0)
