"""Trainer: the epoch loop.  Counterpart of ``igm_tpu/core/trainer.py``.

- one train step per batch (``model.train_step``), eager on the model's
  device; batches come through a prefetcher that copies the next uint8
  batches to the card while the current step runs;
- metrics are read back only every ``log_every_n_steps`` steps, one step
  late, so the host does not wait for the card on every step;
- per epoch: ``perf/imgs_per_sec``, ``perf/epoch_time_sec`` and, on a CUDA
  card, ``perf/achieved_tflops`` and ``perf/mfu`` against the H100 SXM
  dense bf16 peak (989 TFLOP/s).  The FLOPs of a step come from
  ``torch.utils.flop_counter.FlopCounterMode`` around the first step: it
  counts the aten operations (convolutions, matrix products), not the
  port's own CUDA kernels, which it cannot see;
- validation every ``check_val_every_n_epoch`` epochs (and after the last),
  handing host ValidationResults to the callbacks;
- a checkpoint every ``ckpt_every_n_epochs`` epochs and at the end; with
  ``resume`` a run continues from the newest checkpoint there, at its
  step, with the data order and random stream an uninterrupted run would
  have had.

One device: ``devices`` is 1 and ``mesh`` may only be the one-device
default ({data: -1, model: 1}); anything else raises.  ``steps_per_execution``
(``igm_tpu``'s ``lax.scan`` chaining) is accepted and resolves to 1.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loader import DevicePrefetcher, epoch_batches
from .logging import MetricAccumulator, NoOpLogger, TensorBoardLogger

log = logging.getLogger(__name__)

H100_BF16_DENSE_FLOPS = 989e12


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Trainer:
    def __init__(
        self,
        devices: int = 1,
        max_epochs: int = 20,
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 50,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        fast_dev_run: bool = False,
        seed: int = 42,
        steps_per_execution: Any = 1,
        mesh: Optional[Dict[str, int]] = None,
        ckpt_every_n_epochs: int = 1,
        resume: Optional[str] = None,
        callbacks: Sequence[Any] = (),
        logger: Optional[TensorBoardLogger] = None,
        enable_checkpointing: bool = True,
        profile: bool = False,
        **_: Any,
    ):
        if devices not in (None, -1, 1):
            raise NotImplementedError(f"devices={devices}: the port trains on one device")
        mesh_cfg = dict(mesh or {})
        data_axis = mesh_cfg.pop("data", -1)
        model_axis = mesh_cfg.pop("model", 1)
        if data_axis not in (None, -1, 1) or model_axis not in (None, 1) or mesh_cfg:
            raise NotImplementedError(f"mesh={mesh}: the port trains on one device "
                                      f"(mesh.data -1 or 1, mesh.model 1)")
        if isinstance(steps_per_execution, str) and steps_per_execution != "auto":
            raise ValueError(f"steps_per_execution must be an int or 'auto', got "
                             f"{steps_per_execution!r}")
        if profile:
            raise NotImplementedError("trainer.profile: use "
                                      "python -m igm_tpu_torch.tools.profile_training")
        log.info("steps_per_execution=%r resolves to 1 (one step per call)",
                 steps_per_execution)
        self.steps_per_execution = 1
        self.max_epochs = int(max_epochs)
        self.check_val_every_n_epoch = int(check_val_every_n_epoch)
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.fast_dev_run = bool(fast_dev_run)
        self.seed = int(seed) if seed is not None else 0
        self.ckpt_every_n_epochs = int(ckpt_every_n_epochs)
        self.resume = resume
        self.callbacks = list(callbacks)
        self.logger = logger if logger is not None else NoOpLogger()
        self.enable_checkpointing = bool(enable_checkpointing)
        if self.fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1
            self.enable_checkpointing = False

        # populated during fit
        self.state = None
        self.model = None
        self.datamodule = None
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics: Dict[str, float] = {}
        self.ckpt_manager = None
        self.step_flops: Optional[float] = None

    # -------------------------------------------------------------------- fit
    def fit(self, model, datamodule) -> None:
        self.model = model
        self.datamodule = datamodule
        datamodule.prepare_data()
        datamodule.setup()
        train_arrays = datamodule.train_arrays()
        val_arrays = datamodule.val_arrays()
        batch_size = int(datamodule.batch_size)
        n_train = len(train_arrays[0])
        steps_per_epoch = max(n_train // batch_size, 1)
        if self.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, int(self.limit_train_batches))
        model.steps_per_epoch = steps_per_epoch

        hp = {f"model/{k}": v for k, v in model.hparams.items()
              if isinstance(v, (int, float, bool, str))}
        hp["datamodule/batch_size"] = batch_size
        hp["trainer/max_epochs"] = self.max_epochs
        self.logger.log_hyperparams(hp)

        state = model.init_state(self.seed)
        if self.enable_checkpointing:
            from .checkpoint import CheckpointManager
            self.ckpt_manager = CheckpointManager(str(self.resume or "checkpoints"))
            if self.resume and self.ckpt_manager.latest_step() is not None:
                state = self.ckpt_manager.restore(state)
                state = model.on_restore(state)
                log.info("resumed from step %d", state.step)
        self.state = state
        device = model.device

        data_rng = np.random.default_rng(self.seed)
        start_epoch = state.step // steps_per_epoch
        for _ in range(start_epoch):          # the epochs a resumed run skips
            data_rng.permutation(n_train)
        self.global_step = state.step
        last_saved = None
        acc = MetricAccumulator()
        t_train = time.perf_counter()
        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            acc.reset()
            epoch_t0 = time.perf_counter()
            n_batches = 0
            pending = None               # (step, device metrics), read one step late
            batches = epoch_batches(train_arrays, batch_size, rng=data_rng,
                                    shuffle=True, limit=self.limit_train_batches)
            for batch in DevicePrefetcher(batches, device):
                if self.step_flops is None:
                    from torch.utils.flop_counter import FlopCounterMode
                    with FlopCounterMode(display=False) as counter:
                        state, metrics = model.train_step(state, batch)
                    self.step_flops = float(counter.get_total_flops())
                else:
                    state, metrics = model.train_step(state, batch)
                if pending is not None:
                    self._log_metrics(acc, *pending)
                    pending = None
                if self.global_step % self.log_every_n_steps == 0:
                    pending = (self.global_step, metrics)
                last = (self.global_step, metrics)
                self.global_step += 1
                n_batches += 1
            if pending is None and n_batches and not acc.compute():
                pending = last           # a short epoch still reports a sample
            if pending is not None:
                self._log_metrics(acc, *pending)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.state = state
            epoch_time = time.perf_counter() - epoch_t0
            imgs_per_sec = n_batches * batch_size / max(epoch_time, 1e-9)
            self.logger.log_scalar("perf/imgs_per_sec", imgs_per_sec, self.global_step)
            self.logger.log_scalar("perf/epoch_time_sec", epoch_time, self.global_step)
            if device.type == "cuda" and self.step_flops:
                achieved = self.step_flops * n_batches / max(epoch_time, 1e-9)
                self.logger.log_scalar("perf/achieved_tflops", achieved / 1e12,
                                       self.global_step)
                self.logger.log_scalar("perf/mfu", achieved / H100_BF16_DENSE_FLOPS,
                                       self.global_step)
            self.callback_metrics.update(acc.compute())
            log.info("epoch %d done in %.1fs (%.0f imgs/s) %s", epoch, epoch_time,
                     imgs_per_sec, {k: round(v, 4) for k, v in acc.compute().items()})

            if ((epoch + 1) % self.check_val_every_n_epoch == 0
                    or epoch == self.max_epochs - 1):
                self._run_validation(val_arrays, batch_size, epoch)
            model.on_train_epoch_end(self)
            for cb in self.callbacks:
                if hasattr(cb, "on_train_epoch_end"):
                    cb.on_train_epoch_end(self, model)
            if self.ckpt_manager is not None and (epoch + 1) % self.ckpt_every_n_epochs == 0:
                self.ckpt_manager.save(state.step, state)
                last_saved = state.step

        self.state = state
        if self.ckpt_manager is not None:
            if last_saved != state.step:
                self.ckpt_manager.save(state.step, state)
            self.ckpt_manager.wait()
        for cb in self.callbacks:
            if hasattr(cb, "on_train_end"):
                cb.on_train_end(self, model)
        self.logger.finalize()
        log.info("fit finished in %.1fs", time.perf_counter() - t_train)

    def _log_metrics(self, acc: MetricAccumulator, step: int, metrics) -> None:
        host = {k: float(v) for k, v in metrics.items()}
        acc.update(host)
        self.logger.log_scalars(host, step)

    # ------------------------------------------------------------- validation
    def _run_validation(self, val_arrays, batch_size: int, epoch: int) -> None:
        from ..models.base import ValidationResult

        model = self.model
        device = model.device
        for cb in self.callbacks:
            if hasattr(cb, "on_validation_epoch_start"):
                cb.on_validation_epoch_start(self, model)
        acc = MetricAccumulator()
        batches = epoch_batches(val_arrays, batch_size, shuffle=False,
                                limit=self.limit_val_batches)
        for batch_idx, batch in enumerate(batches):
            dev_batch = tuple(torch.from_numpy(a).to(device) for a in batch)
            generator = torch.Generator(device=device).manual_seed(
                ((self.seed + 7919) * 1_000_003 + epoch * 100_003 + batch_idx)
                % (2 ** 63))
            result, metrics = model.validation_step(self.state, dev_batch, generator,
                                                    sample=(batch_idx == 0))
            acc.update({k: float(v) for k, v in metrics.items()})
            out = ValidationResult(
                others={k: _np(v) for k, v in (result.others or {}).items()
                        if v is not None},
                real_image=_np(result.real_image), fake_image=_np(result.fake_image),
                recon_image=_np(result.recon_image), label=_np(result.label),
                encode_latent=_np(result.encode_latent))
            for cb in self.callbacks:
                if hasattr(cb, "on_validation_batch_end"):
                    cb.on_validation_batch_end(self, model, out, batch, batch_idx)
        val_metrics = acc.compute()
        self.callback_metrics.update(val_metrics)
        self.logger.log_scalars(val_metrics, self.global_step)
        for cb in self.callbacks:
            if hasattr(cb, "on_validation_epoch_end"):
                cb.on_validation_epoch_end(self, model)

    def test(self, model=None, datamodule=None) -> Dict[str, float]:
        """Evaluate on the val split (the datamodules serve the test set as
        val) with the fitted state."""
        self.model = model or self.model
        datamodule = datamodule or self.datamodule
        if self.state is None:
            raise RuntimeError("call fit() first")
        self._run_validation(datamodule.val_arrays(), int(datamodule.batch_size),
                             self.current_epoch)
        return dict(self.callback_metrics)
