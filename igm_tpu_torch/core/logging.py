"""TensorBoard logging and metric accumulation.

Own copy of ``igm_tpu/core/logging.py``'s ``TensorBoardLogger``,
``NoOpLogger`` and ``MetricAccumulator``; tag names are the same
(``train_loss/*``, ``perf/*``, ``images/*``).  tensorboardX is imported at
the first write: a run without it fails there, it is never silently not
logged.  Use ``logger=null`` (a ``NoOpLogger``) to log nothing.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


class TensorBoardLogger:
    """tensorboardX-backed logger."""

    def __init__(self, save_dir: str = "tensorboard/", name: str = "",
                 version: str = "", **_: object):
        self.save_dir = os.path.join(save_dir, name, version)
        self._writer = None

    @property
    def experiment(self):
        if self._writer is None:
            from tensorboardX import SummaryWriter
            os.makedirs(self.save_dir, exist_ok=True)
            self._writer = SummaryWriter(self.save_dir)
        return self._writer

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self.experiment.add_scalar(tag, float(value), step)

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        for tag, value in metrics.items():
            if value is None or (isinstance(value, float) and np.isnan(value)):
                continue
            self.log_scalar(tag, value, step)

    def log_image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        """img_hwc: float array (H, W, C) in [0, 1]."""
        self.experiment.add_image(tag, img_hwc, step, dataformats="HWC")

    def log_hyperparams(self, params: Dict[str, object]) -> None:
        flat = {k: (v if isinstance(v, (int, float, bool, str)) else str(v))
                for k, v in params.items()}
        self.experiment.add_hparams(flat, {})

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()


class NoOpLogger(TensorBoardLogger):
    """Logs nothing (the trainer's logger when none is configured)."""

    def __init__(self):
        super().__init__()

    def log_scalar(self, *a, **k) -> None:
        pass

    def log_image(self, *a, **k) -> None:
        pass

    def log_hyperparams(self, *a, **k) -> None:
        pass

    def finalize(self) -> None:
        pass


class MetricAccumulator:
    """Running means of per-step metrics; NaN entries (a phase that did not
    run this step) are skipped."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            v = float(v)
            if np.isnan(v):
                continue
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._counts[k] = self._counts.get(k, 0) + 1

    def compute(self) -> Dict[str, float]:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()
