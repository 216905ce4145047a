"""Progress reporting: own copy of ``igm_tpu/callbacks/util.py``'s
``ProgressBar`` (the ``tqdm`` callback of the configs)."""
from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class ProgressBar:
    """One summary line per epoch (a per-batch bar would read the device's
    metrics, and so wait for it, on every refresh)."""

    def __init__(self, refresh_rate: int = 5, **_: object):
        self.refresh_rate = refresh_rate

    def on_train_epoch_end(self, trainer, model) -> None:
        metrics = {k: round(v, 4) for k, v in
                   list(trainer.callback_metrics.items())[:4]}
        log.info("[epoch %d/%d] step=%d %s", trainer.current_epoch + 1,
                 trainer.max_epochs, trainer.global_step, metrics)
