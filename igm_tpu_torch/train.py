"""Training entry: counterpart of ``igm_tpu/train.py``.

``train(config, device)``: datamodule -> model (the datamodule passed as
config, on ``device``: the card unless another is named) -> callbacks ->
logger -> Trainer -> fit, then ``test`` with ``test_after_training``.
Returns the ``optimized_metric`` when the config names one.

    python -m igm_tpu_torch.train experiment=ddpm/cifar10 [overrides] [--device cpu]

runs :func:`igm_tpu_torch.cli.train_main`.
"""
from __future__ import annotations

import logging
import warnings
from typing import Any, List

import torch

from .config import instantiate

log = logging.getLogger(__name__)


def train(config: Any, device: str | torch.device | None = None):
    if not config.get("model") or not config.get("datamodule"):
        raise SystemExit(
            "No model/datamodule selected. Pick an experiment, e.g.\n"
            "    python -m igm_tpu_torch.train experiment=ddpm/cifar10")
    if config.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if config.get("debug"):
        log.info("debug mode: forcing fast_dev_run")
        config["trainer"]["fast_dev_run"] = True
    datamodule = instantiate(config.datamodule)
    model = instantiate(config.model, datamodule=config.datamodule, device=device)
    log.info("instantiated model <%s> on %s", config.model._target_, model.device)

    callbacks: List[Any] = []
    for cb_conf in (config.get("callbacks") or {}).values():
        if isinstance(cb_conf, dict) and "_target_" in cb_conf:
            callbacks.append(instantiate(cb_conf))
    logger = instantiate(config.logger) if config.get("logger") else None

    trainer = instantiate(config.trainer, callbacks=callbacks, logger=logger)
    if config.get("seed") is not None:
        trainer.seed = int(config["seed"])
    trainer.fit(model=model, datamodule=datamodule)
    log.info("trained params: %d",
             sum(p.numel() for p in model.modules.parameters()))

    if config.get("test_after_training") and not trainer.fast_dev_run:
        trainer.test()
    metric = config.get("optimized_metric")
    return trainer.callback_metrics.get(metric) if metric else None


if __name__ == "__main__":
    from .cli import train_main
    train_main()
