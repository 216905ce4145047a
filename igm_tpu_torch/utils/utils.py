"""Logging helpers: the parts of ``igm_tpu/utils/utils.py`` the zoo calls
(``get_logger``, ``count_params``).  One process, so no rank guard."""
from __future__ import annotations

import logging

from torch import nn


def get_logger(name: str = "igm_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """A logger at ``level`` with one stream handler, unless the root
    logger already has one (then it propagates there)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def count_params(module: nn.Module) -> int:
    """The number of parameter elements of ``module``."""
    return sum(p.numel() for p in module.parameters())
