"""Logging helpers: the parts of ``igm_tpu/utils/utils.py`` the zoo calls
(``get_logger``, ``count_params``).  No rank guard: the training entry
logs on every rank."""
from __future__ import annotations

import logging
import math

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
    """The number of parameter elements of ``module`` (a model axis's
    shard counts its whole parameter's)."""
    def whole(p) -> int:
        leaf = getattr(p, "_igm_leaf", None)
        return p.numel() if leaf is None else math.prod(leaf.shape)
    return sum(whole(p) for p in module.parameters())
