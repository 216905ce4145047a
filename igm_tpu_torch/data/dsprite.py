"""dSprites datamodule: the port's own copy of ``igm_tpu/data/dsprite.py``.

``dsprite/dsprites_64x64.npz`` (binary {0, 1} ``imgs``), split 80/20 by a
permutation from the fixed seed 666, the same split on every run; the
label slot is zeros.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import Arrays, BaseDatamodule

SPLIT_SEED = 666


class DataModule(BaseDatamodule):
    native_shape = (64, 64, 1)
    synthetic_binary = True

    def _load(self) -> Tuple[Arrays, Arrays]:
        path = self.data_dir / "dsprite" / "dsprites_64x64.npz"
        if not path.exists():
            raise FileNotFoundError(path)
        with np.load(path, allow_pickle=False) as z:
            imgs = np.asarray(z["imgs"], np.uint8)[..., None]
        order = np.random.default_rng(SPLIT_SEED).permutation(len(imgs))
        n_train = int(0.8 * len(imgs))
        tr, va = order[:n_train], order[n_train:]
        return ((imgs[tr], np.zeros((len(tr),), np.int32)),
                (imgs[va], np.zeros((len(va),), np.int32)))
