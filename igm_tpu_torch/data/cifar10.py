"""CIFAR-10 datamodule: the port's own copy of ``igm_tpu/data/cifar10.py``.

The official python-pickle batches ``cifar-10-batches-py/{data_batch_1..5,
test_batch}`` (the test split serves as val); the ``data`` payload is
(N, 3072) with R|G|B planes, deinterleaved to NHWC uint8.  The batches are
unpickled, so point ``data_dir`` only at files from the dataset's
distribution.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Tuple

import numpy as np

from .base import Arrays, BaseDatamodule


def _load_batch(path: Path) -> Arrays:
    if not Path(path).exists():
        raise FileNotFoundError(path)
    with open(path, "rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    flat = np.asarray(d[b"data"], np.uint8)
    imgs = flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # planes->NHWC
    labels = np.asarray(d[b"labels"], np.int32)
    return np.ascontiguousarray(imgs), labels


class CIFAR10DataModule(BaseDatamodule):
    native_shape = (32, 32, 3)

    def _load(self) -> Tuple[Arrays, Arrays]:
        bdir = self.data_dir / "cifar-10-batches-py"
        parts = [_load_batch(bdir / f"data_batch_{i}") for i in range(1, 6)]
        train = (np.concatenate([p[0] for p in parts]),
                 np.concatenate([p[1] for p in parts]))
        val = _load_batch(bdir / "test_batch")
        return train, val
