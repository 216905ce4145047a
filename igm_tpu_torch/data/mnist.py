"""MNIST datamodule: the port's own copy of ``igm_tpu/data/mnist.py``.

The official IDX containers in the torchvision on-disk layout
``MNIST/raw/{train,t10k}-{images,labels}-idx{3,1}-ubyte[.gz]`` (the test
split serves as val).  The parser honours the IDX header (magic byte 3 =
0x08 for unsigned bytes, byte 4 = the number of dimensions, big-endian
dimensions) rather than assuming offsets.
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from .base import Arrays, BaseDatamodule


def read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        magic = struct.unpack(">I", fh.read(4))[0]
        if magic >> 8 != 0x08:  # 0x08 = unsigned byte element type
            raise FileNotFoundError(f"{path}: bad IDX magic {magic:#x}")
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        data = np.frombuffer(fh.read(), dtype=np.uint8)
    if data.size != int(np.prod(dims)):
        raise FileNotFoundError(f"{path}: payload size != header dims {dims}")
    return data.reshape(dims)


def _find(raw: Path, stem: str) -> Path:
    for suffix in (".gz", ""):
        p = raw / f"{stem}{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(raw / stem)


class MNISTDataModule(BaseDatamodule):
    native_shape = (28, 28, 1)

    def _load(self) -> Tuple[Arrays, Arrays]:
        raw = self.data_dir / "MNIST" / "raw"
        out = []
        for split in ("train", "t10k"):
            imgs = read_idx(_find(raw, f"{split}-images-idx3-ubyte"))
            labels = read_idx(_find(raw, f"{split}-labels-idx1-ubyte"))
            out.append((imgs[..., None], labels.astype(np.int32)))
        return out[0], out[1]
