"""CelebA datamodule: the port's own copy of ``igm_tpu/data/celeba.py``.

The aligned JPEGs ``celeba/img_align_celeba/*.jpg`` and the partition file
``celeba/list_eval_partition.txt`` (0 = train, 1 = valid, 2 = test; train
and test are used).  Each split is decoded once (PIL, imported when it
runs; RGB, bicubic resize to the configured geometry) and cached as
``celeba/cache_{split}_{h}x{w}.npz``, which later runs read instead.
Labels are zeros (no model reads the attributes).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from .base import Arrays, BaseDatamodule


class CelebADataModule(BaseDatamodule):
    native_shape = (64, 64, 3)

    def _cache_path(self, split: str) -> Path:
        return self.data_dir / "celeba" / f"cache_{split}_{self.height}x{self.width}.npz"

    def _partition(self) -> Tuple[List[str], List[str]]:
        part_file = self.data_dir / "celeba" / "list_eval_partition.txt"
        if not part_file.exists():
            raise FileNotFoundError(part_file)
        train, test = [], []
        for line in part_file.read_text().splitlines():
            if not line.strip():
                continue
            name, part = line.split()
            if part == "0":
                train.append(name)
            elif part == "2":
                test.append(name)
        return train, test

    def _decode(self, names: List[str]) -> np.ndarray:
        from PIL import Image
        img_dir = self.data_dir / "celeba" / "img_align_celeba"
        out = np.empty((len(names), self.height, self.width, 3), np.uint8)
        for i, name in enumerate(names):
            with Image.open(img_dir / name) as im:
                im = im.convert("RGB").resize((self.width, self.height), Image.BICUBIC)
                out[i] = np.asarray(im)
        return out

    def _split_arrays(self, split: str, names: List[str]) -> Arrays:
        cache = self._cache_path(split)
        if cache.exists():
            with np.load(cache, allow_pickle=False) as z:
                imgs = np.asarray(z["imgs"], np.uint8)
        else:
            imgs = self._decode(names)
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache, imgs=imgs)
        return imgs, np.zeros((len(imgs),), np.int32)

    def _load(self) -> Tuple[Arrays, Arrays]:
        train_names, test_names = self._partition()
        return (self._split_arrays("train", train_names),
                self._split_arrays("val", test_names))
