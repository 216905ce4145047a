"""BaseDatamodule: the port's own copy of ``igm_tpu/data/base.py``.

Geometry transforms (grayscale ITU-R 601, bicubic resize) run once on the
host when the arrays are built; ``convert``/``normalize`` run on the device
in the model's ``preprocess``, so host->device traffic stays uint8.  The
arrays are byte-identical to ``igm_tpu``'s for the same files and config.

Contract consumed by the Trainer:
    prepare_data()            nothing to do: the port packages no dataset
    setup()                   parse the dataset files -> uint8 arrays
    train_arrays()/val_arrays() -> (imgs uint8 NHWC, labels int32)

When the dataset files are absent, behaviour follows ``IGM_SYNTHETIC_DATA``:
"0" -> setup raises; otherwise the same deterministic structured synthetic
set as ``igm_tpu``'s stands in.
"""
from __future__ import annotations

import os
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def synthetic_allowed() -> bool:
    return os.environ.get("IGM_SYNTHETIC_DATA", "1") != "0"


class BaseDatamodule:
    #: parsed container geometry (h, w, c) before config transforms
    native_shape: Tuple[int, int, int] = (28, 28, 1)
    #: synthetic fallback emits {0,1} images (dSprites semantics)
    synthetic_binary: bool = False
    #: synthetic fallback sizes (train, val)
    synthetic_sizes: Tuple[int, int] = (640, 192)

    def __init__(self, data_dir: Optional[str] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 channels: Optional[int] = None, batch_size: int = 128,
                 num_workers: int = 8, n_classes: Any = None,
                 transforms: Optional[Dict[str, Any]] = None,
                 **kwargs: Any):
        # extra config keys (e.g. celeba's stringy `n_classes: None`) are
        # swallowed like the reference's **kargs (SURVEY.md §8)
        self.data_dir = Path(data_dir) if data_dir else Path("data")
        nh, nw, nc = self.native_shape
        self.height = int(height) if height else nh
        self.width = int(width) if width else nw
        self.channels = int(channels) if channels else nc
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        try:
            self.n_classes = int(n_classes)
        except (TypeError, ValueError):
            self.n_classes = None
        self.transforms = dict(transforms or {})
        self._train: Optional[Arrays] = None
        self._val: Optional[Arrays] = None
        self._cache: Dict[str, Arrays] = {}

    # ------------------------------------------------------------- data files
    def prepare_data(self) -> None:
        """Nothing to do: ``igm_tpu`` packages bundled digit scans here when
        real bytes are required and absent; the port reads only files that
        are there."""

    def setup(self) -> None:
        try:
            self._train, self._val = self._load()
        except FileNotFoundError:
            if not synthetic_allowed():
                raise
            self._train = self._synthetic("train")
            self._val = self._synthetic("val")
        self._cache.clear()

    # ------------------------------------------------------------- accessors
    def train_arrays(self) -> Arrays:
        return self._transformed("train")

    def val_arrays(self) -> Arrays:
        return self._transformed("val")

    # ---------------------------------------------------------------- parsing
    def _load(self) -> Tuple[Arrays, Arrays]:  # pragma: no cover - abstract
        """Parse the dataset's official container format.  Returns
        ((train_imgs, train_labels), (val_imgs, val_labels)) as uint8
        NHWC / int32."""
        raise NotImplementedError

    # ------------------------------------------------------------- transforms
    def _transformed(self, split: str) -> Arrays:
        if split not in self._cache:
            if self._train is None:
                raise RuntimeError("call setup() first")
            imgs, labels = self._train if split == "train" else self._val
            self._cache[split] = (self._apply_transforms(imgs),
                                  np.asarray(labels, np.int32))
        return self._cache[split]

    def _apply_transforms(self, imgs: np.ndarray) -> np.ndarray:
        """Host-side geometry transforms (reference get_transform parity:
        src/datamodules/base.py:37-71).  Grayscale first (ITU-R 601 — PIL
        convert("L") semantics), then resize to the configured geometry."""
        imgs = np.asarray(imgs)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        want_gray = (self.transforms.get("grayscale") or self.channels == 1)
        if want_gray and imgs.shape[-1] == 3:
            lum = (imgs[..., 0] * 0.299 + imgs[..., 1] * 0.587
                   + imgs[..., 2] * 0.114)
            imgs = np.clip(np.round(lum), 0, 255).astype(np.uint8)[..., None]
        imgs = self._resize(imgs, self.height, self.width)
        return np.ascontiguousarray(imgs)

    @staticmethod
    def _resize(imgs: np.ndarray, h: int, w: int) -> np.ndarray:
        if imgs.shape[1] == h and imgs.shape[2] == w:
            return imgs
        from PIL import Image
        c = imgs.shape[-1]
        out = np.empty((len(imgs), h, w, c), np.uint8)
        for i, im in enumerate(imgs):
            pil = Image.fromarray(im[..., 0] if c == 1 else im)
            # bicubic: the reference's resize default (base.py:44)
            arr = np.asarray(pil.resize((w, h), Image.BICUBIC))
            out[i] = arr[..., None] if c == 1 else arr
        return out

    # -------------------------------------------------------------- synthetic
    def _synthetic(self, split: str) -> Arrays:
        """Deterministic structured images (class-dependent blob + grating):
        enough signal for convergence tripwires, zero I/O.  Shapes follow
        the CONFIG geometry so transforms are a no-op."""
        n = self.synthetic_sizes[0 if split == "train" else 1]
        h, w, c = self.height, self.width, self.channels
        # stable across processes (Python str hash is PYTHONHASHSEED-salted)
        seed = zlib.crc32(f"{split}:{h}:{w}:{c}".encode())
        rng = np.random.default_rng(seed)
        labels = (np.arange(n) % 10).astype(np.int32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cy = (labels % 5 + 1) / 6.0 * h
        cx = (labels // 5 % 5 + 1) / 6.0 * w
        cy = cy + rng.normal(0, h * 0.04, n)
        cx = cx + rng.normal(0, w * 0.04, n)
        d2 = ((yy[None] - cy[:, None, None]) ** 2
              + (xx[None] - cx[:, None, None]) ** 2)
        sigma2 = (0.12 * (h + w) / 2) ** 2
        blob = np.exp(-d2 / (2 * sigma2))
        phase = labels[:, None, None] * 0.7
        grating = 0.25 * (1 + np.sin(xx[None] * (2 * np.pi / w)
                                     * (1 + labels[:, None, None] % 3)
                                     + phase))
        img = np.clip(blob + grating * 0.3, 0, 1)
        img = np.repeat(img[..., None], c, axis=-1)
        img = img + rng.normal(0, 0.02, img.shape)
        if self.synthetic_binary:
            arr = (img > 0.5).astype(np.uint8)
        else:
            arr = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
        return arr, labels
