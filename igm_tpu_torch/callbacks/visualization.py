"""Image grids and the sample-grid callback: the port's own copy of
``make_grid`` / ``get_grid_images`` / ``save_image_grid`` and
``SampleImagesCallback`` from ``igm_tpu/callbacks/visualization.py`` (numpy
+ PIL).  Grids follow torchvision.make_grid: pad_value=1, value_range
(-1, 1) when the model is trained on normalized inputs; images are NHWC.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def make_grid(imgs: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 1.0, normalize: bool = False,
              value_range=None) -> np.ndarray:
    """NHWC float -> HWC float grid in [0,1] (torchvision.make_grid parity)."""
    imgs = np.asarray(imgs, dtype=np.float32)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if normalize:
        lo, hi = value_range if value_range else (imgs.min(), imgs.max())
        imgs = np.clip((imgs - lo) / max(hi - lo, 1e-5), 0.0, 1.0)
    else:
        imgs = np.clip(imgs, 0.0, 1.0)
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full((padding + nrows * (h + padding),
                    padding + ncol * (w + padding), c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = imgs[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


def get_grid_images(imgs, model, nimgs: int = 64, nrow: int = 8) -> np.ndarray:
    """(visualization.py:141-148) value-range aware grid."""
    imgs = np.asarray(imgs)[:nimgs]
    if model.input_normalize:
        return make_grid(imgs, nrow=nrow, normalize=True, value_range=(-1, 1))
    return make_grid(imgs, nrow=nrow)


def save_image_grid(grid_hwc: np.ndarray, path: str) -> None:
    from PIL import Image
    arr = (np.clip(grid_hwc, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


class SampleImagesCallback:
    """Real/recon/fake/other grids to the logger at the first validation
    batch of every ``every_n_epochs``-th epoch, and the sample grid to
    ``results/{epoch}.jpg``.  Takes the host (numpy) ValidationResult the
    trainer hands over."""

    def __init__(self, batch_size: int = 64, every_n_epochs: int = 1):
        self.batch_size = batch_size
        self.every_n_epochs = every_n_epochs

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        if trainer.current_epoch % self.every_n_epochs != 0 or batch_idx != 0:
            return
        epoch = trainer.current_epoch
        logger = trainer.logger
        if outputs.real_image is not None:
            logger.log_image("images/real",
                             get_grid_images(outputs.real_image, model), epoch)
        if outputs.recon_image is not None:
            logger.log_image("images/recon",
                             get_grid_images(outputs.recon_image, model), epoch)
        if outputs.fake_image is not None:
            fake_grid = get_grid_images(outputs.fake_image, model)
            logger.log_image("images/sample", fake_grid, epoch)
            result_path = Path("results")
            result_path.mkdir(parents=True, exist_ok=True)
            save_image_grid(fake_grid, str(result_path / f"{epoch}.jpg"))
        for key, value in (outputs.others or {}).items():
            if value is not None:
                logger.log_image(f"images/{key}",
                                 get_grid_images(value, model), epoch)
