"""Image grids and the visualization callbacks: the port's own copy of
``igm_tpu/callbacks/visualization.py`` (numpy + PIL; matplotlib imported
when a scatter is drawn).  Grids follow torchvision.make_grid: pad_value=1,
value_range (-1, 1) when the model is trained on normalized inputs; images
are NHWC.  The callbacks take the host (numpy) ValidationResult the trainer
hands over; the latent decodes run on the model's device
(``model.forward``).
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Optional

import numpy as np
import torch


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
    batch of every ``every_n_epochs``-th epoch, the sample grid to
    ``results/{epoch}.jpg`` and (beyond ``igm_tpu``, which only logs them)
    the reconstruction grid to ``results/recon_{epoch}.jpg`` and the grid of
    each ``others`` entry named ``*_image`` (TAR's masked-half completion) to
    ``results/{key}_{epoch}.jpg``, so a run without a logger still leaves
    them on disk.  Takes the host (numpy)
    ValidationResult the trainer hands over."""

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
        result_path = Path("results")
        if outputs.recon_image is not None:
            recon_grid = get_grid_images(outputs.recon_image, model)
            logger.log_image("images/recon", recon_grid, epoch)
            result_path.mkdir(parents=True, exist_ok=True)
            save_image_grid(recon_grid, str(result_path / f"recon_{epoch}.jpg"))
        if outputs.fake_image is not None:
            fake_grid = get_grid_images(outputs.fake_image, model)
            logger.log_image("images/sample", fake_grid, epoch)
            result_path.mkdir(parents=True, exist_ok=True)
            save_image_grid(fake_grid, str(result_path / f"{epoch}.jpg"))
        for key, value in (outputs.others or {}).items():
            if value is not None:
                grid = get_grid_images(value, model)
                logger.log_image(f"images/{key}", grid, epoch)
                if key.endswith("_image"):          # a model's extra samples
                    result_path.mkdir(parents=True, exist_ok=True)
                    save_image_grid(grid, str(result_path / f"{key}_{epoch}.jpg"))


def _decode(trainer, model, z: np.ndarray) -> np.ndarray:
    imgs = model.forward(trainer.state, torch.from_numpy(z).to(model.device))
    return imgs.float().cpu().numpy()


class TraverseLatentCallback:
    """Per-latent-dimension traversal grids at every validation epoch's end
    (11 values in [-3, 3] for each of the first min(10, latent_dim)
    dimensions): around the 4th and 7th encoded latents of the first
    validation batch, and around a random latent drawn from the global
    ``np.random`` as ``igm_tpu`` draws it.  Logged as ``sample/<name>``."""

    def __init__(self, col: int = 10, row: int = 10):
        self.col = col
        self.row = row
        self.z: Optional[np.ndarray] = None

    def _traverse_grid(self, trainer, model, fixed_z: Optional[np.ndarray]):
        latent_dim = int(model.hparams["latent_dim"])
        row, col = 11, min(10, latent_dim)
        if fixed_z is None:
            base = np.random.randn(1, 1, latent_dim).astype(np.float32)
        else:
            base = np.asarray(fixed_z, np.float32).reshape(1, 1, latent_dim)
        z = np.tile(base, (row, col, 1))
        variation = np.linspace(-3, 3, row, dtype=np.float32)
        for i in range(col):
            z[:, i, i] = variation
        imgs = _decode(trainer, model, z.reshape(row * col, -1))
        return get_grid_images(imgs, model, nimgs=row * col, nrow=col)

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        if batch_idx == 0:
            self.z = outputs.encode_latent

    def on_validation_epoch_end(self, trainer, model):
        if "latent_dim" not in model.hparams:
            return
        epoch = trainer.current_epoch
        grids = []
        if self.z is not None and len(self.z) > 6:
            grids += [("fixed_traverse_latents_1", self.z[3]),
                      ("fixed_traverse_latents_2", self.z[6])]
        grids.append(("random_traverse_latents", None))
        for name, z in grids:
            trainer.logger.log_image(f"sample/{name}", self._traverse_grid(trainer, model, z),
                                     epoch)


class Visual2DSpaecCallback:
    """A 20 x 20 grid of decoded 2-D latents over [-3, 3]^2 (latent_dim 2
    only)."""

    def on_validation_epoch_end(self, trainer, model):
        if int(model.hparams.get("latent_dim", 0)) != 2:
            return
        x = np.linspace(-3, 3, 20, dtype=np.float32)
        y = np.linspace(3, -3, 20, dtype=np.float32)
        yy, xx = np.meshgrid(y, x, indexing="ij")
        latent = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1)
        imgs = _decode(trainer, model, latent)
        trainer.logger.log_image("sample/grid_imgs",
                                 get_grid_images(imgs, model, nimgs=400, nrow=20),
                                 trainer.current_epoch)


class LatentVisualizationCallback:
    """A scatter of the validation set's 2-D latents coloured by label
    (latent_dim 2 only)."""

    def __init__(self):
        self.latents = []
        self.labels = []

    def on_validation_epoch_start(self, trainer, model):
        self.latents, self.labels = [], []

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        if int(model.hparams.get("latent_dim", 0)) != 2:
            return
        if outputs.encode_latent is not None and outputs.label is not None:
            self.latents.append(np.asarray(outputs.encode_latent))
            self.labels.append(np.asarray(outputs.label))

    def on_validation_epoch_end(self, trainer, model):
        if int(model.hparams.get("latent_dim", 0)) != 2 or not self.latents:
            return
        latents = np.concatenate(self.latents)
        labels = np.concatenate(self.labels)
        order = np.argsort(labels, kind="stable")
        img = make_scatter(latents[order, 0], latents[order, 1], c=labels[order],
                           xlim=(-3, 3), ylim=(-3, 3))
        trainer.logger.log_image("val/latent distributions", img, trainer.current_epoch)
        self.latents, self.labels = [], []


def make_scatter(x, y, c=None, s=None, xlim=None, ylim=None) -> np.ndarray:
    """A matplotlib scatter (Agg) as an (H, W, 3) float image in [0, 1]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image
    fig = plt.figure()
    plt.scatter(x=x, y=y, s=s, c=c, cmap="tab10", alpha=1)
    if xlim:
        plt.xlim(xlim)
    if ylim:
        plt.ylim(ylim)
    plt.title("Latent distribution")
    buf = io.BytesIO()
    plt.savefig(buf, format="jpeg")
    plt.close(fig)
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32) / 255.0
