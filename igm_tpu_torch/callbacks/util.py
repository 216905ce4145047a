"""Misc callbacks: the port's copy of ``igm_tpu/callbacks/util.py``,
``ProgressBar`` (the ``tqdm`` callback of the configs) and ``GifCallback``."""
from __future__ import annotations

import logging
from pathlib import Path

log = logging.getLogger(__name__)


class ProgressBar:
    """One summary line per epoch (a per-batch bar would read the device's
    metrics, and so wait for it, on every refresh)."""

    def __init__(self, refresh_rate: int = 5, **_: object):
        self.refresh_rate = refresh_rate

    def on_train_epoch_end(self, trainer, model) -> None:
        metrics = {k: round(v, 4) for k, v in
                   list(trainer.callback_metrics.items())[:4]}
        log.info("[epoch %d/%d] step=%d %s", trainer.current_epoch + 1,
                 trainer.max_epochs, trainer.global_step, metrics)


class GifCallback:
    """At the end of training, ``results/<epoch>.jpg`` (the sample grids) in
    numeric order into ``video.gif`` at ``fps`` frames a second, both under
    the run directory (the CWD); nothing without frames.  PIL writes it."""

    def __init__(self, fps: int = 4):
        self.fps = fps

    def on_train_end(self, trainer, model) -> None:
        frames_dir = Path("results")
        if not frames_dir.exists():
            return
        frames = sorted(frames_dir.glob("*.jpg"),
                        key=lambda p: int(p.stem) if p.stem.isdigit() else 0)
        if not frames:
            return
        from PIL import Image
        imgs = [Image.open(f) for f in frames]
        imgs[0].save("video.gif", save_all=True, append_images=imgs[1:],
                     duration=int(1000 / self.fps), loop=0)
        log.info("wrote video.gif (%d frames)", len(imgs))
