"""The FID evaluation callback: counterpart of
``igm_tpu/callbacks/evaluation.py``.

Real and fake validation images go into Gaussian feature statistics; at the
end of the validation epoch the Frechet distance is logged through
``trainer.log``: ``metrics/fid`` with Inception features, else
``metrics/fid_<backend>`` (the port's random net: ``metrics/fid_random_torch``).
RGB models only, as there.  The images are converted to uint8 and their
features computed on the model's device.
"""
from __future__ import annotations

import torch

from ..utils.utils import get_logger
from .fid import FeatureStats, _on_device, frechet_distance, get_feature_backend

log = get_logger(__name__)


def to_uint8(imgs, normalized: bool, device) -> torch.Tensor:
    """``igm_tpu``'s ``_to_uint8`` on ``device``, the same float32
    operations: ((x + 1) / 2 when normalized), clipped to [0, 1], times
    255, truncated to uint8."""
    x = _on_device(imgs, device).float()
    if normalized:
        x = (x + 1.0) / 2.0
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


class FIDEvaluationCallback:
    def __init__(self, every_n_epochs: int = 1, backend: str | None = None):
        self.every_n_epochs = every_n_epochs
        self.backend = backend
        self._real = None
        self._fake = None
        self._warned = False

    def _active(self, trainer, model) -> bool:
        return model.channels == 3 and trainer.current_epoch % self.every_n_epochs == 0

    def _features(self, imgs, model):
        return self._fe(to_uint8(imgs, model.input_normalize, model.device))

    def on_validation_epoch_start(self, trainer, model):
        if not self._active(trainer, model):
            self._real = self._fake = None
            return
        fe, dim, name = get_feature_backend(self.backend, model.device)
        if name != "inception" and not self._warned:
            log.warning("FID running with the %r feature backend (no Inception weights; "
                        "set IGM_INCEPTION_WEIGHTS): logging metrics/fid_%s, not "
                        "metrics/fid", name, name)
            self._warned = True
        self._fe, self._backend_name = fe, name
        self._real, self._fake = FeatureStats(dim), FeatureStats(dim)

    def on_validation_batch_end(self, trainer, model, outputs, batch, batch_idx):
        if self._real is None:
            return
        if outputs.real_image is not None:
            self._real.update(self._features(outputs.real_image, model))
        if outputs.fake_image is not None:
            self._fake.update(self._features(outputs.fake_image, model))

    def on_validation_epoch_end(self, trainer, model):
        if self._real is None or self._real.n == 0 or self._fake.n == 0:
            return
        fid = frechet_distance(*self._real.finalize(), *self._fake.finalize())
        tag = ("metrics/fid" if self._backend_name == "inception"
               else f"metrics/fid_{self._backend_name}")
        trainer.log(tag, fid)
        self._real = self._fake = None
