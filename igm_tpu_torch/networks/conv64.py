"""64x64 DCGAN decoder and encoder, NHWC: counterpart of
``igm_tpu/networks/conv64.py`` (Flax's submodule names, as
``networks/basic.py``)."""
from __future__ import annotations

from . import conv32


class Decoder(conv32.Decoder):
    """latent -> 4x4 -> 8 -> 16 -> 32 -> 64."""

    LAYERS = ((8, 4, 1, 0), (4, 4, 2, 1), (2, 4, 2, 1), (1, 4, 2, 1))


class Encoder(conv32.Encoder):
    """64 -> 32 -> 16 -> 8 -> 4 -> 1x1 logits."""

    last_kernel = 4
