"""Data layer: the datamodules and the host input pipeline.

Own copies of ``igm_tpu/data``'s JAX-free parts (``base``, ``cifar10``,
``mnist``, ``celeba``, ``dsprite``, ``packaged``) and a torch prefetcher
(``loader``).  ``native`` (the C++ batcher) is not ported: the port's
loader is numpy.
"""
from .base import BaseDatamodule  # noqa: F401
from .cifar10 import CIFAR10DataModule  # noqa: F401
from .mnist import MNISTDataModule  # noqa: F401
