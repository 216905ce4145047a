"""Data layer: the CIFAR-10 and MNIST datamodules and the host input pipeline.

Own copies of ``igm_tpu/data``'s JAX-free parts (``base``, ``cifar10``,
``mnist``) and a torch prefetcher (``loader``).  The other datamodules wait
for their slices.
"""
from .base import BaseDatamodule  # noqa: F401
from .cifar10 import CIFAR10DataModule  # noqa: F401
from .mnist import MNISTDataModule  # noqa: F401
