"""PyTorch/CUDA port of ``igm_tpu`` for one NVIDIA H100.

The JAX package ``igm_tpu`` stays beside it as the reference.  This package
imports nothing of it (nor of JAX): what it needs of the JAX-free modules it
keeps as its own copies.  Public functions take NHWC images, as in
``igm_tpu``.  Entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``); with no card and no such request they raise.
"""
from .utils.platform import resolve_device

__all__ = ["resolve_device"]
