"""Flax param tree -> torch ``state_dict`` for the UNet denoiser.

Input: the leaves of ``igm_tpu``'s ``denoise`` param tree as numpy arrays,
keyed by their ``/``-joined path (``ResnetBlock_0/Block_0/Conv_0/Conv_0/kernel``).
The port's modules carry Flax's names, so a path maps onto a ``state_dict``
key by dropping the inner ``<Type>_0`` that ``igm_tpu``'s Conv / Dense /
ConvTranspose wrappers (and the wslice qkv ``QKVKernel``) put around the
Flax layer, and renaming ``kernel`` to ``weight``.  Layouts:

- Conv kernel: HWIO -> OIHW.
- Dense kernel: (in, out) -> (out, in).
- ConvTranspose kernel: ``igm_tpu`` runs ``lax.conv_transpose`` with
  padding ``k-1-p`` and an unflipped HWIO kernel K, i.e. a correlation of
  the stride-dilated input, padded by ``k-1-p``, with K.  torch's
  ``conv_transpose2d`` with weight W (in, out, k, k) is the same
  correlation with the kernel ``W'[o, i, a, b] = W[i, o, k-1-a, k-1-b]``.
  Setting W' = K (as OIHW) gives ``W[i, o, a, b] = K[k-1-a, k-1-b, i, o]``:
  flip both spatial axes, then move (i, o) to the front
  (``tests/test_torch_unet.py`` holds a standalone case against Flax).
- GroupNorm ``scale``/``bias``, ChannelLayerNorm ``g``/``b`` and the class
  ``embedding`` carry over as they are.
"""
from __future__ import annotations

import numpy as np
import torch

_WRAPPED = ("Conv", "Dense", "ConvTranspose")


def _kind(name: str) -> str:
    return name.rsplit("_", 1)[0]


def flax_key_to_torch(path: str) -> str:
    parts = path.split("/")
    if (len(parts) >= 3 and _kind(parts[-3]) in _WRAPPED
            and parts[-2] == f"{_kind(parts[-3])}_0"):
        del parts[-2]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _convert(path: str, value: np.ndarray) -> np.ndarray:
    if not path.endswith("/kernel"):
        return value
    if value.ndim == 2:                               # Dense
        return value.T
    if value.ndim != 4:
        raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")
    if path.split("/")[-3].startswith("ConvTranspose_"):
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # (in, out, kh, kw)
    return value.transpose(3, 2, 0, 1)                # HWIO -> OIHW


def flax_to_torch(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``{'/'-joined Flax path: array}`` -> ``state_dict`` of the port's
    ``Unet`` (float32 CPU tensors)."""
    out = {}
    for path, value in params.items():
        arr = _convert(path, np.asarray(value, np.float32))
        out[flax_key_to_torch(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out
