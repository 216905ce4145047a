"""Flax param trees -> torch ``state_dict``s.

Input: the leaves of an ``igm_tpu`` param tree as numpy arrays, keyed by
their ``/``-joined path: the ``denoise`` tree alone
(``ResnetBlock_0/Block_0/Conv_0/Conv_0/kernel``) maps onto the UNet's
``state_dict``, a whole model's tree (``denoise/...``, ``encoder/...``,
``decoder/...``, ``vq/embedding``) onto the model's ``modules``.  The port's
modules carry Flax's names, so a path maps onto a ``state_dict`` key by
dropping the inner ``<Type>_0`` that ``igm_tpu``'s Conv / Dense /
ConvTranspose wrappers (and the wslice qkv ``QKVKernel``) put around the
Flax layer, and renaming ``kernel`` to ``weight``.  Mutable collections map
onto buffers (:func:`flax_mutables_to_torch`).  Layouts:

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
- Attention (Flax's DenseGeneral, ``MultiHeadDotProductAttention_*``):
  ``query``/``key``/``value`` kernels (d, H, D) -> (H*D, d) and biases
  (H, D) -> (H*D,); the ``out`` kernel (H, D, d) -> (d, H*D).
- GroupNorm ``scale``/``bias``, ChannelLayerNorm ``g``/``b``, LayerNorm
  ``scale``/``bias``, ``Embed_*/embedding``, the class ``embedding`` and
  TAR's ``h_pe``/``w_pe``/``first_pe`` carry over as they are.
- The DiT (``igm_tpu/networks/dit.py``): plain Flax ``Dense`` layers (no
  wrapper level to drop), whatever the tree (``denoise/...``,
  ``velocity/...``).  Its Switch-MoE leaves ``w_up``, ``b_up``, ``w_dn``,
  ``b_dn`` are not kernels and carry over as they are; the router kernel is
  a Dense kernel.  ``nn.remat`` names a block ``CheckpointDiTBlock_<i>``:
  the prefix is dropped, so a remat tree maps onto the same modules.
  ``block_mode="scan"`` stacks the blocks into one ``blocks/<leaf>`` tree
  of ``(depth, ...)`` leaves: each is split along axis 0 onto
  ``DiTBlock_<i>/<leaf>``.
- MADE (``igm_tpu/models/made.py``): the port keeps its kernels in Flax's
  ``(in, out)`` layout (the stochastic rounding's counter is the element's
  index there), so ``[net/]layers_<i>/kernel`` and ``[net/]out_layer/kernel``
  carry over untransposed; the bfloat16 output kernel loads into the
  bfloat16 parameter (``load_state_dict`` casts, exactly).
- PixelCNN (``igm_tpu/models/pixelcnn.py``): its ``MaskedConv`` and
  ``Pointwise`` kernels are HWIO conv kernels with no wrapper level:
  ``conv_layers_<i>/vert_conv/kernel`` -> ``conv_layers_<i>.vert_conv.weight``
  (OIHW), the unmasked kernel (the mask is applied in the forward).
- RealNVP (``igm_tpu/models/realnvp.py``): ``Conv_0``/``Conv_1`` are the
  wrapped ``Conv`` (``net/Conv_0/Conv_0/kernel`` -> ``net.Conv_0.weight``),
  ``Conv_2`` a bare Flax ``nn.Conv`` (``net/Conv_2/kernel``), ``s_scale``
  as it is.
- The VAE/GAN zoo (``igm_tpu/networks/{basic,conv32,conv64}.py``):
  ``Norm``'s Flax ``BatchNorm`` and ``GroupNorm`` (one group) keep their
  level (``Norm_1/BatchNorm_0/scale`` -> ``Norm_1.BatchNorm_0.scale``);
  ``scale`` and ``bias`` carry over as they are.  Their ``batch_stats``
  collection (``encoder/batch_stats/Norm_1/BatchNorm_0/{mean,var}``) maps
  onto the ``mean`` and ``var`` buffers (:func:`flax_mutables_to_torch`).
  The adversarial zoo's trees map by the same rules: BiGAN's
  ``discriminator/MLPEncoder_0/...``, ``Encoder_0/...`` (its sub-networks
  under Flax's automatic names, which the port's ``Discriminator`` takes),
  InfoGAN's heads ``netD/Dense_0/Dense_0/kernel`` and ``netQ/Dense_1/...``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_WRAPPED = ("Conv", "Dense", "ConvTranspose")


def _kind(name: str) -> str:
    return name.rsplit("_", 1)[0]


def flax_key_to_torch(path: str) -> str:
    parts = [p[len("Checkpoint"):] if p.startswith("Checkpoint") else p
             for p in path.split("/")]
    if (len(parts) >= 3 and _kind(parts[-3]) in _WRAPPED
            and parts[-2] == f"{_kind(parts[-3])}_0"):
        del parts[-2]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


_QKV = ("query", "key", "value")
# MADE's kernels, kept in Flax's (in, out) layout by the port
_FLAX_LAYOUT = re.compile(r"^(net/)?(layers_\d+|out_layer)/kernel$")


def _convert(path: str, value: np.ndarray) -> np.ndarray:
    parent = path.split("/")[-2] if "/" in path else ""
    if path.endswith("/bias") and parent in _QKV:     # DenseGeneral (H, D)
        return value.reshape(-1)
    if not path.endswith("/kernel"):
        return value
    if value.ndim == 2:                               # Dense
        return value if _FLAX_LAYOUT.match(path) else value.T
    if value.ndim == 3 and parent in _QKV:            # (d, H, D) -> (H*D, d)
        return value.reshape(value.shape[0], -1).T
    if value.ndim == 3 and parent == "out":           # (H, D, d) -> (d, H*D)
        return value.reshape(-1, value.shape[-1]).T
    if value.ndim != 4:
        raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")
    parts = path.split("/")
    if len(parts) >= 3 and parts[-3].startswith("ConvTranspose_"):
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # (in, out, kh, kw)
    return value.transpose(3, 2, 0, 1)                # HWIO -> OIHW


def unstack_blocks(params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The DiT's scan layout split per block: ``.../blocks/<leaf>`` of shape
    ``(depth, ...)`` -> ``.../DiTBlock_<i>/<leaf>`` for i < depth; other
    leaves as they are."""
    out = {}
    for path, value in params.items():
        parts = path.split("/")
        if "blocks" not in parts[:-1]:
            out[path] = value
            continue
        at = parts.index("blocks")
        for i in range(value.shape[0]):
            out["/".join(parts[:at] + [f"DiTBlock_{i}"] + parts[at + 1:])] = value[i]
    return out


def flax_to_torch(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``{'/'-joined Flax path: array}`` -> ``state_dict`` of the port's
    module with that tree (the ``Unet`` or the ``DiT``, or a model's
    ``modules`` for a whole-model tree), float32 CPU tensors."""
    out = {}
    for path, value in unstack_blocks(params).items():
        arr = _convert(path, np.asarray(value, np.float32))
        out[flax_key_to_torch(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def flax_mutables_to_torch(mutables: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``igm_tpu`` mutable collections by ``/``-joined path -> the buffers of
    the port's ``modules``: the EMA ``codebook`` collection
    (``vq/codebook/{embedding,cluster_size,cluster_sum}``) onto ``vq``'s
    buffers, ``latent/scale`` onto the latent scale, and a ``batch_stats``
    collection (a whole model's, ``encoder/batch_stats/...``, or a
    network's, ``batch_stats/...``) onto the BatchNorms' ``mean`` and
    ``var``."""
    out = {}
    for path, value in mutables.items():
        parts = [p for p in path.split("/") if p != "batch_stats"]
        if len(parts) == 3 and parts[1] == "codebook":
            del parts[1]
        out[".".join(parts)] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out
