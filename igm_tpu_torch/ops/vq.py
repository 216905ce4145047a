"""Vector quantisation: the nearest-codebook kernel's wrapper and its plain
version.

Counterpart of ``igm_tpu/ops/vq.py`` (``nearest_codebook``, ``quantize``)
and of the Pallas kernel ``igm_tpu/ops/pallas_vq.py``
``nearest_codebook_pallas``: for each row of z (M, D) the index of the code
of the codebook (K, D) with the smallest ``||e||^2 - 2 z.e`` (the row's
``||z||^2`` is dropped), int32, ties to the lower index.  The kernel is in
``igm_tpu_torch/csrc/nearest_codebook.cu``.

:func:`nearest_codebook` launches the kernel for a CUDA tensor and raises if
it cannot; a CPU tensor takes the plain version.  It has a ``launches``
attribute that counts kernel launches.  The search has no gradient: both
inputs are detached, as ``igm_tpu`` stops their gradients.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# the largest D of the resident kernel: a CTA holds 128 rows of z and two
# tiles of 64 codes, (D rounded up to 8, + 4) floats a row, in shared
# memory; a larger D runs the kernel that stages 32 features at a time
RESIDENT_MAX_D = 216


def _e_sq(codebook: torch.Tensor) -> torch.Tensor:
    """||e_k||^2 per code in f32, as ``pallas_vq.py:45`` computes it outside
    its kernel."""
    e = codebook.float()
    return (e * e).sum(dim=1)


def nearest_codebook_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``igm_tpu``'s XLA branch,
    ``ops/vq.py:33-36``), any device: ``argmin(e_sq - 2 z @ e.T)``."""
    scores = _e_sq(codebook)[None, :] - 2.0 * (z.float() @ codebook.float().T)
    return scores.argmin(dim=1).to(torch.int32)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    fn = _build.library("nearest_codebook").igm_nearest_codebook_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nearest_codebook(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z: (M, D), codebook: (K, D) -> (M,) int32 index of each row's nearest
    code.  On the card both must be float32, contiguous, on the current
    device; any D (up to ``RESIDENT_MAX_D`` the resident kernel, beyond it
    the chunked one)."""
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"nearest_codebook expects z (M, D) and codebook (K, D), "
                         f"got {tuple(z.shape)} and {tuple(codebook.shape)}")
    if codebook.shape[0] == 0:
        raise ValueError("nearest_codebook: empty codebook")
    z, codebook = z.detach(), codebook.detach()
    if z.device.type == "cpu":
        return nearest_codebook_plain(z, codebook)
    if z.device.type != "cuda":
        raise ValueError(f"nearest_codebook: unsupported device {z.device}")
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_codebook: the kernel takes float32, got "
                        f"{z.dtype} and {codebook.dtype}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("nearest_codebook: inputs must be contiguous")
    if codebook.device != z.device:
        raise ValueError("nearest_codebook: inputs on different devices")
    if z.device.index != torch.cuda.current_device():
        raise ValueError(f"nearest_codebook: {z.device} is not the current device")
    m, d = z.shape
    idx = torch.empty(m, dtype=torch.int32, device=z.device)
    if m == 0 or d == 0:
        return idx.zero_()
    e_sq = _e_sq(codebook)
    err = _kernel()(z.data_ptr(), codebook.data_ptr(), e_sq.data_ptr(),
                    idx.data_ptr(), m, codebook.shape[0], d,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nearest_codebook kernel launch failed: CUDA error {err}")
    nearest_codebook.launches += 1
    return idx


nearest_codebook.launches = 0


def near_tie_gaps(z: torch.Tensor, codebook: torch.Tensor, got: torch.Tensor,
                  want: torch.Tensor, rtol: float = 1e-5) -> tuple[int, float, float]:
    """How two nearest-code searches over the same inputs disagree: (rows
    that differ; the largest gap between the plain version's scores at the
    two indices relative to ``rtol * (||e||^2 + 2 ||z|| ||e||)``, the size of
    the terms that are rounded, with the larger ||e|| of the two codes; that
    largest gap in score units).  A relative gap of at most 1 is a near-tie,
    where summing in another order may pick either code; both gaps are 0.0
    when no row differs."""
    rows = (got.long() != want.long()).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0.0, 0.0
    zr, e = z[rows].float(), codebook.float()
    e_sq = _e_sq(codebook)
    scores = e_sq[None, :] - 2.0 * (zr @ e.T)
    a, b = got[rows].long(), want[rows].long()
    s_a = scores.gather(1, a[:, None])[:, 0]
    s_b = scores.gather(1, b[:, None])[:, 0]
    e_norm = torch.maximum(e_sq[a], e_sq[b]).sqrt()
    scale = (rtol * (e_norm ** 2 + 2.0 * zr.norm(dim=1) * e_norm)).clamp(
        min=torch.finfo(torch.float32).tiny)
    gap = (s_a - s_b).abs()
    return rows.numel(), (gap / scale).max().item(), gap.max().item()


def quantize(z: torch.Tensor, codebook: torch.Tensor):
    """(codebook[idx], idx) for the rows of z (M, D).  The gather keeps the
    codebook's gradient, as ``igm_tpu``'s does.  It is an embedding lookup:
    on the card the backward of ``codebook[idx]`` (``index_put_`` with
    accumulation) took 3.4 ms of a VQ-VAE train step at batch 128, with 8192
    indices into 512 rows; the embedding backward sums the same rows."""
    idx = nearest_codebook(z, codebook)
    return torch.nn.functional.embedding(idx.long(), codebook), idx
