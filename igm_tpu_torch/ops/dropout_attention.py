"""Causal flash attention with in-kernel attention-probs dropout: the CUDA
kernels' wrappers, their plain versions and the autograd Function that joins
them.

Counterpart of ``igm_tpu/ops/pallas_dropout_attention.py``: the forward
(``_call_fwd`` / ``_fwd_kernel``), the dq kernel (``_dq_kernel``) and the
dk/dv kernel (``_dkv_kernel``) of a causal online-softmax attention whose
normalised probabilities are dropped by a counter hash of (seed, global query
index, global key index).  The mask is never stored: the backward
regenerates it from the same seed.  q, k, v are (B, S, H, D) at every public
function (the Flax layout); the kernels read that layout directly.  They are
in ``igm_tpu_torch/csrc/dropout_attention.cu`` and take D = 64.

The semantics, as the Pallas kernels have them:

- the per-(b, h) seed is ``seed + (b*H + h)`` mod 2**32, as
  ``program_id(0)`` adds it; a position is kept where
  ``hash_bits(seed, q, k) >= min(int(rate * 2**32), 2**32 - 1)`` and then
  scaled by ``1/keep``, taken in float64 and rounded once to float32;
- the row sum ``l`` takes the undropped probabilities; the p @ v product
  takes ``p * scale`` cast to v's dtype; the forward returns the output and
  the per-row ``lse = m + log(l)`` in float32;
- the backward takes ``delta = rowsum(do * o)`` in float32 from the output
  in its own dtype, scales ``g = do @ v^T`` by the mask and forms
  ``ds = p * (g - delta)``; ``ds`` and ``p * scale`` are cast to the
  operand dtype before their products;
- rate 0 skips the hash.

:func:`dropout_attention_fwd`, :func:`dropout_attention_dq` and
:func:`dropout_attention_dkv` launch their kernel for CUDA tensors and raise
if they cannot; CPU tensors take the plain versions.  Each has a
``launches`` attribute that counts kernel launches.  A seed is an integer or
an int64 tensor holding one value in [0, 2**32); on the card the kernels
read it from device memory, so a seed drawn on the card costs no host sync.
The bf16 forward, dq and dk/dv kernels run their products on the tensor
cores and copy rows with 16-byte ``cp.async``: their bf16 q, k, v and do
must start on a 16-byte boundary (every fresh allocation does); a view at
another offset raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import numpy as np
import torch

from . import _build

HEAD_DIM = 64
NEG_INF = -1e30                 # the Pallas kernels' mask value
_M32 = 0xFFFFFFFF
# plain versions: at most this many (q, k) scores per b*h chunk (64 MB in f32)
_CHUNK_ELEMENTS = 2 ** 24

Seed = Union[int, torch.Tensor]


# ----------------------------------------------------------------- the hash
def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) (int64 tensor or int) and a
    32-bit constant c, in two 16-bit halves so that no int64 overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_bits(seed, qi, kj):
    """The kernels' counter hash (``pallas_dropout_attention.py:57-65``
    ``_hash_bits``), bit for bit, on int64 tensors or ints holding uint32
    values: murmur3-style finalizer mixing of (seed, q index, k index)."""
    h = _mul32(qi, 0x9E3779B1) ^ _mul32(kj, 0x85EBCA77) ^ seed
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def threshold(rate: float) -> int:
    """Bits at or above this are kept (``pallas_dropout_attention.py:74``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_scale(rate: float) -> float:
    """1/keep in float64, rounded once to float32 (returned as the Python
    float of that float32 value)."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return rate


def _seed_value(seed: Seed, device: torch.device) -> torch.Tensor:
    """The seed as an int64 scalar tensor on ``device``, reduced mod 2**32."""
    return torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(()) & _M32


def keep_mask(seed: Seed, bh0: int, n_bh: int, s_q: int, s_k: int,
              rate: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_bh, s_q, s_k) bool, True where the hash keeps (q, k) of the b*h
    slices ``bh0 .. bh0 + n_bh - 1``, from global q and k indices."""
    device = torch.device(device)
    sd = _seed_value(seed, device)
    bh = torch.arange(bh0, bh0 + n_bh, device=device, dtype=torch.int64)
    seeds = ((sd + bh) & _M32).reshape(n_bh, 1, 1)
    qi = torch.arange(s_q, device=device, dtype=torch.int64).reshape(1, s_q, 1)
    kj = torch.arange(s_k, device=device, dtype=torch.int64).reshape(1, 1, s_k)
    return hash_bits(seeds, qi, kj) >= threshold(rate)


def dropout_scale(seed: Seed, bh0: int, n_bh: int, s_q: int, s_k: int,
                  rate: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_bh, s_q, s_k) float32 factors ``mask / keep``: ``keep_scale`` where
    :func:`keep_mask` keeps, else 0."""
    keep = keep_mask(seed, bh0, n_bh, s_q, s_k, rate, device)
    return torch.where(keep, torch.tensor(keep_scale(rate), device=keep.device),
                       torch.tensor(0.0, device=keep.device))


# ---------------------------------------------------------- plain versions
def resolve_scale(d: int, sm_scale: Optional[float]) -> float:
    return (1.0 / (d ** 0.5)) if sm_scale is None else float(sm_scale)


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D) float32."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)


def _bshd(x: torch.Tensor, b: int, h: int, dtype: torch.dtype) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D) contiguous in ``dtype``."""
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).to(dtype).contiguous()


def bh_chunks(bh: int, s: int):
    """(first, count) b*h slices of at most ``_CHUNK_ELEMENTS`` (s, s) scores."""
    n = max(1, _CHUNK_ELEMENTS // max(s * s, 1))
    for c0 in range(0, bh, n):
        yield c0, min(n, bh - c0)


def _scores(qf, kf, c0, n, scale, causal):
    s = torch.bmm(qf[c0:c0 + n], kf[c0:c0 + n].transpose(1, 2)) * scale
    return s.masked_fill_(~causal, NEG_INF)


def dropout_attention_fwd_plain(q, k, v, seed: Seed, rate: float,
                                sm_scale: Optional[float] = None):
    """Plain PyTorch version of the forward kernel, any device: (o in q's
    dtype, (B, S, H, D); lse float32, (B*H, S))."""
    b, s, h, d = q.shape
    scale = resolve_scale(d, sm_scale)
    rate = _check_rate(rate)
    qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    o = torch.empty_like(qf)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    for c0, n in bh_chunks(b * h, s):
        sc = _scores(qf, kf, c0, n, scale, causal)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            p = p * dropout_scale(seed, c0, n, s, s, rate, device=q.device)
        p = p.to(v.dtype).float()
        o[c0:c0 + n] = torch.bmm(p, vf[c0:c0 + n]) / l
        lse[c0:c0 + n] = (m + torch.log(l))[..., 0]
    return _bshd(o, b, h, q.dtype), lse


def _grads_chunk(qf, kf, vf, dof, lse, delta, c0, n, seed, rate, scale, causal):
    """p, the mask factor (None at rate 0) and ds of one b*h chunk."""
    sc = _scores(qf, kf, c0, n, scale, causal)
    p = torch.exp(sc - lse[c0:c0 + n, :, None])
    g = torch.bmm(dof[c0:c0 + n], vf[c0:c0 + n].transpose(1, 2))
    factor = None
    if rate > 0.0:
        factor = dropout_scale(seed, c0, n, sc.shape[1], sc.shape[2], rate,
                               device=qf.device)
        g = g * factor
    ds = p * (g - delta[c0:c0 + n, :, None])
    return p, factor, ds


def dropout_attention_dq_plain(q, k, v, do, lse, delta, seed: Seed, rate: float,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch version of the dq kernel: (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    scale = resolve_scale(d, sm_scale)
    rate = _check_rate(rate)
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    dq = torch.empty_like(qf)
    for c0, n in bh_chunks(b * h, s):
        _, _, ds = _grads_chunk(qf, kf, vf, dof, lse, delta, c0, n, seed, rate,
                                scale, causal)
        dq[c0:c0 + n] = torch.bmm(ds.to(k.dtype).float(), kf[c0:c0 + n]) * scale
    return _bshd(dq, b, h, q.dtype)


def dropout_attention_dkv_plain(q, k, v, do, lse, delta, seed: Seed, rate: float,
                                sm_scale: Optional[float] = None):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv), (B, S, H, D) in
    k's and v's dtypes."""
    b, s, h, d = q.shape
    scale = resolve_scale(d, sm_scale)
    rate = _check_rate(rate)
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for c0, n in bh_chunks(b * h, s):
        p, factor, ds = _grads_chunk(qf, kf, vf, dof, lse, delta, c0, n, seed,
                                     rate, scale, causal)
        pt = p if factor is None else p * factor
        dv[c0:c0 + n] = torch.bmm(pt.to(do.dtype).float().transpose(1, 2),
                                  dof[c0:c0 + n])
        dk[c0:c0 + n] = torch.bmm(ds.to(q.dtype).float().transpose(1, 2),
                                  qf[c0:c0 + n]) * scale
    return _bshd(dk, b, h, k.dtype), _bshd(dv, b, h, v.dtype)


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in float32, (B*H, S), from the output as the forward
    returned it (``_vjp_bwd``, ``pallas_dropout_attention.py:283-284``)."""
    b, s, h, _ = o.shape
    delta = (do.float() * o.float()).sum(dim=-1)            # (B, S, H)
    return delta.permute(0, 2, 1).reshape(b * h, s).contiguous()


# ---------------------------------------------------------------- wrappers
@functools.cache
def _kernels(name: str, pointers: int) -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("dropout_attention")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def _check(name: str, *tensors: torch.Tensor) -> None:
    """Shape checks on every device: q, k, v (and do) share one (B, S, H, D)."""
    shape = tensors[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: q, k, v must share one (B, S, H, D) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What the kernels take: head dim 64, one dtype (f32/bf16), contiguous,
    on the current CUDA device, B*H at most 65535; in bf16 (the kernels copy
    rows with 16-byte ``cp.async``), tensors that start on a 16-byte
    boundary."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: unsupported dtypes {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {q.device} is not the current device")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds 65535")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 inputs must start on a 16-byte boundary, got "
                         f"addresses {[t.data_ptr() % 16 for t in tensors]} mod 16")


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and delta: float32, (B*H, S), contiguous, on q's device."""
    b, s, h, _ = q.shape
    for t in rows:
        if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, s)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: lse and delta must be float32 ({b * h}, {s}) "
                             f"contiguous on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _seed_arg(seed: Seed, rate: float, device: torch.device):
    """The seed's device tensor (kept alive by the caller) and its pointer;
    none at rate 0, where the kernels never read it."""
    if rate == 0.0:
        return None, None
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.device != device:
            raise ValueError(f"seed must be one value on {device}, got "
                             f"{tuple(seed.shape)} on {seed.device}")
        t = seed.reshape(1)
        if t.dtype != torch.int64:
            t = t.to(torch.int64)
    else:
        if torch.cuda.is_current_stream_capturing():
            # a host seed would be baked into the graph, the same at every replay
            raise ValueError("a seed inside a CUDA graph capture must be a device tensor")
        t = torch.tensor([int(seed) & _M32], dtype=torch.int64, device=device)
    t = t.contiguous()
    return t, t.data_ptr()


def _tail(rate: float, scale: float) -> tuple:
    """sm_scale, threshold, keep scale, dropout flag."""
    if rate == 0.0:
        return scale, 0, 1.0, 0
    return scale, threshold(rate), keep_scale(rate), 1


def dropout_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seed: Seed, rate: float, sm_scale: Optional[float] = None):
    """q, k, v: (B, S, H, D) -> (o (B, S, H, D) in q's dtype, lse (B*H, S)
    float32)."""
    _check("dropout_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return dropout_attention_fwd_plain(q, k, v, seed, rate, sm_scale)
    _check_cuda("dropout_attention_fwd", q, k, v)
    rate = _check_rate(rate)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    seed_t, seed_ptr = _seed_arg(seed, rate, q.device)
    err = _kernels("igm_dropout_attention_fwd", 6)[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seed_ptr, o.data_ptr(),
        lse.data_ptr(), b, s, h, *_tail(rate, resolve_scale(d, sm_scale)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention_fwd kernel launch failed: CUDA error {err}")
    dropout_attention_fwd.launches += 1
    del seed_t
    return o, lse


dropout_attention_fwd.launches = 0


def dropout_attention_dq(q, k, v, do, lse, delta, seed: Seed, rate: float,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """dq (B, S, H, D) in q's dtype, for the output gradient ``do`` and the
    forward's ``lse`` and ``delta = rowsum(do * o)`` ((B*H, S) float32)."""
    _check("dropout_attention_dq", q, k, v, do)
    if q.device.type == "cpu":
        return dropout_attention_dq_plain(q, k, v, do, lse, delta, seed, rate, sm_scale)
    _check_cuda("dropout_attention_dq", q, k, v, do)
    _check_rows("dropout_attention_dq", q, lse, delta)
    rate = _check_rate(rate)
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    seed_t, seed_ptr = _seed_arg(seed, rate, q.device)
    err = _kernels("igm_dropout_attention_dq", 8)[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), seed_ptr, dq.data_ptr(), b, s, h,
        *_tail(rate, resolve_scale(d, sm_scale)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention_dq kernel launch failed: CUDA error {err}")
    dropout_attention_dq.launches += 1
    del seed_t
    return dq


dropout_attention_dq.launches = 0


def dropout_attention_dkv(q, k, v, do, lse, delta, seed: Seed, rate: float,
                          sm_scale: Optional[float] = None):
    """(dk, dv), (B, S, H, D) in k's and v's dtypes; arguments as
    :func:`dropout_attention_dq`."""
    _check("dropout_attention_dkv", q, k, v, do)
    if q.device.type == "cpu":
        return dropout_attention_dkv_plain(q, k, v, do, lse, delta, seed, rate, sm_scale)
    _check_cuda("dropout_attention_dkv", q, k, v, do)
    _check_rows("dropout_attention_dkv", q, lse, delta)
    rate = _check_rate(rate)
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    seed_t, seed_ptr = _seed_arg(seed, rate, q.device)
    err = _kernels("igm_dropout_attention_dkv", 9)[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), seed_ptr, dk.data_ptr(), dv.data_ptr(), b, s, h,
        *_tail(rate, resolve_scale(d, sm_scale)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_attention_dkv kernel launch failed: CUDA error {err}")
    dropout_attention_dkv.launches += 1
    del seed_t
    return dk, dv


dropout_attention_dkv.launches = 0


class DropoutAttentionFn(torch.autograd.Function):
    """The forward kernel joined with the dq and dk/dv kernels, the
    counterpart of ``jax.custom_vjp`` ``flash_causal_attention_dropout``.
    ``apply(q, k, v, seed, rate, sm_scale)``; saves q, k, v, the seed, the
    output and lse, and regenerates the mask in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, sm_scale):
        o, lse = dropout_attention_fwd(q, k, v, seed, rate, sm_scale)
        ctx.rate, ctx.sm_scale = rate, sm_scale
        ctx.seed = seed if not isinstance(seed, torch.Tensor) else None
        saved = (q, k, v, o, lse) + ((seed,) if isinstance(seed, torch.Tensor) else ())
        ctx.save_for_backward(*saved)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, *rest = ctx.saved_tensors
        seed = rest[0] if rest else ctx.seed
        # autograd may hand over a strided or differently typed gradient
        do = do.to(q.dtype).contiguous()
        delta = attention_delta(do, o)
        dq = dropout_attention_dq(q, k, v, do, lse, delta, seed, ctx.rate, ctx.sm_scale)
        dk, dv = dropout_attention_dkv(q, k, v, do, lse, delta, seed, ctx.rate,
                                       ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_causal_attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   seed: Seed, rate: float = 0.0,
                                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, S, H, D); seed: an int or int64 tensor (one uint32
    value).  Returns (B, S, H, D): causal attention with the probabilities
    dropped at ``rate`` (0 is exact causal attention).  Counterpart of
    ``pallas_dropout_attention.py:248``."""
    return DropoutAttentionFn.apply(q, k, v, seed, _check_rate(rate), sm_scale)
