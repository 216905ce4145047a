"""The port's flat linear attention (igm_tpu_torch.ops.linear_attention)
against igm_tpu's XLA linear_attention_flat and its Pallas kernel in
interpret mode.

On the CPU the port's wrapper takes its plain version and counts no launch;
the CUDA kernel is held against the same plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from igm_tpu.ops.attention import linear_attention_flat as xla_flat  # noqa: E402
from igm_tpu.ops.pallas_attention import linear_attention_pallas  # noqa: E402
from igm_tpu_torch.ops.linear_attention import (  # noqa: E402
    _context, key_softmax, linear_attention_flat, linear_attention_flat_plain)

torch.set_num_threads(1)

HEADS, D = 4, 32
# float32; the softmax and the N-long context sums run in another order
# (and XLA's flat form adds exact zeros from the masked cross-head blocks)
ATOL = RTOL = 1e-5


def _qkv(seed, b, n):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, HEADS * D)).astype(np.float32)
                 for _ in range(3))


# the flagship's N = 64 and 256, and the ragged N = 100, 16 and 1 at which
# tests/test_torch_cuda.py holds the card's kernels to the plain version
NS = [64, 256, 100, 16, 1]


@pytest.mark.parametrize("n", NS)
def test_plain_matches_xla_flat(n):
    q, k, v = _qkv(n, 2, n)
    want = xla_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), HEADS)
    got = linear_attention_flat_plain(*map(torch.from_numpy, (q, k, v)), HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", NS)
def test_plain_matches_pallas_interpret(n):
    """The same function with heads split out, (B, N, H, D), against the
    Pallas kernel."""
    q, k, v = _qkv(n + 1, 2, n)
    split = [jnp.asarray(a.reshape(2, n, HEADS, D)) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(linear_attention_pallas(*split)).reshape(2, n, HEADS * D)
    got = linear_attention_flat_plain(*map(torch.from_numpy, (q, k, v)), HEADS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 64))
    before = linear_attention_flat.launches
    got = linear_attention_flat(q, k, v, HEADS)
    assert linear_attention_flat.launches == before
    torch.testing.assert_close(got, linear_attention_flat_plain(q, k, v, HEADS),
                               atol=0, rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = map(torch.from_numpy, _qkv(6, 2, 64))
    with pytest.raises(ValueError):
        linear_attention_flat(q, k[:, :32], v, HEADS)
    with pytest.raises(ValueError):
        linear_attention_flat(q[..., :126], k[..., :126], v[..., :126], HEADS)


def test_plain_bf16_rounds_context_before_readout():
    """As _flat_fwd does: the key softmax rounds as jax.nn.softmax rounds on
    bf16, the f32 context is cast to the input dtype before the read-out,
    which accumulates in f32 and rounds once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(7, 1, 64))
    got = linear_attention_flat_plain(q, k, v, HEADS)
    qf, vf = (t.float().reshape(1, 64, HEADS, D) for t in (q, v))
    k_sm = key_softmax(k.reshape(1, 64, HEADS, D))
    ctx = torch.einsum("bnhd,bnhe->bhde", k_sm, vf)
    ctx = ctx.to(torch.bfloat16).float()
    want = torch.einsum("bnhd,bhde->bnhe", qf, ctx).reshape(1, 64, HEADS * D)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    exp = torch.frexp(x.float().abs().clamp(min=2.0 ** -120)).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


# bfloat16 against igm_tpu: the same roundings (jax.nn.softmax's on bf16 keys,
# the context's, the output's), but exp and the f32 sums in another order
# can flip one rounding.  Each element may be off by one bf16 ulp of the
# output plus sum_d |q_d| ulp(ctx_de) (a flipped context entry), and at
# most 16 elements may differ at all (observed: 1 of 16,384 at N=64, 2 of
# 65,536 at N=256; before the softmax repair 10,447 of 16,384 differed).
BF16_MAX_OFF = 16


@pytest.mark.parametrize("n", NS)
def test_plain_bf16_matches_xla_flat(n):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(n, 2, n))
    want = xla_flat(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                    HEADS)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    got = linear_attention_flat_plain(q, k, v, HEADS).float()
    ctx_ulp = _bf16_ulp(_context(k, v, HEADS))                 # (B, H, D, D)
    q_abs = q.float().abs().reshape(2, n, HEADS, D)
    bound = (_bf16_ulp(want)
             + torch.einsum("bnhd,bhde->bnhe", q_abs, ctx_ulp).reshape(want.shape))
    off = got != want
    assert int(off.sum()) <= BF16_MAX_OFF
    assert bool(((got - want).abs() <= bound).all())
