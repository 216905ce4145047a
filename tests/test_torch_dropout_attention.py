"""The port's dropout flash attention (igm_tpu_torch.ops.dropout_attention,
ops.causal_attention) against igm_tpu's, on the CPU.

The hash and the mask bit for bit against ``_hash_bits`` and
``reference_probs_dropout_mask``, a wrapping seed included; the plain
forward at rate 0 and 0.1 and its autograd gradients against the Pallas
kernel in interpret mode (B=2, S=200, H=2, D=64, as
``tests/test_dropout_flash.py``), and at the tile edges S = 63, 65 and 129
(B=1, H=2) where the card tests compare the kernels with the plain
versions; ``hash_dropout_attention`` against
``hash_dropout_attention_fn`` with the seed it draws.  Tolerances: float32
summed in other orders, 1e-5 for the forward and ``2e-5 * max(|ref|, 1)``
for the gradients.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.ops.causal_attention import hash_dropout_attention_fn  # noqa: E402
from igm_tpu.ops.pallas_dropout_attention import (  # noqa: E402
    _hash_bits, _vjp_fwd as jax_vjp_fwd, flash_causal_attention_dropout as jax_flash,
    reference_probs_dropout_mask as jax_mask)
from igm_tpu_torch.ops import dropout_attention as da  # noqa: E402
from igm_tpu_torch.ops.causal_attention import (  # noqa: E402
    causal_mask, dropout_flash_attention, hash_dropout_attention)

torch.set_num_threads(1)

B, S, H, D = 2, 200, 2, 64
WRAP = 2 ** 32 - 3                      # seed + b*H + h wraps past 2**32


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("seed", [0, 123, WRAP])
def test_hash_bits_match_bit_for_bit(seed):
    rng = np.random.default_rng(seed % 1000)
    qi = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    kj = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(_hash_bits(jnp.uint32(seed), jnp.asarray(qi), jnp.asarray(kj)))
    got = da.hash_bits(seed, torch.from_numpy(qi.astype(np.int64)),
                       torch.from_numpy(kj.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [7, WRAP])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_matches_reference(seed, rate):
    with np.errstate(over="ignore"):
        want = jax_mask(np.uint32(seed), 2, 3, 40, rate)
    got = da.dropout_scale(seed, 0, 6, 40, 40, rate).numpy().reshape(2, 3, 40, 40)
    np.testing.assert_array_equal(got, want)
    assert da.threshold(rate) == min(int(rate * 2 ** 32), 2 ** 32 - 1)
    assert abs((want == 0).mean() - rate) < 0.02


def _jax_loss(q, k, v, seed, rate):
    return (jax_flash(q, k, v, jnp.asarray(seed, jnp.uint32), rate, None, True) ** 2).sum()


def _check_against_pallas_interpret(qkv, seed, rate):
    """The plain forward and its autograd gradients against the Pallas
    kernel in interpret mode, on the same (B, S, H, D) float32 inputs."""
    jq, jk, jv = (jnp.asarray(x) for x in qkv)
    want = np.asarray(jax_flash(jq, jk, jv, jnp.asarray(seed, jnp.uint32), rate, None, True))
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in qkv]
    out = da.flash_causal_attention_dropout(*leaves, seed, rate)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    (out ** 2).sum().backward()
    grads = jax.grad(_jax_loss, argnums=(0, 1, 2))(jq, jk, jv, seed, rate)
    for name, leaf, g in zip("qkv", leaves, grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g,
                                   atol=2e-5 * max(np.abs(g).max(), 1.0),
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("seed", [123, WRAP])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_and_gradients_match_pallas_interpret(qkv, rate, seed):
    _check_against_pallas_interpret(qkv, seed, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s", [63, 65, 129])
def test_plain_versions_match_pallas_interpret_at_tile_edges(s, rate):
    """The lengths the card tests hold the kernels to their plain versions
    at (one short of a 64-row tile, one past, one past two): the plain
    forward and its gradients against the Pallas kernel in interpret mode,
    B=1, H=2, D=64, at the tolerances above."""
    rng = np.random.default_rng(s)
    _check_against_pallas_interpret(
        [rng.normal(size=(1, s, 2, D)).astype(np.float32) for _ in range(3)], 123, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_forward_matches_pallas_interpret_at_tar_length(rate):
    """TAR's S = 785 (13 tiles of 64 rows, the last ragged; two 512-row
    Pallas blocks, the last padded), B=1, H=1: the plain forward and its lse
    against the Pallas kernel in interpret mode, at the forward's 1e-5."""
    rng = np.random.default_rng(785)
    q, k, v = (rng.normal(size=(1, 785, 1, D)).astype(np.float32) for _ in range(3))
    want, res = jax_vjp_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                            jnp.asarray(WRAP, jnp.uint32), rate, None, True)
    want_lse = np.asarray(res[-1])[:, :785, 0]
    o, lse = da.dropout_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), WRAP, rate)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)


def test_forward_returns_lse_and_rate_zero_needs_no_seed(qkv):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    o, lse = da.dropout_attention_fwd(q, k, v, seed=0, rate=0.0)
    assert o.shape == q.shape and lse.shape == (B * H, S) and lse.dtype == torch.float32
    # the last row of head (0, 0) sees every key: lse is its logsumexp
    s = (q[0, -1, 0] @ k[0, :, 0].T) / D ** 0.5
    torch.testing.assert_close(lse[0, -1], torch.logsumexp(s, 0), atol=1e-5, rtol=1e-5)
    o2, _ = da.dropout_attention_fwd(q, k, v, seed=torch.tensor(99), rate=0.0)
    assert torch.equal(o, o2)
    torch.testing.assert_close(dropout_flash_attention(q, k, v, seed=5, rate=0.1,
                                                       deterministic=True), o)


def test_bf16_rounds_the_probabilities_before_the_product(qkv):
    """bfloat16: p * scale is cast to v's dtype before p @ v; the plain
    version agrees with a float32 run to bf16 precision."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in qkv)
    o, _ = da.dropout_attention_fwd(q, k, v, seed=3, rate=0.1)
    o32, _ = da.dropout_attention_fwd(q.float(), k.float(), v.float(), seed=3, rate=0.1)
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o32, atol=2e-2, rtol=2 ** -6)


def test_hash_dropout_attention_matches_igm_tpu(qkv):
    rng = jax.random.PRNGKey(4)
    jq, jk, jv = (jnp.asarray(x) for x in qkv)
    mask = jnp.tril(jnp.ones((S, S), bool))
    want = np.asarray(hash_dropout_attention_fn(jq, jk, jv, mask=mask, dropout_rng=rng,
                                                dropout_rate=0.1, deterministic=False))
    seed = int(jax.random.bits(rng, dtype=jnp.uint32))
    q, k, v = (torch.from_numpy(x) for x in qkv)
    got = hash_dropout_attention(q, k, v, causal_mask(S, "cpu"), seed=seed, rate=0.1,
                                 deterministic=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the same seed through the kernels' plain versions: the same attention
    flash = dropout_flash_attention(q, k, v, seed=seed, rate=0.1, deterministic=False)
    np.testing.assert_allclose(flash.numpy(), want, atol=1e-5)
    evals = hash_dropout_attention(q, k, v, causal_mask(S, "cpu"))
    want_eval = np.asarray(hash_dropout_attention_fn(jq, jk, jv, mask=mask))
    np.testing.assert_allclose(evals.numpy(), want_eval, atol=1e-5)
