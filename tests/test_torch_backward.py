"""The port's hand-written backwards against igm_tpu's, on the CPU.

GroupNorm+Mish: the plain backward (igm_tpu_torch.ops.groupnorm) against
``jax.grad`` through igm_tpu's Pallas kernel in interpret mode (its custom
VJP ``_gnm_bwd``) and against autodiff of ``reference_group_norm_mish``.
Linear attention: the plain backward against ``jax.vjp`` of igm_tpu's
``linear_attention_flat`` (its custom VJP ``_flat_bwd``), in f32 and bf16.
The autograd Functions on CPU tensors equal torch autograd of the plain
forwards.  The CUDA kernels are held against the same plain backwards on the
card (chip_smoke.py, tests/test_torch_cuda.py).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from igm_tpu.ops.attention import linear_attention_flat as xla_flat  # noqa: E402
from igm_tpu.ops.pallas_groupnorm import (  # noqa: E402
    _mish_grad, group_norm_mish as pallas_group_norm_mish, reference_group_norm_mish)
from igm_tpu_torch.networks.unet import Unet  # noqa: E402
from igm_tpu_torch.ops.groupnorm import (  # noqa: E402
    GroupNormMishFn, group_norm_mish_bwd, group_norm_mish_bwd_plain,
    group_norm_mish_plain)
from igm_tpu_torch.ops.linear_attention import (  # noqa: E402
    LinearAttentionFlatFn, linear_attention_flat_bwd,
    linear_attention_flat_bwd_plain, linear_attention_flat_plain)

torch.set_num_threads(1)

# float32 on both sides, the same formulas; sums over up to 2048 elements in
# another order
ATOL = RTOL = 1e-5
HEADS, D = 4, 32


def _gn_data(seed, n, h, w, c):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, h, w, c)).astype(np.float32)
    return x, gamma, beta, g


def _jax_gn_grads(fn, x, gamma, beta, g, groups):
    def loss(x, gamma, beta):
        return jnp.sum(fn(x, gamma, beta, groups) * g)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, gamma, beta)))


def _torch_gn_bwd(x, gamma, beta, g, groups):
    return group_norm_mish_bwd_plain(*map(torch.from_numpy, (x, gamma, beta, g)),
                                     groups)


def _assert_close(got, want, atol=ATOL, rtol=RTOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.float() if isinstance(a, torch.Tensor)
                                              else a, np.float32),
                                   np.asarray(b, np.float32), atol=atol, rtol=rtol)


GN_SHAPES = [(2, 8, 8, 32, 8), (3, 4, 4, 64, 8), (2, 4, 8, 16, 4)]


@pytest.mark.parametrize("n,h,w,c,groups", GN_SHAPES[:2])
def test_gn_bwd_plain_matches_pallas_interpret(n, h, w, c, groups):
    """jax.grad through the Pallas kernel runs _gnm_bwd, the Pallas backward."""
    x, gamma, beta, g = _gn_data(0, n, h, w, c)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_gn_grads(pallas_group_norm_mish, x, gamma, beta, g, groups)
    _assert_close(_torch_gn_bwd(x, gamma, beta, g, groups), want)


@pytest.mark.parametrize("n,h,w,c,groups", GN_SHAPES)
def test_gn_bwd_plain_matches_reference_autodiff(n, h, w, c, groups):
    x, gamma, beta, g = _gn_data(1, n, h, w, c)
    want = _jax_gn_grads(reference_group_norm_mish, x, gamma, beta, g, groups)
    _assert_close(_torch_gn_bwd(x, gamma, beta, g, groups), want)


def test_gn_function_matches_autograd_of_plain_forward():
    x, gamma, beta, g = (torch.from_numpy(a) for a in _gn_data(2, 2, 4, 4, 32))
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    GroupNormMishFn.apply(*leaves, 8).backward(g)
    ref = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    group_norm_mish_plain(*ref, 8).backward(g)
    _assert_close([t.grad for t in leaves], [t.grad for t in ref])


def test_closed_form_mish_grad_matches_reference():
    """The backward kernel's mish'(y) = n r + 4 y t (t + 1) r^2, with t =
    e^min(y, 20), n = t (t + 2) and r = 1 / (n + 2), as the kernel
    evaluates it (csrc/group_norm_mish.cu mish_grad_fast: from y2 = y log2(e),
    t = 2^min(y2, 20 log2(e)), mish' = r (n + 4 ln(2) y2 (n - t) r)), in f32
    torch against igm_tpu's _mish_grad in f32, on a
    grid over [-40, 40] with 0, -20, 20, the cap's neighbours and mish''s
    zero near -1.19.  Tolerance 4e-6 + 1e-6 |want|: XLA's f32 tanh is 1
    from softplus(y) of about 7.9 on, so the reference is 1 where mish'
    still exceeds 1 by up to 3.4e-6 (at y = 8); the closed form stays within
    2e-7 of a float64 evaluation.  On the card the kernel's ex2 and rcp
    (hardware approximations, about 2 and 1 ulp) add a few 1e-7 relative,
    well inside dx's f32 parity tolerance of 1e-5 + 1e-5 |dx|."""
    y = np.concatenate([np.linspace(-40.0, 40.0, 8001),
                        [0.0, -20.0, 20.0, np.nextafter(20.0, 0.0),
                         np.nextafter(20.0, 40.0), -1.19]]).astype(np.float32)
    log2e = np.float32(1.4426950408889634)
    yc2 = torch.clamp(torch.from_numpy(y) * log2e, max=float(np.float32(20.0) * log2e))
    t = torch.exp2(yc2)
    n = t * (t + 2.0)
    r = 1.0 / (n + 2.0)
    got = (r * (4.0 * np.float32(0.6931471805599453) * yc2 * (n - t) * r + n)).numpy()
    want = np.asarray(_mish_grad(jnp.asarray(y)))
    assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=4e-6, rtol=1e-6)
    y64 = y.astype(np.float64)
    sp = np.logaddexp(y64, 0.0)
    exact = np.tanh(sp) + y64 / (1.0 + np.exp(-y64)) * (1.0 - np.tanh(sp) ** 2)
    np.testing.assert_allclose(got, exact, atol=2e-7, rtol=0)


def test_gn_bwd_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    x, gamma, beta, g = (torch.from_numpy(a) for a in _gn_data(3, 2, 4, 4, 32))
    before = group_norm_mish_bwd.launches
    got = group_norm_mish_bwd(x, gamma, beta, g, 8)
    assert group_norm_mish_bwd.launches == before
    want = group_norm_mish_bwd_plain(x, gamma, beta, g, 8)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert got[0].dtype == torch.float32 and got[1].shape == (32,)


def test_gn_bwd_bf16_gives_dx_in_bf16_and_f32_parameter_grads():
    x, gamma, beta, g = (torch.from_numpy(a) for a in _gn_data(4, 2, 4, 4, 32))
    xb, gb = x.bfloat16(), g.bfloat16()
    dx, dgamma, dbeta = group_norm_mish_bwd_plain(xb, gamma, beta, gb, 8)
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == dbeta.dtype == torch.float32
    want = group_norm_mish_bwd_plain(xb.float(), gamma, beta, gb.float(), 8)
    torch.testing.assert_close(dx, want[0].bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(dgamma, want[1], atol=0, rtol=0)


def _qkvg(seed, b, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, HEADS * D)).astype(dtype) for _ in range(4))


def _jax_la_vjp(q, k, v, g, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: xla_flat(q, k, v, HEADS), *args)
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, dtype))]


# the flagship's N = 64 and 256 at batch 2; at batch 1 its N = 1024 (a
# cluster of 8 CTAs in the bf16 kernel), a ragged N = 100 and the latent
# UNet's N = 16
LA_BWD_N = [64, 256, 1024, 100, 16]


def _la_batch(n):
    return 2 if n in (64, 256) else 1


@pytest.mark.parametrize("n", LA_BWD_N)
def test_la_bwd_plain_matches_jax_vjp_f32(n):
    q, k, v, g = _qkvg(n, _la_batch(n), n)
    want = _jax_la_vjp(q, k, v, g, jnp.float32)
    got = linear_attention_flat_bwd_plain(*map(torch.from_numpy, (q, k, v, g)), HEADS)
    _assert_close(got, want)


# bfloat16: both sides compute in f32 from the same bf16 inputs and round each
# gradient once, but the f32 sums run in another order, so a rounding can
# flip: at most one bf16 ulp (2^-7 of the value), or an absolute 2^-10 at
# the small values where the f32 error itself is near an ulp; and no more
# than 0.2% of the elements may differ at all (observed: dq none, dk 14 and
# dv 29 of 65,536 at N=256, at most 0.0039 apart)
BF16_RTOL, BF16_ATOL, BF16_MAX_SHARE = 2.0 ** -7, 2.0 ** -10, 0.002


@pytest.mark.parametrize("n", LA_BWD_N)
def test_la_bwd_plain_matches_jax_vjp_bf16(n):
    q, k, v, g = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                  for a in _qkvg(n + 1, _la_batch(n), n))
    want = _jax_la_vjp(q, k, v, g, jnp.bfloat16)
    got = linear_attention_flat_bwd_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v, g)), HEADS)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=BF16_RTOL)
        assert (a != b).mean() <= BF16_MAX_SHARE


def test_la_function_matches_autograd_of_plain_forward():
    q, k, v, g = map(torch.from_numpy, _qkvg(9, 2, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    LinearAttentionFlatFn.apply(*leaves, HEADS).backward(g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    linear_attention_flat_plain(*ref, HEADS).backward(g)
    _assert_close([t.grad for t in leaves], [t.grad for t in ref])


def test_la_bwd_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    q, k, v, g = map(torch.from_numpy, _qkvg(10, 2, 64))
    before = linear_attention_flat_bwd.launches
    got = linear_attention_flat_bwd(q, k, v, g, HEADS)
    assert linear_attention_flat_bwd.launches == before
    for a, b in zip(got, linear_attention_flat_bwd_plain(q, k, v, g, HEADS)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError):
        linear_attention_flat_bwd(q, k, v, g[:, :32], HEADS)


def test_unet_remat_gives_the_same_gradients():
    """remat=True recomputes each ResnetBlock in the backward
    (torch.utils.checkpoint): the same arithmetic, so the same gradients."""
    gen = torch.Generator().manual_seed(0)
    nets = [Unet(dim=16, dim_mults=(1, 2), channels=3, remat=r) for r in (False, True)]
    for m in nets[0].modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(2, 8, 8, 3, generator=gen)
    t = torch.tensor([3.0, 11.0])
    grads = []
    for net in nets:
        net(x, t).square().mean().backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=0, rtol=0)
