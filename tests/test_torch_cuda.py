"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode); run them there
with ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
Tolerances as in chip_smoke.py: float32 sums in another order; bf16 one
ulp of the value.  The f32 parameter gradients of GroupNorm+Mish sum up to
N*H*W products per channel: held to 1e-4 of their largest value.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu_torch.ops.groupnorm import (  # noqa: E402
    GroupNormMishFn, group_norm_mish, group_norm_mish_bwd, group_norm_mish_bwd_plain,
    group_norm_mish_plain)
from igm_tpu_torch.ops.linear_attention import (  # noqa: E402
    LinearAttentionFlatFn, linear_attention_flat, linear_attention_flat_bwd,
    linear_attention_flat_bwd_plain, linear_attention_flat_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2.0 ** -7)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,groups", [
    ((3, 32, 32, 64), 8),      # 16-byte loads, one group per 8 channels
    ((2, 8, 8, 256), 8),
    ((2, 5, 7, 32), 8),        # bf16: groups of 4 channels, scalar loads
    ((1, 4, 4, 40), 8),        # groups of 5 channels: scalar loads
    ((2, 3, 3, 512), 32),
])
def test_group_norm_mish_kernel(gen, dtype, shape, groups):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    before = group_norm_mish.launches
    got = group_norm_mish(x, gamma, beta, groups)
    torch.cuda.synchronize()
    assert group_norm_mish.launches == before + 1
    _close(got, group_norm_mish_plain(x, gamma, beta, groups), dtype)


def test_group_norm_mish_kernel_unaligned_input(gen):
    """A contiguous view 4 bytes past an allocation takes the scalar loads."""
    shape = (2, 8, 8, 64)
    x = torch.randn(2 * 8 * 8 * 64 + 1, generator=gen, device="cuda")[1:].view(shape)
    gamma = torch.ones(64, device="cuda")
    beta = torch.zeros(64, device="cuda")
    _close(group_norm_mish(x, gamma, beta), group_norm_mish_plain(x, gamma, beta),
           torch.float32)


def test_group_norm_mish_kernel_rejects_what_it_cannot_take(gen):
    x = torch.randn(2, 4, 4, 64, generator=gen, device="cuda")
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(ValueError):
        group_norm_mish(x.transpose(1, 2), gamma, beta)          # not contiguous
    with pytest.raises(TypeError):
        group_norm_mish(x.half(), gamma, beta)
    with pytest.raises(TypeError):
        group_norm_mish(x, gamma.bfloat16(), beta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1)])
def test_linear_attention_kernel(gen, dtype, b, n):
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = linear_attention_flat.launches
    got = linear_attention_flat(q, k, v, 4)
    torch.cuda.synchronize()
    assert linear_attention_flat.launches == before + 1
    _close(got, linear_attention_flat_plain(q, k, v, 4), dtype)


def test_linear_attention_kernel_rejects_other_head_dims(gen):
    q = torch.randn(2, 64, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        linear_attention_flat(q, q, q, 8)                        # D = 16


GN_SHAPES = [((3, 32, 32, 64), 8), ((2, 8, 8, 256), 8), ((2, 5, 7, 32), 8),
             ((1, 4, 4, 40), 8), ((2, 3, 3, 512), 32)]


def _gn_inputs(gen, shape, dtype):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, gamma, beta, g


def _close_param_grad(got, want):
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()),
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_mish_bwd_kernel(gen, dtype, shape, groups):
    x, gamma, beta, g = _gn_inputs(gen, shape, dtype)
    before = group_norm_mish_bwd.launches
    dx, dgamma, dbeta = group_norm_mish_bwd(x, gamma, beta, g, groups)
    torch.cuda.synchronize()
    assert group_norm_mish_bwd.launches == before + 1
    want = group_norm_mish_bwd_plain(x, gamma, beta, g, groups)
    _close(dx, want[0], dtype)
    _close_param_grad(dgamma, want[1])
    _close_param_grad(dbeta, want[2])


def test_group_norm_mish_bwd_kernel_repeats_exactly(gen):
    """No atomics: the same inputs give the same bits."""
    x, gamma, beta, g = _gn_inputs(gen, (4, 16, 16, 128), torch.bfloat16)
    runs = [group_norm_mish_bwd(x, gamma, beta, g, 8) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1)])
def test_linear_attention_bwd_kernel(gen, dtype, b, n):
    q, k, v, g = (torch.randn(b, n, 128, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    before = linear_attention_flat_bwd.launches
    got = linear_attention_flat_bwd(q, k, v, g, 4)
    torch.cuda.synchronize()
    assert linear_attention_flat_bwd.launches == before + 1
    for a, w in zip(got, linear_attention_flat_bwd_plain(q, k, v, g, 4)):
        _close(a, w, dtype)


def test_autograd_functions_launch_both_kernels(gen):
    """Forward and backward through the Functions: one launch of each
    kernel, gradients as torch autograd of the plain forwards on the card."""
    x, gamma, beta, g = _gn_inputs(gen, (2, 8, 8, 64), torch.float32)
    q, k, v, gl = (torch.randn(2, 64, 128, generator=gen, device="cuda")
                   for _ in range(4))
    counts = (group_norm_mish.launches, group_norm_mish_bwd.launches,
              linear_attention_flat.launches, linear_attention_flat_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, q, k, v)]
    GroupNormMishFn.apply(*leaves[:3], 8).backward(g)
    LinearAttentionFlatFn.apply(*leaves[3:], 4).backward(gl)
    torch.cuda.synchronize()
    after = (group_norm_mish.launches, group_norm_mish_bwd.launches,
             linear_attention_flat.launches, linear_attention_flat_bwd.launches)
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1, 1]
    ref = [t.clone().requires_grad_() for t in (x, gamma, beta, q, k, v)]
    group_norm_mish_plain(*ref[:3], 8).backward(g)
    linear_attention_flat_plain(*ref[3:], 4).backward(gl)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4 * float(b.grad.abs().max()),
                                   rtol=1e-4)
