"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode); run them there
with ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
Tolerances as in chip_smoke.py: float32 sums in another order; bf16 one
ulp of the value.  The f32 parameter gradients of GroupNorm+Mish sum up to
N*H*W products per channel: held to 1e-4 of their largest value.  The
nearest-codebook indices are equal except at near-ties, where the plain
version's scores at the two indices differ by at most
1e-5 (||e||^2 + 2 ||z|| ||e||) (``near_tie_gaps`` <= 1).  The dropout
flash attention's lse is float32 in both dtypes: held to 1e-5; its bf16
forward, dq and dk/dv, and the bf16 linear-attention forward and backward,
run on the tensor cores and sum in another order than the plain version,
within the same bf16 tolerance.  The fused
conv3x3+GroupNorm+Mish block in float32 is held to atol 3e-5, as
tests/test_fused_block.py holds the Pallas kernel to XLA.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu_torch.ops import dropout_attention as da  # noqa: E402
from igm_tpu_torch.ops.fused_block import block_fwd_plain, fused_block_fwd  # noqa: E402
from igm_tpu_torch.ops.groupnorm import (  # noqa: E402
    GroupNormMishFn, group_norm_mish, group_norm_mish_bwd, group_norm_mish_bwd_plain,
    group_norm_mish_plain)
from igm_tpu_torch.ops.linear_attention import (  # noqa: E402
    BF16_BWD_TC_MAX_N, BF16_TC_MAX_N, LinearAttentionFlatFn, bwd_on_tensor_cores,
    fwd_on_tensor_cores, linear_attention_flat, linear_attention_flat_bwd,
    linear_attention_flat_bwd_plain, linear_attention_flat_plain)
from igm_tpu_torch.ops.vq import (  # noqa: E402
    RESIDENT_MAX_D, near_tie_gaps, nearest_codebook, nearest_codebook_plain)

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
    ((64, 8, 8, 64), 8),       # the latent UNet's shapes (batch 64 and 128)
    ((64, 4, 4, 128), 8),
    ((128, 4, 4, 64), 8),
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


# the one-pass forward's plans (csrc/group_norm_mish.cu gn_plan): a sample
# split over a cluster of 4 CTAs at the sampling batch, batch 1, the latent
# shapes at large batches, a cluster of 8 CTAs of 8 chunks a thread (R =
# 8) and of 16 (the largest sample it takes, 64x64x64 in bf16), and past
# it (64x65x64), and C / VEC dividing 256 (C = 2048 bf16) or not (C = 192):
# the last of each pair runs the two-pass kernel
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [
    (64, 32, 32, 64), (1, 32, 32, 64), (1, 8, 8, 64), (1024, 4, 4, 128), (2048, 4, 4, 64),
    (1, 32, 64, 64), (1, 64, 64, 64), (1, 64, 65, 64), (2, 8, 8, 2048), (2, 8, 8, 192),
])
def test_group_norm_mish_kernel_plans(gen, dtype, shape):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    before = group_norm_mish.launches
    got = group_norm_mish(x, gamma, beta, 8)
    torch.cuda.synchronize()
    assert group_norm_mish.launches == before + 1
    _close(got, group_norm_mish_plain(x, gamma, beta, 8), dtype)


def test_group_norm_mish_kernel_repeats_exactly(gen):
    """No atomics: the forward gives the same bits twice, over a cluster
    (64, 32, 32, 64) and one CTA a sample (1024, 4, 4, 128)."""
    for shape in ((64, 32, 32, 64), (1024, 4, 4, 128)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = torch.randn(shape[-1], generator=gen, device="cuda") * 0.1 + 1.0
        beta = torch.randn(shape[-1], generator=gen, device="cuda") * 0.1
        assert torch.equal(group_norm_mish(x, gamma, beta), group_norm_mish(x, gamma, beta))


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


# the flagship's and the latent UNet's N, ragged N, and the bf16 kernel's
# plans: four heads per CTA (N <= 16), two (N <= 32), one (N <= 256), a
# cluster of 2 CTAs (N = 300), 4 (N = 1024) and 8 (N = 4096 of a 64x64
# UNet, and the largest N the tensor cores take); past it the FMA kernel
# (N = 11,265, and 16,384 of a 128x128 UNet's first level)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1),
                                 (64, 64), (128, 16), (3, 17), (2, 33), (1, 130),
                                 (2, 300), (2, 4096), (1, BF16_TC_MAX_N),
                                 (1, BF16_TC_MAX_N + 1), (2, 16384)])
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


def test_linear_attention_kernel_repeats_exactly(gen):
    """No atomics: the bf16 forward gives the same bits twice, split over a
    cluster (N = 1024, 4 CTAs) and with four heads per CTA (N = 16)."""
    for b, n in ((8, 1024), (16, 16)):
        q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        assert torch.equal(linear_attention_flat(q, k, v, 4), linear_attention_flat(q, k, v, 4))


def test_linear_attention_kernel_rejects_unaligned_or_long_bf16(gen):
    """The bf16 forward stages rows with 16-byte cp.async: a bf16 view 2
    bytes past an aligned start raises, with no fallback.  N past the
    tensor cores' BF16_TC_MAX_N is no longer refused: it launches the FMA
    kernel."""
    b, n = 2, 64
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    buf = torch.randn(b * n * 128 + 1, generator=gen, device="cuda").bfloat16()
    shifted = buf[1:].view(b, n, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    long = torch.zeros(1, BF16_TC_MAX_N + 1, 128, device="cuda", dtype=torch.bfloat16)
    before = linear_attention_flat.launches
    for args in ((shifted, k, v), (q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            linear_attention_flat(*args, 4)
    assert linear_attention_flat.launches == before
    assert fwd_on_tensor_cores(BF16_TC_MAX_N) and not fwd_on_tensor_cores(BF16_TC_MAX_N + 1)
    linear_attention_flat(q, k, v, 4)                   # aligned: launches
    linear_attention_flat(long, long, long, 4)          # bf16 past the tensor cores
    linear_attention_flat(long.float(), long.float(), long.float(), 4)   # f32: any N
    assert linear_attention_flat.launches == before + 3


GN_SHAPES = [((3, 32, 32, 64), 8), ((2, 8, 8, 256), 8), ((2, 5, 7, 32), 8),
             ((1, 4, 4, 40), 8), ((2, 3, 3, 512), 32), ((128, 8, 8, 64), 8),
             ((128, 4, 4, 128), 8), ((128, 4, 4, 64), 8)]


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
    """No atomics: the same inputs give the same bits, in one CTA a sample
    (4, 16, 16, 128) and over clusters of 4 (bf16) and 8 (f32) CTAs."""
    for shape, dtype in (((4, 16, 16, 128), torch.bfloat16),
                         ((8, 32, 32, 64), torch.bfloat16), ((8, 32, 32, 64), torch.float32)):
        x, gamma, beta, g = _gn_inputs(gen, shape, dtype)
        runs = [group_norm_mish_bwd(x, gamma, beta, g, 8) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# the one-pass backward's plans (csrc/group_norm_mish.cu gn_plan, as the
# forward's), by H*W rows of C = 64 (32 rows a sweep in bf16, 16 in f32):
# one CTA (8x8), a cluster of 2 (16x32 bf16), 4 (32x32 bf16; 8x8x256 f32 is
# 2) and 8 (32x64 bf16, 32x32 f32) CTAs, batch 1, the largest sample the
# plan takes (64x64x64 in bf16, 32x64x64 in f32: R = 16 over 8 CTAs) and the
# first past it (64x65x64, 33x64x64: the first kernel), the flagship's other
# shapes, many clusters (64 x 32x32x64) and CTAs (300 x 8x8x128), and C /
# VEC dividing 256 (C = 2048 bf16) or not (C = 192; C = 2048 f32): the first
# kernel
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [
    (4, 8, 8, 64), (3, 16, 32, 64), (2, 32, 32, 64), (2, 32, 64, 64), (1, 32, 32, 64),
    (1, 64, 64, 64), (1, 64, 65, 64), (1, 33, 64, 64), (2, 8, 8, 256), (3, 16, 16, 128),
    (2, 8, 8, 128), (64, 32, 32, 64), (300, 8, 8, 128), (2, 8, 8, 2048), (2, 8, 8, 192),
])
def test_group_norm_mish_bwd_kernel_plans(gen, dtype, shape):
    x, gamma, beta, g = _gn_inputs(gen, shape, dtype)
    before = group_norm_mish_bwd.launches
    dx, dgamma, dbeta = group_norm_mish_bwd(x, gamma, beta, g, 8)
    torch.cuda.synchronize()
    assert group_norm_mish_bwd.launches == before + 1
    want = group_norm_mish_bwd_plain(x, gamma, beta, g, 8)
    _close(dx, want[0], dtype)
    _close_param_grad(dgamma, want[1])
    _close_param_grad(dbeta, want[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 32, 32, 64), (2, 5, 7, 32)])
def test_group_norm_mish_bwd_kernel_constant_group(gen, dtype, shape):
    """A group of constant x (its variance clamps to 0, inv = 1/sqrt(eps)):
    dx as the plain version gives it, in one CTA, over a cluster, and on the
    first kernel (groups of 4 channels in bf16)."""
    x, gamma, beta, g = _gn_inputs(gen, shape, dtype)
    cg = shape[-1] // 8
    x[0, ..., :cg] = 0.75
    x[1, ..., 3 * cg:4 * cg] = -1.5
    dx, dgamma, dbeta = group_norm_mish_bwd(x, gamma, beta, g, 8)
    torch.cuda.synchronize()
    want = group_norm_mish_bwd_plain(x, gamma, beta, g, 8)
    _close(dx, want[0], dtype)
    _close_param_grad(dgamma, want[1])
    _close_param_grad(dbeta, want[2])


# the flagship's and the latent UNet's N, ragged N, and the bf16 kernel's
# plans: four heads per CTA (N = 16), two (N = 32), a cluster of 3 CTAs
# over 257 rows, 8 CTAs (N = 1024, 4096), the longest N on the tensor
# cores (8 x 672) and past it (f32 FMAs), up to BF16_TC_MAX_N; these check the
# output, test_linear_attention_bwd_tensor_core_rule which kernel runs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1),
                                 (64, 64), (128, 16), (3, 16), (2, 32), (2, 257),
                                 (2, 4096), (1, BF16_BWD_TC_MAX_N),
                                 (1, BF16_BWD_TC_MAX_N + 1), (1, BF16_TC_MAX_N)])
def test_linear_attention_bwd_kernel(gen, dtype, b, n):
    q, k, v, g = (torch.randn(b, n, 128, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    before = linear_attention_flat_bwd.launches
    got = linear_attention_flat_bwd(q, k, v, g, 4)
    torch.cuda.synchronize()
    assert linear_attention_flat_bwd.launches == before + 1
    for a, w in zip(got, linear_attention_flat_bwd_plain(q, k, v, g, 4)):
        _close(a, w, dtype)


def test_linear_attention_bwd_tensor_core_rule(gen):
    """BF16_BWD_TC_MAX_N is the built kernel's own rule: the bf16 backward
    runs on the tensor cores up to it and on the FMA kernel past it."""
    for n in (1, 16, 32, 257, 1024, 4096, BF16_BWD_TC_MAX_N):
        assert bwd_on_tensor_cores(n), n
    for n in (BF16_BWD_TC_MAX_N + 1, BF16_TC_MAX_N):
        assert not bwd_on_tensor_cores(n), n


def test_linear_attention_bwd_kernel_repeats_exactly(gen):
    """No atomics: the bf16 backward gives the same bits twice, split over a
    cluster (N = 1024, 8 CTAs) and with four heads per CTA (N = 16)."""
    for b, n in ((8, 1024), (16, 16)):
        q, k, v, g = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        runs = [linear_attention_flat_bwd(q, k, v, g, 4) for _ in range(2)]
        for a, w in zip(*runs):
            assert torch.equal(a, w)


def test_linear_attention_bwd_kernel_rejects_unaligned_bf16(gen):
    """The bf16 backward stages rows with 16-byte cp.async: a bf16 view 2
    bytes past an aligned start raises, with no fallback; f32 takes it."""
    b, n = 2, 64
    q, k, v, g = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
                  for _ in range(4))
    buf = torch.randn(b * n * 128 + 1, generator=gen, device="cuda").bfloat16()
    shifted = buf[1:].view(b, n, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = linear_attention_flat_bwd.launches
    for i in range(4):
        args = [q, k, v, g]
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte"):
            linear_attention_flat_bwd(*args, 4)
    assert linear_attention_flat_bwd.launches == before
    f32 = buf.float()[1:].view(b, n, 128)
    linear_attention_flat_bwd(f32, f32, f32, f32, 4)
    assert linear_attention_flat_bwd.launches == before + 1


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


# the kernel's tiles are 128 rows of z and 64 codes, a cluster of up to 8
# CTAs splits the code tiles: ragged M, K and D (one past a tile, D not a
# multiple of 4), a K whose 9 tiles split unevenly over 4 (M = 8192) and 8
# (M = 4096) CTAs, with ranks that get none, and the largest D it takes
# resident; past it the kernel that stages 32 features at a time (D = 217,
# and 256 and 512 of experiment=vqvae/cifar10 model.latent_dim=256 / 512)
@pytest.mark.parametrize("m,k,d", [(8192, 512, 64), (4096, 512, 64), (1000, 500, 64),
                                   (33, 65, 70), (1, 1, 1), (129, 65, 64), (129, 65, 70),
                                   (128, 64, 3), (8192, 513, 64), (4096, 520, 64),
                                   (300, 70, RESIDENT_MAX_D), (300, 70, RESIDENT_MAX_D + 1),
                                   (8192, 512, 256), (1000, 500, 512)])
def test_nearest_codebook_kernel(gen, m, k, d):
    """The VQ-VAE train step's and the decode's shapes, and the ragged
    cases above."""
    z = torch.randn(m, d, generator=gen, device="cuda")
    book = torch.randn(k, d, generator=gen, device="cuda")
    before = nearest_codebook.launches
    got = nearest_codebook(z, book)
    torch.cuda.synchronize()
    assert nearest_codebook.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m,)
    want = nearest_codebook_plain(z, book)
    n_diff, gap, _ = near_tie_gaps(z, book, got, want)
    print(f"rows that differ: {n_diff} of {m}, largest gap {gap:.3g}")
    assert gap <= 1.0


def test_nearest_codebook_kernel_ties_and_hits(gen):
    """Duplicated codes: the lower index; z rows on codes: those codes."""
    base = torch.randn(256, 64, generator=gen, device="cuda")
    perm = torch.randperm(256, generator=gen, device="cuda")
    book = torch.cat([base, base[perm]])
    z = torch.randn(4096, 64, generator=gen, device="cuda")
    got = nearest_codebook(z, book)
    assert int(got.max()) < 256           # each best code's first copy
    pick = torch.randint(0, 256, (4096,), generator=gen, device="cuda")
    assert torch.equal(nearest_codebook(base[pick], base).long(), pick)


def test_nearest_codebook_kernel_rejects_what_it_cannot_take(gen):
    z = torch.randn(64, 64, generator=gen, device="cuda")
    book = torch.randn(32, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        nearest_codebook(z.bfloat16(), book)
    with pytest.raises(TypeError):
        nearest_codebook(z, book.double())
    with pytest.raises(ValueError):
        nearest_codebook(z.t(), book)                            # (64, 64) strided
    with pytest.raises(ValueError):
        nearest_codebook(z, book.cpu())
    # D past RESIDENT_MAX_D is no longer refused: the chunked kernel takes it
    wide = torch.randn(4, RESIDENT_MAX_D + 1, generator=gen, device="cuda")
    before = nearest_codebook.launches
    assert torch.equal(nearest_codebook(wide, wide).long(), torch.arange(4, device="cuda"))
    assert nearest_codebook.launches == before + 1


def test_nearest_codebook_kernel_nan_row(gen):
    """A NaN in a row of z makes every score of that row NaN: the first
    code, as argmin gives it; the other rows are unaffected."""
    z = torch.randn(300, 64, generator=gen, device="cuda")
    book = torch.randn(512, 64, generator=gen, device="cuda")
    z[7, 3] = float("nan")
    z[200, 63] = float("nan")
    got = nearest_codebook(z, book)
    want = nearest_codebook_plain(z, book)
    assert int(got[7]) == int(got[200]) == int(want[7]) == int(want[200]) == 0
    keep = torch.ones(300, dtype=torch.bool, device="cuda")
    keep[[7, 200]] = False
    _, gap, _ = near_tie_gaps(z[keep], book, got[keep], want[keep])
    assert gap <= 1.0


# (B, S, H) with D = 64: ragged S (TAR's 785, 200, 130), one tile, one token;
# the tile edges the kernels mask (one row short of a 64-row tile, one past,
# two whole tiles, one past them); and TAR's S over many waves of CTAs
ATTN_SHAPES = [(2, 200, 2), (3, 785, 4), (2, 64, 3), (1, 130, 2), (1, 1, 1),
               (1, 63, 2), (2, 65, 1), (1, 128, 2), (1, 129, 3), (16, 785, 4)]


def _attn_inputs(gen, b, s, h, dtype):
    return tuple(torch.randn(b, s, h, 64, generator=gen, device="cuda").to(dtype)
                 for _ in range(4))                                 # q, k, v, do


def _attn_launches():
    return (da.dropout_attention_fwd.launches, da.dropout_attention_dq.launches,
            da.dropout_attention_dkv.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 123), (0.1, 2 ** 32 - 3), (0.5, 7)])
@pytest.mark.parametrize("b,s,h", ATTN_SHAPES)
def test_dropout_attention_kernels(gen, dtype, rate, seed, b, s, h):
    """The forward, dq and dk/dv kernels against their plain versions on the
    same inputs (the plain forward's lse and delta feed both backwards); a
    seed near 2**32 wraps when b*H + h is added."""
    q, k, v, do = _attn_inputs(gen, b, s, h, dtype)
    sd = torch.tensor(seed, device="cuda")
    before = _attn_launches()
    o, lse = da.dropout_attention_fwd(q, k, v, sd, rate)
    want_o, want_lse = da.dropout_attention_fwd_plain(q, k, v, sd, rate)
    args = (q, k, v, do, want_lse, da.attention_delta(do, want_o), sd, rate)
    dq = da.dropout_attention_dq(*args)
    dk, dv = da.dropout_attention_dkv(*args)
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_attn_launches(), before)] == [1, 1, 1]
    _close(o, want_o, dtype)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, s)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    _close(dq, da.dropout_attention_dq_plain(*args), dtype)
    for got, want in zip((dk, dv), da.dropout_attention_dkv_plain(*args)):
        _close(got, want, dtype)


def test_dropout_attention_seed_as_int_or_tensor(gen):
    q, k, v, _ = _attn_inputs(gen, 2, 150, 2, torch.float32)
    a, _ = da.dropout_attention_fwd(q, k, v, 2 ** 32 - 1, 0.1)
    b, _ = da.dropout_attention_fwd(q, k, v, torch.tensor(2 ** 32 - 1, device="cuda"), 0.1)
    c, _ = da.dropout_attention_fwd(q, k, v, 5, 0.1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_attention_fn_matches_autograd_of_plain(gen):
    """DropoutAttentionFn: one launch of each kernel, gradients as torch
    autograd through the plain forward (f32)."""
    q, k, v, do = _attn_inputs(gen, 2, 300, 2, torch.float32)
    seed = torch.tensor(99, device="cuda")
    before = _attn_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    da.flash_causal_attention_dropout(*leaves, seed, 0.1).backward(do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_attn_launches(), before)] == [1, 1, 1]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    da.dropout_attention_fwd_plain(*ref, seed, 0.1)[0].backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4 * float(b.grad.abs().max()),
                                   rtol=1e-4)


def test_dropout_attention_backward_repeats_exactly(gen):
    """No atomics: the same inputs and seed give the same gradient bits."""
    q, k, v, do = _attn_inputs(gen, 2, 785, 4, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        da.flash_causal_attention_dropout(*leaves, torch.tensor(7, device="cuda"),
                                          0.1).backward(do)
        runs.append([t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [da.dropout_attention_dq, da.dropout_attention_dkv],
                         ids=["dq", "dkv"])
def test_dropout_attention_backward_rejects_unaligned_bf16(gen, kernel):
    """The bf16 backward copies rows with 16-byte cp.async: a contiguous
    bf16 view 2 bytes past an aligned start raises, with no fallback."""
    b, s, h = 1, 65, 2
    n = b * s * h * 64
    q, k, v, do = _attn_inputs(gen, b, s, h, torch.bfloat16)
    o, lse = da.dropout_attention_fwd_plain(q, k, v, 3, 0.1)
    delta = da.attention_delta(do, o)
    buf = torch.randn(n + 1, generator=gen, device="cuda").to(torch.bfloat16)
    shifted = buf[1:].view(b, s, h, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = kernel.launches
    for args in ((shifted, k, v, do), (q, k, v, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            kernel(*args, lse, delta, 3, 0.1)
    assert kernel.launches == before
    kernel(q, k, v, do, lse, delta, 3, 0.1)             # aligned: launches
    assert kernel.launches == before + 1


def test_dropout_attention_forward_repeats_exactly(gen):
    """No atomics: the bf16 forward gives the same o and lse bits twice, at
    rate 0 and 0.1."""
    q, k, v, _ = _attn_inputs(gen, 2, 785, 4, torch.bfloat16)
    sd = torch.tensor(7, device="cuda")
    for rate in (0.0, 0.1):
        (o1, lse1), (o2, lse2) = (da.dropout_attention_fwd(q, k, v, sd, rate) for _ in range(2))
        assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_dropout_attention_forward_rejects_unaligned_bf16(gen):
    """The bf16 forward copies rows with 16-byte cp.async: a contiguous bf16
    view 2 bytes past an aligned start raises, with no fallback."""
    b, s, h = 1, 65, 2
    q, k, v, _ = _attn_inputs(gen, b, s, h, torch.bfloat16)
    buf = torch.randn(b * s * h * 64 + 1, generator=gen, device="cuda").to(torch.bfloat16)
    shifted = buf[1:].view(b, s, h, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = da.dropout_attention_fwd.launches
    for args in ((shifted, k, v), (q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            da.dropout_attention_fwd(*args, 3, 0.1)
    assert da.dropout_attention_fwd.launches == before
    da.dropout_attention_fwd(q, k, v, 3, 0.1)           # aligned: launches
    assert da.dropout_attention_fwd.launches == before + 1


def test_dropout_attention_rejects_what_it_cannot_take(gen):
    q = torch.randn(2, 16, 2, 64, generator=gen, device="cuda")
    r = torch.randn(2, 16, 2, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        da.dropout_attention_fwd(r, r, r, 0, 0.1)                              # D = 32
    with pytest.raises(ValueError):
        da.dropout_attention_fwd(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2),
                                 0, 0.1)                                       # strided
    with pytest.raises(TypeError):
        da.dropout_attention_fwd(q.half(), q.half(), q.half(), 0, 0.1)
    with pytest.raises(ValueError):
        da.dropout_attention_fwd(q, q, q, 0, 1.0)


# (N, H, W, Cin, Cout): tests/test_fused_block.py's (odd spatial with cg = 3,
# RGB input), N that is a multiple of nothing, and the flagship's middle level
FUSED_SHAPES = [(4, 8, 8, 16, 16), (2, 6, 5, 8, 24), (2, 4, 4, 3, 16), (3, 7, 9, 5, 40),
                (17, 16, 16, 128, 128)]
# float32: the conv sums in another order than cuDNN's, as
# tests/test_fused_block.py holds the Pallas kernel to XLA
FUSED_F32_ATOL = 3e-5


def _fused_inputs(gen, n, h, w, ci, co, dtype):
    return ((torch.randn(n, h, w, ci, generator=gen, device="cuda")).to(dtype),
            (torch.randn(3, 3, ci, co, generator=gen, device="cuda") * 0.1).to(dtype),
            torch.randn(co, generator=gen, device="cuda") * 0.1,
            1 + torch.randn(co, generator=gen, device="cuda") * 0.1,
            torch.randn(co, generator=gen, device="cuda") * 0.1)


@pytest.fixture
def no_tf32(monkeypatch):
    """The plain version's f32 conv in full float32 (cuDNN's default is TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n,h,w,ci,co", FUSED_SHAPES)
def test_fused_block_kernel(gen, no_tf32, dtype, n, h, w, ci, co):
    args = _fused_inputs(gen, n, h, w, ci, co, dtype)
    before = fused_block_fwd.launches
    got = fused_block_fwd(*args)
    torch.cuda.synchronize()
    assert fused_block_fwd.launches == before + 1
    want = block_fwd_plain(*args)
    if dtype == torch.float32:
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=FUSED_F32_ATOL, rtol=0)
    else:
        _close(got, want, dtype)


def test_fused_block_kernel_repeats_exactly(gen):
    """No atomics: the same inputs give the same bits."""
    args = _fused_inputs(gen, 8, 32, 32, 64, 64, torch.bfloat16)
    assert torch.equal(fused_block_fwd(*args), fused_block_fwd(*args))


def test_fused_block_kernel_rejects_what_it_cannot_take(gen):
    x, w, b, sc, bi = _fused_inputs(gen, 1, 64, 64, 8, 64, torch.float32)
    before = fused_block_fwd.launches
    with pytest.raises(ValueError, match="limit is 1024"):
        fused_block_fwd(x, w, b, sc, bi, groups=1)                    # oversize group
    with pytest.raises(ValueError):
        fused_block_fwd(x.transpose(1, 2), w, b, sc, bi)             # not contiguous
    with pytest.raises(TypeError):
        fused_block_fwd(x.half(), w, b, sc, bi)
    with pytest.raises(ValueError):
        fused_block_fwd(x, w, b.cpu(), sc, bi)
    assert fused_block_fwd.launches == before


# ------------------------------------------------- CUDA graphs (core/graphs.py)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def numerics(monkeypatch):
    """As the entry points run (utils.platform.set_numerics): no TF32, and
    cuDNN's deterministic algorithms, without which no two train steps
    agree bit for bit."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def _model(*overrides):
    from igm_tpu_torch.config import compose, instantiate
    cfg = compose(REPO / "configs", [*overrides, "print_config=False"])
    return instantiate(cfg.model, datamodule=cfg.datamodule, device="cuda")


def _differ(a, b, path=""):
    """Where two nested states differ, bit for bit (NaNs included)."""
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype.is_floating_point:
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.view(ints), b.view(ints) if b.dtype == a.dtype else b
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [path]
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [d for k in a for d in _differ(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differ(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _graphed_against_eager(model, batches, k):
    """K graphed steps (the first call captures, the second replays) against
    K eager steps from the same state: the state and the merged metrics."""
    from igm_tpu_torch.models.base import merge_metrics
    state = model.init_state(0)
    imgs, labels = batches
    state, _ = model.train_step(state, (imgs[0], labels[0]))
    start = state.snapshot()
    eager = merge_metrics([model.train_step(state, (imgs[i], labels[i]))[1] for i in range(k)])
    want = state.snapshot()
    for _ in ("capture", "replay"):
        state.load_state_dict(start)
        _, metrics = model.train_step_n(state, (imgs[:k], labels[:k]))
        assert not _differ(state.snapshot(), want)
        assert not _differ(metrics, eager)
    assert state.step == start["step"] + k
    return state


@pytest.mark.parametrize("k", [1, 3])
def test_graphed_ddpm_train_step_equals_eager(gen, numerics, k):
    """The DDPM step with an EMA shadow (updated inside the step), bf16."""
    model = _model("experiment=ddpm/cifar10", "model.hidden_dim=32", "model.timesteps=50",
                   "model.ema_decay=0.9")
    imgs = torch.randint(0, 256, (3, 8, 32, 32, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    labels = torch.zeros(3, 8, dtype=torch.int32, device="cuda")
    before = group_norm_mish_bwd.launches
    state = _graphed_against_eager(model, (imgs, labels), k)
    # one eager step, k eager, k eager and captured, k replayed: 25 a step
    assert group_norm_mish_bwd.launches - before == 25 * (1 + 3 * k)
    assert len(state.graphs) == 1


def test_graphed_tar_train_step_equals_eager(gen, numerics):
    """TAR with the dropout flash attention (seeds drawn on the card) and
    step_lr (the learning rate written into the graph's slots)."""
    model = _model("experiment=tar/mnist", "model.flash_attention=dropout",
                   "model.d_model=128", "model.nhead=2", "model.num_layers=1",
                   "datamodule.width=8", "datamodule.height=8")
    model.steps_per_epoch = 2                   # the learning rate moves within the chunk
    imgs = torch.randint(0, 256, (3, 16, 8, 8, 1), generator=gen, device="cuda",
                         dtype=torch.uint8)
    labels = torch.randint(0, 10, (3, 16), generator=gen, device="cuda", dtype=torch.int32)
    before = da.dropout_attention_dq.launches
    _graphed_against_eager(model, (imgs, labels), 3)
    # one eager step, three eager, three eager and captured, three replayed
    assert da.dropout_attention_dq.launches - before == 1 + 3 + 3 + 3


def test_graphed_denoiser_equals_eager_and_follows_ema(gen, numerics):
    """DDIM through the denoiser's graph equals the eager chain, with the
    EMA shadow's weights; after train steps move the shadow in place, the
    same graph samples with the new shadow."""
    model = _model("experiment=ddpm/cifar10", "model.hidden_dim=32", "model.timesteps=50",
                   "model.ema_decay=0.5")
    state = model.init_state(0)
    batch = (torch.randint(0, 256, (8, 32, 32, 3), generator=gen, device="cuda",
                           dtype=torch.uint8), torch.zeros(8, dtype=torch.int32, device="cuda"))
    x_T = torch.randn(4, 32, 32, 3, generator=gen, device="cuda")
    for _ in range(2):
        samples = {}
        for graphs in (True, False, True):
            model.use_graphs = graphs
            samples.setdefault(graphs, []).append(model.ddim_sample(4, steps=5, x_T=x_T))
        assert torch.equal(samples[True][0], samples[False][0])
        assert torch.equal(samples[True][1], samples[False][0])
        assert len(model._graphs) == 1
        for _ in range(2):
            state, _ = model.train_step(state, batch)
    before = group_norm_mish.launches
    model.use_graphs = True
    model.ddim_sample(4, steps=5, x_T=x_T)
    assert group_norm_mish.launches - before == 5 * 25


def test_capturable_adam_matches_adam(gen):
    """The card's Adam (capturable, lr a device tensor, the step count on the
    card) within float32 tolerance of torch.optim.Adam with a float lr and
    a host step count, over three steps."""
    from igm_tpu_torch.core.optim import adam, step_lr
    params = [torch.randn(64, 32, generator=gen, device="cuda"),
              torch.randn(32, generator=gen, device="cuda") * 1e-3]
    mine = [p.clone() for p in params]
    spec = adam(step_lr(1e-3, 0.5, 1), 0.5, 0.999)
    opt = spec.create(mine)
    assert opt.param_groups[0]["capturable"] and torch.is_tensor(opt.param_groups[0]["lr"])
    ref = torch.optim.Adam(params, lr=1e-3, betas=(0.5, 0.999), eps=1e-8)
    for step in range(3):
        grads = [torch.randn(p.shape, generator=gen, device="cuda") for p in params]
        for group in ref.param_groups:
            group["lr"] = spec.lr_at(step)
        opt.param_groups[0]["lr"].fill_(spec.lr_at(step))
        for p, q, g in zip(params, mine, grads):
            p.grad, q.grad = g.clone(), g.clone()
        ref.step()
        opt.step()
        for p, q in zip(params, mine):
            torch.testing.assert_close(q, p, atol=1e-7, rtol=1e-6)


def test_pr10_checkpoint_restores_and_replays(gen, numerics, tmp_path):
    """A checkpoint in the layout the port wrote before capturable Adam (the
    card's Adam with a float lr and its step count a CPU tensor) restores
    into the card's state, and graphed steps from it equal eager ones."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    over = ("experiment=ddpm/cifar10", "model.hidden_dim=32", "model.timesteps=50")
    model = _model(*over)
    old = model.init_state(0)
    params = list(model.modules["denoise"].parameters())
    old.opt_states["opt"] = torch.optim.Adam(params, lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
    imgs = torch.randint(0, 256, (2, 8, 32, 32, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    labels = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    for i in range(2):
        old, _ = model.train_step(old, (imgs[i], labels[i]))
    manager = CheckpointManager(str(tmp_path))
    manager.save(old.step, old)
    manager.wait()
    saved = manager.restore_raw()
    assert not saved["opt_states"]["opt"]["param_groups"][0]["capturable"]
    assert isinstance(saved["opt_states"]["opt"]["param_groups"][0]["lr"], float)

    card = manager.restore(model.init_state(1))
    assert card.step == 2
    opt = card.opt_states["opt"]
    assert opt.param_groups[0]["capturable"] and torch.is_tensor(opt.param_groups[0]["lr"])
    assert all(s["step"].is_cuda for s in opt.state.values())
    start = card.snapshot()
    for i in range(2):
        card, _ = model.train_step(card, (imgs[i], labels[i]))
    want = card.snapshot()
    for _ in ("capture", "replay"):
        card.load_state_dict(start)
        model.train_step_n(card, (imgs, labels))
        assert not _differ(card.snapshot(), want)
