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
forward, dq and dk/dv, and the bf16 linear-attention forward, run on the
tensor cores and sum in another order than the plain version, within the
same bf16 tolerance.  The fused
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
    BF16_MAX_N, LinearAttentionFlatFn, linear_attention_flat, linear_attention_flat_bwd,
    linear_attention_flat_bwd_plain, linear_attention_flat_plain)
from igm_tpu_torch.ops.vq import (  # noqa: E402
    near_tie_gaps, nearest_codebook, nearest_codebook_plain)

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
# UNet, and the largest N the kernel takes)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1),
                                 (64, 64), (128, 16), (3, 17), (2, 33), (1, 130),
                                 (2, 300), (2, 4096), (1, BF16_MAX_N)])
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
    """The bf16 forward stages rows with 16-byte cp.async and holds a head's
    rows in the shared memory of at most 8 CTAs: a bf16 view 2 bytes past
    an aligned start, or N past BF16_MAX_N, raises, with no fallback."""
    b, n = 2, 64
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    buf = torch.randn(b * n * 128 + 1, generator=gen, device="cuda").bfloat16()
    shifted = buf[1:].view(b, n, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    long = torch.zeros(1, BF16_MAX_N + 1, 128, device="cuda", dtype=torch.bfloat16)
    before = linear_attention_flat.launches
    for args in ((shifted, k, v), (q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            linear_attention_flat(*args, 4)
    with pytest.raises(ValueError, match="N up to"):
        linear_attention_flat(long, long, long, 4)
    assert linear_attention_flat.launches == before
    linear_attention_flat(q, k, v, 4)                   # aligned: launches
    linear_attention_flat(long.float(), long.float(), long.float(), 4)   # f32: any N
    assert linear_attention_flat.launches == before + 2


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
    """No atomics: the same inputs give the same bits."""
    x, gamma, beta, g = _gn_inputs(gen, (4, 16, 16, 128), torch.bfloat16)
    runs = [group_norm_mish_bwd(x, gamma, beta, g, 8) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(2, 1024), (3, 256), (2, 64), (2, 100), (1, 1),
                                 (64, 64), (128, 16)])
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


@pytest.mark.parametrize("m,k,d", [(8192, 512, 64), (4096, 512, 64), (1000, 500, 64),
                                   (33, 65, 70), (1, 1, 1)])
def test_nearest_codebook_kernel(gen, m, k, d):
    """The VQ-VAE train step's and the decode's shapes, ragged M and K, and a
    D that is not a multiple of the staged chunk."""
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
