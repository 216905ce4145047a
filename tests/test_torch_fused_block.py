"""The port's fused conv3x3+GroupNorm+Mish block (ops/fused_block.py) against
igm_tpu's: ``xla_block_fwd`` and the Pallas kernel ``fused_block_fwd`` in
interpret mode, from the same numpy inputs, at tests/test_fused_block.py's
shapes; and the benchmark tool on the CPU.

On the CPU the port's wrapper computes its plain version.  Tolerances:
float32 atol 3e-5, what tests/test_fused_block.py holds the Pallas kernel to
against XLA (the conv sums in another order); bfloat16 one bf16 ulp (rtol
2^-7) plus atol 1e-2, where both round the same f32 values once and an
f32-level difference can flip a rounding (JAX's own test allows 0.05).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from igm_tpu.ops.pallas_fused_block import fused_block_fwd as jax_fused  # noqa: E402
from igm_tpu.ops.pallas_fused_block import xla_block_fwd  # noqa: E402
from igm_tpu_torch.ops import fused_block as fb  # noqa: E402
from igm_tpu_torch.tools import bench_fused_block  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 3e-5
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7


def _mk(n, h, w, ci, co, seed=0):
    """tests/test_fused_block.py's inputs, as numpy float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, ci)).astype(np.float32),
            (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32),
            (rng.normal(size=(co,)) * 0.1).astype(np.float32),
            (1 + rng.normal(size=(co,)) * 0.1).astype(np.float32),
            (rng.normal(size=(co,)) * 0.1).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    x, w, *vectors = (torch.from_numpy(a) for a in arrays)
    return fb.fused_block_fwd(x.to(dtype), w.to(dtype), *vectors, groups=8)


@pytest.mark.parametrize("n,h,w,ci,co,nb", [
    (4, 8, 8, 16, 16, 2),    # igm_tpu: a multi-tile grid
    (2, 6, 5, 8, 24, 1),     # odd spatial, cg=3
    (2, 4, 4, 3, 16, 2),     # RGB input channel count
])
def test_fused_block_matches_igm_tpu(n, h, w, ci, co, nb):
    arrays = _mk(n, h, w, ci, co)
    before = fb.fused_block_fwd.launches
    got = _port(arrays).numpy()
    assert fb.fused_block_fwd.launches == before          # the CPU runs no kernel
    assert got.shape == (n, h, w, co) and got.dtype == np.float32
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(got, np.asarray(xla_block_fwd(*j, groups=8)), atol=F32_ATOL)
    pallas = jax_fused(*j, groups=8, nb=nb, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=F32_ATOL)


def test_fused_block_bf16_io_matches_igm_tpu():
    arrays = _mk(2, 8, 8, 16, 16)
    got = _port(arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    x, w, *vectors = (jnp.asarray(a) for a in arrays)
    xb, wb = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    for want in (xla_block_fwd(xb, wb, *vectors, groups=8),
                 jax_fused(xb, wb, *vectors, groups=8, nb=2, interpret=True)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
        assert np.abs(got - want).max() <= 0.05             # JAX's own limit


def test_fused_block_checks_shapes_and_devices():
    x, w, b, sc, bi = (torch.from_numpy(a) for a in _mk(1, 4, 4, 8, 16))
    with pytest.raises(ValueError, match=r"\(3, 3, 8, Cout\)"):
        fb.fused_block_fwd(x, w[:, :, :4], b, sc, bi)
    with pytest.raises(ValueError, match="not divisible by groups 3"):
        fb.fused_block_fwd(x, w, b, sc, bi, groups=3)
    with pytest.raises(ValueError, match=r"must be \(16,\)"):
        fb.fused_block_fwd(x, w, b[:8], sc, bi)
    # a tensor on neither the CPU nor a card: raises, no plain fallback
    meta = [t.to("meta") for t in (x, w, b, sc, bi)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        fb.fused_block_fwd(*meta)


@pytest.mark.parametrize("h,w,cout,groups,limit", [
    (64, 64, 64, 1, "limit is 1024"),        # 16 quads x 512 position slots
    (1, 8000, 8, 8, "limit is 47104"),       # 1000 slots, a 3x8002 tile of one channel
])
def test_fused_block_group_limit(h, w, cout, groups, limit):
    """The groups that the group kernel's block could not hold (it refused them with
    ``limit``) are taken now, as igm_tpu takes any shape: in f32 by the
    two-pass kernel pair; in bf16 by the tensor cores where they have a plan
    (64x64 at Cout 64 is 8 tiles of 512 positions: one cluster a sample) and
    by the two-pass pair where not (Cout 8).  The flagship levels route to
    the cluster kernel in bf16 and to the group kernel in f32."""
    assert not fb._group_kernel_fits(h, w, 8, cout, groups)
    assert fb._route(2, h, w, 8, cout, groups, torch.float32) == "two_pass_fma"
    want = "cluster" if cout in fb.MMA_COUTS else "two_pass_fma"
    assert fb._route(2, h, w, 8, cout, groups, torch.bfloat16) == want
    for h, w, ci, c in bench_fused_block.SHAPES:
        assert fb._route(256, h, w, ci, c, 8, torch.bfloat16) == "cluster"
        assert fb._route(256, h, w, ci, c, 8, torch.float32) == "group"


@pytest.mark.parametrize("shape,dtype,route", [
    ((256, 32, 32, 64, 64), torch.bfloat16, "cluster"),       # 2 tiles of 16 rows
    ((256, 8, 8, 256, 256), torch.bfloat16, "cluster"),       # 2 samples a tile
    ((2, 64, 64, 16, 128), torch.bfloat16, "two_pass_mma"),   # 16 tiles of 4 rows
    ((1, 128, 128, 8, 64), torch.bfloat16, "two_pass_mma"),   # Cin 8: half a chunk
    ((2, 64, 64, 16, 128), torch.float32, "two_pass_fma"),    # f32: exact FMAs only
    ((4, 8, 8, 16, 16), torch.bfloat16, "group"),             # Cout 16: no tensor-core plan
    ((2, 4, 4, 3, 64), torch.bfloat16, "group"),              # Cin 3: not 16-byte rows
])
def test_fused_block_route(shape, dtype, route):
    n, h, w, ci, co = shape
    assert fb._route(n, h, w, ci, co, 8, dtype) == route


def test_fused_block_route_names_cuda_limits():
    """Only CUDA's own limits are refused, by name: the grid's 2^31 - 1 CTAs
    and the two-pass finish's groups in shared memory."""
    with pytest.raises(ValueError, match="grid limit"):
        fb._route(2 ** 30, 64, 64, 16, 128, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="at most 16384"):
        fb._route(1, 128, 128, 8, 32768, 32768, torch.float32)


def test_fused_block_plain_matches_igm_tpu_past_the_old_limit():
    """A shape the group kernel refused (cg 16 over 64x64 positions needed 2,048
    threads): the plain version, which the card's two-pass kernels are held
    to, against igm_tpu's Pallas kernel in interpret mode, f32, atol 3e-5."""
    n, h, w, ci, co, groups = 1, 64, 64, 4, 32, 2
    assert not fb._group_kernel_fits(h, w, ci, co, groups)
    assert fb._route(n, h, w, ci, co, groups, torch.float32) == "two_pass_fma"
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(n, h, w, ci)).astype(np.float32),
              (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32),
              (rng.normal(size=(co,)) * 0.1).astype(np.float32),
              (1 + rng.normal(size=(co,)) * 0.1).astype(np.float32),
              (rng.normal(size=(co,)) * 0.1).astype(np.float32))
    x, wt, *vectors = (torch.from_numpy(a) for a in arrays)
    got = fb.fused_block_fwd(x, wt, *vectors, groups=groups).numpy()
    want = jax_fused(*(jnp.asarray(a) for a in arrays), groups=groups, nb=1, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL)


def test_bench_tool_on_the_cpu(capsys):
    records = bench_fused_block.main(["--device", "cpu", "--batch", "2", "--iters", "1"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == records
    shapes = [f"2x{h}x{w}x{ci}->{co}" for h, w, ci, co in bench_fused_block.SHAPES]
    for shape in shapes:
        lines = [r for r in records if r["shape"] == shape]
        by_variant = {r["variant"]: r for r in lines if "variant" in r}
        assert by_variant["cuda"] == {"shape": shape, "variant": "cuda", "skipped": "cpu"}
        for variant in ("plain", "block"):
            assert np.isfinite(by_variant[variant]["ms"]) and by_variant[variant]["ms"] > 0
            assert by_variant[variant]["device"] == "cpu"
        (diff,) = [r for r in lines if "variant" not in r]
        assert diff["max_abs_diff"] is None and np.isfinite(diff["block_max_abs_diff"])
        # the Block's bf16 conv output and bias round before the norm: a few
        # bf16 ulps of the O(1) outputs, never a different function
        assert diff["block_max_abs_diff"] <= 0.1 * diff["ref_abs_max"]


def test_bench_tool_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_fused_block.main(["--batch", "2", "--iters", "1"])
