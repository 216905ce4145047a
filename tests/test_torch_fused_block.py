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
    """The groups the kernel's block cannot hold are refused before a launch,
    with the limit in the message; the flagship levels fit."""
    with pytest.raises(ValueError, match=limit):
        fb._check_fits(h, w, cout, groups)
    for h, w, _, c in bench_fused_block.SHAPES:
        fb._check_fits(h, w, c, 8)


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
