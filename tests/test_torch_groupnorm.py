"""The port's GroupNorm+Mish (igm_tpu_torch.ops.groupnorm) against igm_tpu's
reference and its Pallas kernel in interpret mode.

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

from igm_tpu.networks.unet import mish as flax_mish  # noqa: E402
from igm_tpu.ops.pallas_groupnorm import (  # noqa: E402
    group_norm_mish as pallas_group_norm_mish, reference_group_norm_mish)
from igm_tpu_torch.ops.groupnorm import (  # noqa: E402
    group_norm_mish, group_norm_mish_plain, mish)

torch.set_num_threads(1)

# float32, same one-pass statistics on both sides; sums in another order
ATOL = 1e-5


def _data(seed, n, h, w, c):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, gamma, beta


# the last two: the latent UNet's GroupNorm+Mish shapes (8x8x64, 4x4x128)
SHAPES = [(2, 8, 8, 32, 8), (3, 4, 4, 64, 8), (2, 4, 8, 16, 4), (1, 8, 8, 64, 8),
          (2, 4, 4, 128, 8)]


@pytest.mark.parametrize("n,h,w,c,groups", SHAPES)
def test_plain_matches_reference(n, h, w, c, groups):
    x, gamma, beta = _data(0, n, h, w, c)
    want = reference_group_norm_mish(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), groups)
    got = group_norm_mish_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                torch.from_numpy(beta), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("n,h,w,c,groups", SHAPES[:2])
def test_plain_matches_pallas_interpret(n, h, w, c, groups):
    x, gamma, beta = _data(1, n, h, w, c)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_group_norm_mish(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta), groups)
    got = group_norm_mish_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                torch.from_numpy(beta), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    x, gamma, beta = (torch.from_numpy(a) for a in _data(2, 2, 4, 4, 32))
    before = group_norm_mish.launches
    got = group_norm_mish(x, gamma, beta, 8)
    assert group_norm_mish.launches == before
    torch.testing.assert_close(got, group_norm_mish_plain(x, gamma, beta, 8),
                               atol=0, rtol=0)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(2, 4, 4, 30)
    with pytest.raises(ValueError):
        group_norm_mish(x, torch.ones(30), torch.zeros(30), 8)
    with pytest.raises(ValueError):
        group_norm_mish(torch.zeros(2, 4, 32), torch.ones(32), torch.zeros(32), 8)


def test_mish_matches_jax_including_large_inputs():
    """The stable softplus max(y,0) + log1p(exp(-|y|)) agrees with
    jax.nn.softplus at both tails, where a naive log(1 + exp(y)) overflows."""
    y = np.array([-100.0, -30.0, -5.0, -1e-3, 0.0, 1e-3, 5.0, 30.0, 100.0],
                 np.float32)
    got = mish(torch.from_numpy(y)).numpy()
    want = np.asarray(flax_mish(jnp.asarray(y)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_plain_bf16_rounds_the_f32_result():
    """bf16 in -> bf16 out, with the statistics in f32: the output is the
    f32 computation on the bf16 input, rounded once."""
    x, gamma, beta = _data(3, 2, 4, 4, 32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = group_norm_mish_plain(xb, torch.from_numpy(gamma), torch.from_numpy(beta))
    want = group_norm_mish_plain(xb.float(), torch.from_numpy(gamma),
                                 torch.from_numpy(beta)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)
