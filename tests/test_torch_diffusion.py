"""The port's diffusion tables and transition helpers against igm_tpu's."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from igm_tpu.ops import diffusion as jgd  # noqa: E402
from igm_tpu_torch.ops import diffusion as tgd  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("timesteps", [1000, 100])
def test_tables_bit_equal(schedule, timesteps):
    want = jgd.make_tables(timesteps, schedule)
    got = tgd.make_tables(timesteps, schedule)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_transition_helpers_match():
    rng = np.random.default_rng(0)
    shape = (4, 8, 8, 3)
    x0, xt, noise, v = (rng.normal(size=shape).astype(np.float32)
                        for _ in range(4))
    t = np.array([0, 1, 500, 999], np.int32)
    jt, tt = jgd.make_tables(1000), tgd.make_tables(1000)
    J = lambda *a: [jnp.asarray(b) for b in a]  # noqa: E731
    T = lambda *a: [torch.from_numpy(b) for b in a]  # noqa: E731
    tl = torch.from_numpy(t.astype(np.int64))
    pairs = [
        (jgd.q_sample(jt, *J(x0), jnp.asarray(t), *J(noise)),
         tgd.q_sample(tt, *T(x0), tl, *T(noise))),
        (jgd.predict_start_from_noise(jt, *J(xt), jnp.asarray(t), *J(noise)),
         tgd.predict_start_from_noise(tt, *T(xt), tl, *T(noise))),
        (jgd.eps_from_v(jt, *J(xt), jnp.asarray(t), *J(v)),
         tgd.eps_from_v(tt, *T(xt), tl, *T(v))),
    ]
    jpost = jgd.q_posterior(jt, *J(x0, xt), jnp.asarray(t))
    tpost = tgd.q_posterior(tt, *T(x0, xt), tl)
    pairs += list(zip(jpost, tpost))
    for want, got in pairs:
        # same float32 products and sums, in the same order
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)
