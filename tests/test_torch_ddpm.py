"""The port's DDPM samplers against igm_tpu's, at a tiny size.

Both models hold the same denoiser weights (Flax init, perturbed, converted
through igm_tpu_torch.interop); every random draw is made on the JAX side,
exactly as igm_tpu's sampler makes it, and handed to the port.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models.ddpm import DDPM as JaxDDPM  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.ddpm import DDPM  # noqa: E402

torch.set_num_threads(1)

DM = {"width": 8, "height": 8, "channels": 3,
      "transforms": {"convert": True, "normalize": True}}
T_STEPS = 20
# float32; each sampler step adds a few ulps of the UNet gap (test_torch_unet)
# through the O(1) update coefficients
ATOL = RTOL = 1e-5
# DDIM's first step divides the eps gap by sqrt(alphas_cumprod[19]) = 2.5e-3
# (x406) on the way to x0; the clip to [-1, 1] absorbs most of it, not all
# (observed 2.5e-5 on one element of 384)
DDIM_ATOL = DDIM_RTOL = 1e-4


def _flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(**kw):
    kw = dict(hidden_dim=16, dim_mults=(1, 2), timesteps=T_STEPS,
              compute_dtype="float32", **kw)
    jm = JaxDDPM(datamodule=to_node(DM), **kw)
    jm.steps_per_epoch = 1
    state = jm.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        state.params["denoise"])
    state = state.replace(params={"denoise": params})
    tm = DDPM(datamodule=DM, device="cpu", **kw)
    tm.modules["denoise"].load_state_dict(flax_to_torch(_flatten(params)),
                                          strict=True)
    return jm, state, tm


@pytest.fixture(scope="module")
def uncond():
    return _pair()


def test_ddim_eta0_matches_jax(uncond):
    jm, state, tm = uncond
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jm.ddim_sample(state, rng, 2, steps=5))
    init_rng, _ = jax.random.split(rng)          # as ddim_sample draws x_T
    x_T = np.asarray(jax.random.normal(init_rng, (2, 8, 8, 3)))
    got = tm.ddim_sample(2, steps=5, x_T=torch.from_numpy(x_T.copy())).numpy()
    np.testing.assert_allclose(got, want, atol=DDIM_ATOL, rtol=DDIM_RTOL)


def test_p_sample_step_matches_jax(uncond):
    jm, state, tm = uncond
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 7, 19], np.int32)           # t=0 takes no noise
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.p_sample(state, jnp.asarray(x), jnp.asarray(t), key))
    noise = np.array(jax.random.normal(key, x.shape))
    got = tm.p_sample(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                      noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_ancestral_chain_matches_jax(uncond):
    """The whole T-step chain, with igm_tpu's key schedule replayed to
    inject the same x_T and per-step noise."""
    jm, state, tm = uncond
    rng = jax.random.PRNGKey(11)
    shape = (2, 8, 8, 3)
    want = np.asarray(jm.p_sample_loop(state, rng, shape))
    init_rng, key = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init_rng, shape))
    noises = []
    for _ in range(T_STEPS):
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
    got = tm.p_sample_loop(shape, init_x=torch.from_numpy(x_T),
                           noises=noises).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("num_classes,param", [(3, "eps"), (0, "v")])
def test_eps_cfg_and_v_conversion_match_jax(num_classes, param):
    """Classifier-free guidance as one doubled batch, and the v -> eps
    conversion, through _eps."""
    jm, state, tm = _pair(num_classes=num_classes, parameterization=param)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([5.0, 13.0], np.float32)
    y = np.array([0, 2], np.int32) if num_classes else None
    want = np.asarray(jm._eps(state, jnp.asarray(x), jnp.asarray(t),
                              None if y is None else jnp.asarray(y), 2.0))
    got = tm._eps(torch.from_numpy(x), torch.from_numpy(t),
                  None if y is None else torch.from_numpy(y.astype(np.int64)),
                  2.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_seeded_samplers_are_reproducible_and_finite():
    tm = DDPM(datamodule=DM, hidden_dim=16, dim_mults=(1, 2),
              timesteps=T_STEPS, device="cpu")
    assert tm.compute_dtype == torch.float32      # "auto" on the CPU
    runs = [tm.ddim_sample(2, steps=4, eta=1.0,
                           generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert runs[0].shape == (2, 8, 8, 3) and torch.isfinite(runs[0]).all()
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)


def test_preprocess_matches_jax():
    """uint8 NHWC -> [-1, 1] float32 on the model's device, as igm_tpu's."""
    imgs = np.random.default_rng(6).integers(0, 256, (2, 8, 8, 3), np.uint8)
    jm = JaxDDPM(datamodule=to_node(DM), hidden_dim=8, dim_mults=(1,),
                 timesteps=4, compute_dtype="float32")
    tm = DDPM(datamodule=DM, hidden_dim=8, dim_mults=(1,), timesteps=4,
              device="cpu")
    got = tm.preprocess(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.preprocess(jnp.asarray(imgs))))
