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


# ----------------------------------------------------------------- DPM-Solver++
@pytest.fixture(scope="module")
def t1000():
    """igm_tpu's and the port's DDPM at T = 1000 (cosine), for the grids."""
    kw = dict(hidden_dim=8, dim_mults=(1,), timesteps=1000, compute_dtype="float32")
    return JaxDDPM(datamodule=to_node(DM), **kw), DDPM(datamodule=DM, device="cpu", **kw)


@pytest.mark.parametrize("steps", [3, 20, 50])
@pytest.mark.parametrize("schedule", ["uniform", "logsnr", "karras"])
def test_dpm_timesteps_equal_igm_tpu(t1000, schedule, steps):
    jm, tm = t1000
    want = jm._dpm_timesteps(steps, schedule)
    got = tm._dpm_timesteps(steps, schedule)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dpm_timesteps_refuse_an_unknown_schedule(t1000):
    with pytest.raises(ValueError, match="uniform|logsnr|karras, got 'cosine'"):
        t1000[1]._dpm_timesteps(10, "cosine")


def _x_T(rng, shape):
    """x_T as igm_tpu's deterministic samplers draw it."""
    init_rng, _ = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(init_rng, shape)))


@pytest.mark.parametrize("schedule,steps", [("uniform", 6), ("logsnr", 6), ("karras", 6),
                                            ("uniform", 30)])
def test_dpm_sample_matches_jax(uncond, schedule, steps):
    """Each grid; 30 uniform steps over T = 20 repeat timesteps, whose zero
    lambda gaps make the next step first order, as in igm_tpu."""
    jm, state, tm = uncond
    rng = jax.random.PRNGKey(21)
    want = np.asarray(jm.dpm_sample(state, rng, 2, steps=steps, schedule=schedule))
    got = tm.dpm_sample(2, steps=steps, schedule=schedule, x_T=_x_T(rng, (2, 8, 8, 3)))
    # as DDIM: the first steps divide the eps gap by sqrt(alphas_cumprod)
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=DDIM_RTOL)


@pytest.fixture(scope="module")
def cond():
    return _pair(num_classes=3, val_sampler="dpm", dpm_steps=5, sample_batch=3)


def test_dpm_sample_with_guidance_matches_jax(cond):
    jm, state, tm = cond
    rng = jax.random.PRNGKey(22)
    y = np.array([2, 0], np.int32)
    want = np.asarray(jm.dpm_sample(state, rng, 2, steps=5, y=jnp.asarray(y), guidance=3.0))
    got = tm.dpm_sample(2, steps=5, y=torch.from_numpy(y.astype(np.int64)), guidance=3.0,
                        x_T=_x_T(rng, (2, 8, 8, 3)))
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=DDIM_RTOL)


class _Draws:
    """Stands in for the port's ``_noise``: hands out igm_tpu's draws in
    order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape, generator):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.array(a))


def test_validation_step_with_dpm_matches_jax(cond, monkeypatch):
    """val_sampler=dpm: the diffused batch and dpm_steps samples of the
    class blocks under guidance_scale, with igm_tpu's draws replayed."""
    jm, state, tm = cond
    imgs = np.random.default_rng(8).integers(0, 256, (2, 8, 8, 3), np.uint8)
    batch = (imgs, np.zeros(2, np.int32))
    rng = jax.random.PRNGKey(23)
    want, _ = jm.validation_step(state, tuple(map(jnp.asarray, batch)), rng, sample=True)
    noise_rng, sample_rng = jax.random.split(rng)
    monkeypatch.setattr(tm, "_noise", _Draws([
        jax.random.normal(noise_rng, imgs.shape),
        jax.random.normal(jax.random.split(sample_rng)[0], (3, 8, 8, 3))]))
    got, _ = tm.validation_step(None, tuple(map(torch.from_numpy, batch)),
                                torch.Generator(), sample=True)
    np.testing.assert_allclose(got.others["diffusion"].numpy(),
                               np.asarray(want["others"]["diffusion"]), atol=ATOL, rtol=RTOL)
    assert got.fake_image.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(got.fake_image.numpy(), np.asarray(want["fake_image"]),
                               atol=DDIM_ATOL, rtol=DDIM_RTOL)


# ------------------------------------------------------ interpolate, inpaint
def _chain_noises(key, steps, shape):
    """The per-step draws of igm_tpu's p_sample_loop from its key."""
    _, key = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
    return out


@pytest.mark.parametrize("t", [None, 7])
def test_interpolate_matches_jax(uncond, t):
    """Both images diffused to t, lerped, denoised back from t_start = t
    (the chain's first step is t - 1, as in igm_tpu)."""
    jm, state, tm = uncond
    rng = np.random.default_rng(9)
    x1, x2 = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(24)
    want = np.asarray(jm.interpolate(state, key, jnp.asarray(x1), jnp.asarray(x2), t=t,
                                     weight=0.3))
    r1, r2, r3 = jax.random.split(key, 3)
    t_eff = T_STEPS - 1 if t is None else t
    got = tm.interpolate(
        torch.from_numpy(x1), torch.from_numpy(x2), t=t, weight=0.3,
        diffuse_noise=[torch.from_numpy(np.array(jax.random.normal(r, x1.shape)))
                       for r in (r1, r2)],
        noises=_chain_noises(r3, t_eff, x1.shape))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def repaint_draws(key, timesteps, resample, shape, known_shape=None):
    """x_T and the (reverse, known, forward) draws of igm_tpu's inpaint, per
    step t = T-1 .. 0 and pass u, from its key schedule."""
    init_rng, key = jax.random.split(key)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_rng, shape)))
    draws = []
    for _ in range(timesteps * max(resample, 1)):
        key, k_step, k_fwd = jax.random.split(key, 3)
        k_rev, k_known = jax.random.split(k_step)
        draws.append(tuple(torch.from_numpy(np.array(jax.random.normal(k, s)))
                           for k, s in ((k_rev, shape), (k_known, known_shape or shape),
                                        (k_fwd, shape))))
    return x_T, draws


@pytest.mark.parametrize("resample", [1, 2])
def test_inpaint_matches_jax(uncond, resample):
    jm, state, tm = uncond
    rng = np.random.default_rng(10)
    x0 = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    mask = np.ones((1, 8, 8, 1), np.float32)
    mask[:, 2:6, 3:7] = 0.0
    key = jax.random.PRNGKey(25)
    want = np.asarray(jm.inpaint(state, key, jnp.asarray(x0), jnp.asarray(mask),
                                 resample=resample))
    x_T, draws = repaint_draws(key, T_STEPS, resample, x0.shape)
    got = tm.inpaint(torch.from_numpy(x0), torch.from_numpy(mask), resample=resample,
                     x_T=x_T, draws=draws)
    known = torch.from_numpy(np.broadcast_to(mask, x0.shape) == 1)
    assert torch.equal(got[known], torch.from_numpy(x0)[known])       # bit for bit
    assert not torch.equal(got[~known], torch.from_numpy(x0)[~known])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_seeded_new_samplers_are_reproducible_and_finite(uncond):
    _, _, tm = uncond
    x = torch.rand(2, 8, 8, 3) * 2 - 1
    mask = torch.ones(1, 8, 8, 1)
    mask[:, :4] = 0
    for run in (lambda g: tm.dpm_sample(2, steps=4, generator=g),
                lambda g: tm.interpolate(x, x.flip(0), t=5, generator=g),
                lambda g: tm.inpaint(x, mask, resample=2, generator=g)):
        a, b = (run(torch.Generator().manual_seed(4)) for _ in range(2))
        assert a.shape == (2, 8, 8, 3) and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=0, rtol=0)
