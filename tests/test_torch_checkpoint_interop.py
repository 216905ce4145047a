"""igm_tpu's checkpoints in the port: a few igm_tpu train steps of tiny
ddpm/mnist (with an EMA shadow) and vqvae/mnist_ema (an EMA codebook in
the mutables), saved with orbax, converted by tools/igm_tpu_ckpt_to_npz.py
and read by the port through --ckpt, model.first_stage_ckpt and
model.teacher_ckpt.

Tolerances: float32 forwards within 1e-5 (tests/test_torch_ddpm.py); the
latent first stage within 1e-5 of the output's largest magnitude
(tests/test_torch_latent_ddpm.py); DDIM chains within 1e-3.  A DDIM
chain's first step divides the denoiser's float32 gap (2.6e-6 to 3.5e-6 at
|eps| ~ 2.3 on these 28x28 trained weights) by sqrt(alphas_cumprod[19]) =
2.5e-3 (x406) on the way to x0, and the x0 clip absorbs it only where it
binds: up to 1.4e-3 on an element it does not reach (observed 2.5e-4 to
3.2e-4 over three seeds; tests/test_torch_ddpm.py's 1e-4 holds 384
elements of an untrained net at 8x8x3).
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.config import compose as jax_compose  # noqa: E402
from igm_tpu.config import instantiate as jax_instantiate  # noqa: E402
from igm_tpu.core.checkpoint import CheckpointManager as OrbaxManager  # noqa: E402
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.core.checkpoint import (CONVERTED_FORMAT, read_checkpoint,  # noqa: E402
                                           read_converted)
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from tools.igm_tpu_ckpt_to_npz import FORMAT, convert  # noqa: E402

torch.set_num_threads(1)

CONFIGS = REPO / "configs"
RTOL = ATOL = 1e-5
DDIM_ATOL = DDIM_RTOL = 1e-3
T_STEPS = 20
UNET = ["model.hidden_dim=8", "model.dim_mults=[1,2]", f"model.timesteps={T_STEPS}",
        "+model.compute_dtype=float32"]
DDPM = ["experiment=ddpm/mnist", *UNET, "+model.ema_decay=0.9"]
VQ = ["model.latent_dim=8", "model.num_embeddings=16", "+networks.encoder.res_h_dim=8",
      "+networks.decoder.h_dim=8", "+networks.decoder.res_h_dim=8"]
VQVAE = ["experiment=vqvae/mnist_ema", *VQ]
LATENT = ["experiment=latent_ddpm/mnist", *VQ, "model.hidden_dim=8", "model.dim_mults=[1]",
          f"model.timesteps={T_STEPS}", "+model.compute_dtype=float32",
          "+model.codebook_update=ema", "model.latent_scale=1.7"]
DISTILL = ["experiment=distill/mnist", *UNET, "model.student_steps=4"]


def _flatten(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_model(overrides):
    cfg = jax_compose(CONFIGS, [*overrides, "print_config=False"])
    model = jax_instantiate(cfg.model, datamodule=cfg.datamodule)
    model.steps_per_epoch = 1
    return model


def _port_cfg(overrides):
    return compose(CONFIGS, [*overrides, "print_config=False"])


def _train_and_save(overrides, directory: Path, steps: int = 2):
    """igm_tpu's model after ``steps`` train steps on random digits, saved
    with orbax in ``directory``."""
    jm = _jax_model(overrides)
    state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    step = jax.jit(jm.train_step)
    for _ in range(steps):
        imgs = rng.integers(0, 256, (4, 28, 28, 1), np.uint8)
        state, _ = step(state, (jnp.asarray(imgs), jnp.zeros((4,), jnp.int32)))
    mgr = OrbaxManager(str(directory))
    mgr.save(steps, state)
    mgr.close()
    return jm, state


@pytest.fixture(scope="module")
def ddpm(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddpm")
    jm, state = _train_and_save(DDPM, root / "orbax")
    arrays = convert(str(root / "orbax"), str(root / "ddpm.npz"))
    return jm, state, root, arrays


@pytest.fixture(scope="module")
def vqvae(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqvae")
    _, state = _train_and_save(VQVAE, root / "orbax")
    convert(str(root / "orbax"), str(root / "vqvae.npz"))
    return state, root


def test_converter_writes_params_mutables_ema_and_step(ddpm, vqvae):
    _, state, root, arrays = ddpm
    assert FORMAT == CONVERTED_FORMAT and str(arrays["format"]) == FORMAT
    assert int(arrays["step"]) == 2
    want = _flatten(state.params)
    assert {k[len("params/"):] for k in arrays if k.startswith("params/")} == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[f"params/{k}"], v)
    ema = _flatten(state.opt_states["ema"])
    assert {k[len("ema/"):] for k in arrays if k.startswith("ema/")} == set(ema)
    assert not any(k.startswith("opt_states") or k.startswith("rng") for k in arrays)
    raw = read_converted(root / "ddpm.npz")
    assert raw["step"] == 2 and raw["converted"]
    assert set(raw["opt_states"]) == {"ema"}
    vq_state, vq_root = vqvae
    vq_raw = read_checkpoint(vq_root / "vqvae.npz")
    np.testing.assert_array_equal(vq_raw["params"]["vq.cluster_size"].numpy(),
                                  np.asarray(vq_state.mutables["vq"]["codebook"]["cluster_size"]))


def test_ddpm_forward_and_ddim_from_ckpt_npz(ddpm, tmp_path):
    """cli.load_model (the CLIs' --ckpt) on the converted file: the EMA
    shadow's denoiser and a seeded DDIM chain equal igm_tpu's."""
    jm, state, root, _ = ddpm
    model = cli.load_model(_port_cfg(DDPM), torch.device("cpu"), ckpt=str(root / "ddpm.npz"))
    assert model.state.step == 2
    ema = flax_to_torch(_flatten(state.opt_states["ema"]))
    for k, v in model.state.opt_states["ema"].items():
        assert torch.equal(v, ema[k]), k
    x = np.random.default_rng(2).normal(size=(2, 28, 28, 1)).astype(np.float32)
    t = np.array([3.0, 11.0], np.float32)
    want = np.asarray(jax.jit(jm._denoise)(state, jnp.asarray(x), jnp.asarray(t)))
    got = model._denoise(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(functools.partial(jm.ddim_sample, n=2, steps=4))(state, rng))
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0], (2, 28, 28, 1)))
    got = model.ddim_sample(2, steps=4, x_T=torch.from_numpy(x_T)).numpy()
    np.testing.assert_allclose(got, want, atol=DDIM_ATOL, rtol=DDIM_RTOL)
    imgs = cli.sample_main([*DDPM, "--ckpt", str(root / "ddpm.npz"), "--sampler", "ddim",
                            "--steps", "2", "--n", "2", "--device", "cpu",
                            "--out", str(tmp_path / "g.png")])
    assert imgs.shape == (2, 28, 28, 1) and torch.isfinite(imgs).all()
    assert (tmp_path / "g.png").exists()


def test_latent_first_stage_from_npz(vqvae):
    """LatentDDPM with first_stage_ckpt=x.npz against igm_tpu's with the
    orbax directory: the spliced codebook (EMA buffers), encode and
    decode."""
    _, root = vqvae
    jl = _jax_model([*LATENT, f"model.first_stage_ckpt={root / 'orbax'}"])
    jstate = jax.jit(jl.init_state)(jax.random.PRNGKey(0))  # reads the orbax files once
    cfg = _port_cfg([*LATENT, f"model.first_stage_ckpt={root / 'vqvae.npz'}"])
    tl = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    tl.init_state(0)
    for k, v in _flatten(jstate.mutables["vq"]["codebook"]).items():
        assert torch.equal(tl.modules["vq"].state_dict()[k], torch.from_numpy(np.array(v))), k
    imgs = np.random.default_rng(3).integers(0, 256, (3, 28, 28, 1), np.uint8)
    x = jl.preprocess(jnp.asarray(imgs))
    want_z = np.asarray(jax.jit(jl.encode)(jstate, x))
    got_z = tl.encode(torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=RTOL * np.abs(want_z).max())
    want = np.asarray(jax.jit(jl.decode)(jstate, jnp.asarray(want_z)))
    got = tl.decode(torch.from_numpy(want_z.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_distill_teacher_from_npz(ddpm):
    """distill/mnist with teacher_ckpt=x.npz against igm_tpu's with the
    orbax directory: teacher and student start from the teacher's EMA
    shadow; the student's sampler agrees."""
    _, _, root, _ = ddpm
    jd = _jax_model([*DISTILL, f"model.teacher_ckpt={root / 'orbax'}"])
    jstate = jax.jit(jd.init_state)(jax.random.PRNGKey(0))  # reads the orbax files once
    cfg = _port_cfg([*DISTILL, f"model.teacher_ckpt={root / 'ddpm.npz'}"])
    td = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    tstate = td.init_state(0)
    want = flax_to_torch(_flatten(jstate.opt_states["teacher"]))
    for k, p in td.modules["denoise"].named_parameters():
        assert torch.equal(tstate.opt_states["teacher"][k], want[k]), k
        assert torch.equal(p.detach(), want[k]), k
    rng = jax.random.PRNGKey(11)
    want_s = np.asarray(jax.jit(functools.partial(jd.student_sample, n=2))(jstate, rng))
    got_s = td.student_sample(2, noises=[torch.from_numpy(
        np.array(jax.random.normal(rng, (2, 28, 28, 1))))]).numpy()
    np.testing.assert_allclose(got_s, want_s, atol=DDIM_ATOL * np.abs(want_s).max(),
                               rtol=DDIM_RTOL)


def test_resume_from_npz_refuses_and_orbax_dirs_name_the_converter(ddpm, tmp_path,
                                                                 monkeypatch):
    _, _, root, _ = ddpm
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="no optimizer state"):
        cli.train_main([*DDPM, "trainer.max_epochs=1", "trainer.limit_train_batches=1",
                        "logger=null", f"datamodule.data_dir={tmp_path / 'data'}",
                        f"trainer.resume={root / 'ddpm.npz'}", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="igm_tpu_ckpt_to_npz"):
        cli.load_model(_port_cfg(DDPM), torch.device("cpu"), ckpt=str(root / "orbax"))
    np.savez(tmp_path / "other.npz", x=np.zeros(2))
    with pytest.raises(ValueError, match="not a converted igm_tpu checkpoint"):
        read_checkpoint(tmp_path / "other.npz")
