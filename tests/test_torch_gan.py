"""The port's GAN (vanilla, LSGAN, hinge) and speed_gan against igm_tpu's,
at a tiny size: one train step of each phase (GAN's G branch at step 0,
its D branch at step 1; speed_gan's shared forward and both updates) on
the same Flax weights (perturbed), moved BatchNorm statistics and
igm_tpu's own z, through 8x8 MLP networks and 32x32 conv networks
(ndf = ngf = 4).  tests/_torch_gan.py holds what is compared."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_gan import BATCH, batch, check_step, conv32, mlp, setup, t  # noqa: E402
from igm_tpu.models.gan import GAN as JaxGAN  # noqa: E402
from igm_tpu.models.speed_gan import GAN as JaxSpeedGAN  # noqa: E402
from igm_tpu_torch.models.gan import GAN  # noqa: E402
from igm_tpu_torch.models.speed_gan import GAN as SpeedGAN  # noqa: E402

torch.set_num_threads(1)

LATENT = 6
LR = dict(lrG=1e-3, lrD=2e-3)
BOUNDS = {"g": 1e-3, "d": 2e-3}


def _z(state):
    _, rng = state.next_rng()
    return {"z": t(jax.random.normal(rng, (BATCH, LATENT)))}


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "hinge"])
@pytest.mark.parametrize("step", [0, 1], ids=["g", "d"])
def test_gan_train_step_matches_igm_tpu(mode, step):
    nets = conv32() if mode == "vanilla" else mlp()
    jm, state, tm, tstate = setup(JaxGAN, GAN, nets, latent_dim=LATENT, loss_mode=mode, **LR)
    imgs, labels = batch(nets, 10 + step)
    _, metrics, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels, BOUNDS,
                                           draws=_z(state), step=step)
    assert rec.order == (["g"] if step == 0 else ["d"])
    ran = "train_loss/g_loss" if step == 0 else "train_loss/d_loss"
    assert [k for k, v in tmetrics.items() if not torch.isnan(v)] == (
        [ran] if step == 0 else [ran, "train_log/pred_real", "train_log/pred_fake"])


@pytest.mark.parametrize("nets", [mlp(), conv32()], ids=["mlp", "conv32"])
def test_speed_gan_train_step_matches_igm_tpu(nets):
    jm, state, tm, tstate = setup(JaxSpeedGAN, SpeedGAN, nets, latent_dim=LATENT, **LR)
    imgs, labels = batch(nets, 12)
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels, BOUNDS,
                                     draws=_z(state))
    assert rec.order == ["g", "d"]
    assert all(np.isfinite(float(v)) for v in tmetrics.values())


def test_gan_validation_and_sample_match_igm_tpu():
    nets = mlp()
    jm, state, tm, tstate = setup(JaxGAN, GAN, nets, latent_dim=LATENT)
    imgs, labels = batch(nets, 13)
    rng = jax.random.PRNGKey(4)
    result, _ = jm.validation_step(state, (imgs, labels), rng)
    z = t(jax.random.normal(rng, (BATCH, LATENT)))
    np.testing.assert_allclose(tm.forward(tstate, z).numpy(), np.asarray(result["fake_image"]),
                               rtol=1e-5, atol=1e-5)
    res, metrics = tm.validation_step(tstate, (t(imgs), t(labels)),
                                      torch.Generator().manual_seed(3))
    assert metrics == {} and res.fake_image.shape == (BATCH, 8, 8, 1)
    np.testing.assert_allclose(res.real_image.numpy(), np.asarray(result["real_image"]))
    got = tm.sample(5, torch.Generator().manual_seed(4))
    z = torch.randn((5, LATENT), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, tm.forward(tstate, z))
    assert tm.weights_module == tm.decoder_module_name == "netG" and tm.phase_period == 2
