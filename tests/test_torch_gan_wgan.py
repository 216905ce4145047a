"""The port's WGAN (weight clipping, RMSprop) and WGAN-GP (gradient
penalty) against igm_tpu's, at a tiny size: WGAN's G branch at step 0 and
its D branch at step 1 through 8x8 MLP networks, with weights perturbed
beyond the clip (0.01), so that the clamp at the start of the step
changes them (the critic layer-normed: behind a BatchNorm whose scale is
clamped to 0.01, the batch mean of the nearly linear critic hardly
depends on its input, and its gradients are rounding noise of 1e-12);
WGAN-GP's D branch (the penalty, a gradient of a gradient) at step 0 and
its G branch at step n_critic through 32x32 conv networks (ndf = ngf = 4,
layer-normed whatever the config says, as igm_tpu builds them).
tests/_torch_gan.py holds what is compared."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_gan import BATCH, batch, check_step, conv32, mlp, setup, t  # noqa: E402
from igm_tpu.models.wgan import WGAN as JaxWGAN  # noqa: E402
from igm_tpu.models.wgan_gp import WGAN as JaxWGANGP  # noqa: E402
from igm_tpu_torch.models.wgan import WGAN  # noqa: E402
from igm_tpu_torch.models.wgan_gp import WGAN as WGANGP  # noqa: E402

torch.set_num_threads(1)

LATENT, N_CRITIC = 6, 2
WGAN_KW = dict(latent_dim=LATENT, n_critic=N_CRITIC, lrG=2e-4, lrD=2e-4, clip_weight=0.01)
# RMSprop's first update moves a parameter by lr * g / sqrt((1 - alpha) g^2 +
# eps): at most lr / sqrt(1 - alpha) = 10 lr
WGAN_BOUNDS = {"g": 2e-3, "d": 2e-3}
GP_KW = dict(latent_dim=LATENT, n_critic=N_CRITIC, lrG=1e-3, lrD=1e-3)
GP_BOUNDS = {"g": 1e-3, "d": 1e-3}


@pytest.mark.parametrize("step", [0, 1], ids=["g", "d"])
def test_wgan_train_step_matches_igm_tpu(step):
    nets = mlp(enc_norm="layer")
    jm, state, tm, tstate = setup(JaxWGAN, WGAN, nets, **WGAN_KW)
    before = np.abs(np.concatenate([p.detach().numpy().ravel()
                                    for p in tm.modules["netD"].parameters()]))
    assert (before > 0.01).mean() > 0.3                  # the clip is active
    imgs, labels = batch(nets, 20 + step)
    _, rng = state.replace(step=step).next_rng()
    draws = {"z": t(jax.random.normal(rng, (BATCH, LATENT)))}
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels, WGAN_BOUNDS,
                                     draws=draws, step=step)
    assert rec.order == (["g"] if step == 0 else ["d"])
    assert {type(o).__name__ for o in tstate.opt_states.values()} == {"RMSprop"}
    assert np.isnan(float(tmetrics["train_loss/d_loss" if step == 0 else "train_loss/g_loss"]))


def test_wgan_clips_netd_in_both_phases():
    """From weights beyond the clip: after a G step (netD not updated)
    every netD parameter lies within +-clip_weight."""
    nets = mlp()
    tm = WGAN(datamodule=nets["dm"], netG=nets["decoder"], netD=nets["encoder"],
              device="cpu", **WGAN_KW)
    tstate = tm.init_state(0)
    with torch.no_grad():
        for p in tm.modules.parameters():
            p.mul_(10.0)
    imgs, labels = batch(nets, 22)
    tstate, _ = tm.train_step(tstate, (t(imgs), t(labels)))
    assert all(float(p.detach().abs().max()) <= 0.01 for p in tm.modules["netD"].parameters())
    assert max(float(p.detach().abs().max()) for p in tm.modules["netG"].parameters()) > 0.01
    assert tm.phase_period == N_CRITIC + 1


@pytest.mark.parametrize("step", [0, N_CRITIC], ids=["d", "g"])
def test_wgan_gp_train_step_matches_igm_tpu(step):
    nets = conv32()
    jm, state, tm, tstate = setup(JaxWGANGP, WGANGP, nets, **GP_KW)
    assert all(type(m).__name__ != "BatchNorm" for m in tm.modules.modules())
    imgs, labels = batch(nets, 24 + step)
    _, (z_rng, lerp_rng) = state.replace(step=step).next_rng(2)
    draws = {"z": t(jax.random.normal(z_rng, (BATCH, LATENT))),
             "lerp": t(jax.random.uniform(lerp_rng, (BATCH, 1, 1, 1)))}
    _, metrics, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels, GP_BOUNDS,
                                           draws=draws, step=step)
    assert rec.order == (["d"] if step == 0 else ["g"])
    gp = float(tmetrics["train_log/gradient_panelty"])
    assert np.isnan(gp) == (step == N_CRITIC)
    if step == 0:                 # held to igm_tpu's with the other metrics
        assert gp > 0
