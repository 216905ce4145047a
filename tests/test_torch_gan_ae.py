"""The port's VAE-GAN, AAE and AGE against igm_tpu's, at a tiny size (8x8
MLP networks, widths 12-16, batch-normed; AAE also on 28x28 MNIST conv
networks): one train step of each (VAE-GAN's three gradients from one
forward; AAE's three updates, ``g`` twice, with the normal prior and with
the toy mixture; AGE's E branch at step 0 and its G branch at step 1, with
every loss term on), igm_tpu's draws injected; tests/_torch_gan.py holds
what is compared.  Then VAE-GAN's and AAE's validation outputs and
ToyGMM's density."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_gan import BATCH, batch, check_step, close, conv_mnist, mlp, setup, t  # noqa: E402
from igm_tpu.models.aae import AAE as JaxAAE  # noqa: E402
from igm_tpu.models.age import AGE as JaxAGE  # noqa: E402
from igm_tpu.models.vae_gan import VAEGAN as JaxVAEGAN  # noqa: E402
from igm_tpu.utils.toy import ToyGMM as JaxToyGMM  # noqa: E402
from igm_tpu_torch.models.aae import AAE  # noqa: E402
from igm_tpu_torch.models.age import AGE, calculate_kl  # noqa: E402
from igm_tpu_torch.models.vae_gan import VAEGAN  # noqa: E402
from igm_tpu_torch.utils.toy import ToyGMM  # noqa: E402

torch.set_num_threads(1)

LATENT = 4
NAMES = ("decoder", "encoder")
VAEGAN_KW = dict(latent_dim=LATENT, lr=1e-3, recon_weight=0.3, loss_mode="lsgan")
AAE_KW = dict(lrG=1e-3, lrD=2e-3, recon_weight=2.0)
AGE_KW = dict(latent_dim=LATENT, lrE=1e-3, lrG=2e-3, e_recon_z_weight=2.0,
              e_recon_x_weight=3.0, g_recon_z_weight=4.0, g_recon_x_weight=5.0,
              drop_lr_epoch=2, g_updates=2)


def test_vae_gan_train_step_matches_igm_tpu():
    nets = mlp()
    jm, state, tm, tstate = setup(JaxVAEGAN, VAEGAN, nets, names=NAMES, **VAEGAN_KW)
    _, (vae_rng, prior_rng) = state.next_rng(2)
    draws = {"eps": t(jax.random.normal(vae_rng, (BATCH, LATENT))),
             "prior_z": t(jax.random.normal(prior_rng, (BATCH, LATENT)))}
    imgs, labels = batch(nets, 40)
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels,
                                     {"ae": 1e-3, "d": 1e-3}, draws=draws)
    assert rec.order == ["ae", "d"]
    assert len(tmetrics) == 7


def test_vae_gan_validation_matches_igm_tpu():
    nets = mlp()
    jm, state, tm, tstate = setup(JaxVAEGAN, VAEGAN, nets, names=NAMES, **VAEGAN_KW)
    imgs, labels = batch(nets, 41)
    rng = jax.random.PRNGKey(6)
    result, metrics = jm.validation_step(state, (imgs, labels), rng)
    vae_rng, sample_rng = jax.random.split(rng)
    eps = t(jax.random.normal(vae_rng, (BATCH, LATENT)))
    with torch.no_grad():
        _, _, z, recon = tm._vae(tm.preprocess(t(imgs)), eps, train=False)
    close(z.numpy(), result["encode_latent"])
    close(recon.numpy(), result["recon_image"])
    fake = tm.forward(tstate, t(jax.random.normal(sample_rng, (BATCH, LATENT))))
    close(fake.numpy(), result["fake_image"])
    _, tmetrics = tm.validation_step(tstate, (t(imgs), t(labels)),
                                     torch.Generator().manual_seed(1))
    assert set(tmetrics) == set(metrics) == {"val_log/van_mse"}


@pytest.mark.parametrize("prior,nets", [("normal", conv_mnist()), ("toy_gmm", mlp())],
                         ids=["normal-conv", "toy_gmm-mlp"])
def test_aae_train_step_matches_igm_tpu(prior, nets):
    latent = 2 if prior == "toy_gmm" else LATENT
    jm, state, tm, tstate = setup(JaxAAE, AAE, nets, names=NAMES, latent_dim=latent,
                                  prior=prior, **AAE_KW)
    _, prior_rng = state.next_rng()
    imgs, labels = batch(nets, 42)
    _, _, _, rec = check_step(jm, state, tm, tstate, imgs, labels, {"g": 1e-3, "d": 2e-3},
                              draws={"real_prior": t(jm.sample_prior(prior_rng, BATCH))})
    assert rec.order == ["g", "d", "g"] and tstate.counts == {"g": 2, "d": 1}
    # the second g update is Adam's second step: its bias correction counts 2
    opt = tstate.opt_states["g"]
    assert {int(st["step"]) for st in opt.state.values()} == {2}


def test_aae_validation_matches_igm_tpu():
    nets = mlp()
    jm, state, tm, tstate = setup(JaxAAE, AAE, nets, names=NAMES, latent_dim=LATENT,
                                  **AAE_KW)
    imgs, labels = batch(nets, 43)
    result, _ = jm.validation_step(state, (imgs, labels), jax.random.PRNGKey(7))
    res, _ = tm.validation_step(tstate, (t(imgs), t(labels)), torch.Generator().manual_seed(2))
    close(res.encode_latent.numpy(), result["encode_latent"])
    close(res.recon_image.numpy(), result["recon_image"])
    assert res.fake_image.shape == res.recon_image.shape == (BATCH, 8, 8, 1)


@pytest.mark.parametrize("step", [0, 1], ids=["e", "g"])
def test_age_train_step_matches_igm_tpu(step):
    nets = mlp()
    jm, state, tm, tstate = setup(JaxAGE, AGE, nets, names=NAMES, **AGE_KW)
    _, rng = state.replace(step=step).next_rng()
    imgs, labels = batch(nets, 44 + step)
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels,
                                     {"e": 1e-3, "g": 2e-3},
                                     draws={"z": t(jax.random.normal(rng, (BATCH, LATENT)))},
                                     step=step)
    assert rec.order == (["e"] if step == 0 else ["g"])
    finite = {k for k, v in tmetrics.items() if np.isfinite(float(v))}
    assert finite == ({"train_loss/g_recon_z", "train_loss/g_loss"} if step else
                      set(tmetrics) - {"train_loss/g_recon_z", "train_loss/g_loss"})


def test_age_kl_matches_igm_tpu():
    from igm_tpu.models.age import calculate_kl as jax_kl
    x = np.random.default_rng(46).normal(size=(8, 5)).astype(np.float32) * 0.7 + 0.2
    for got, want in zip(calculate_kl(torch.from_numpy(x)), jax_kl(jnp.asarray(x))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_toy_gmm_matches_igm_tpu():
    """The density at points near and between the components, and samples
    from given components and noise."""
    jax_gmm, gmm = JaxToyGMM(10), ToyGMM(10)
    np.testing.assert_array_equal(gmm.chols, jax_gmm.chols)
    x = np.random.default_rng(47).normal(size=(64, 2)).astype(np.float32)
    np.testing.assert_allclose(gmm.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gmm.log_prob(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    key = jax.random.PRNGKey(8)
    want, comps = jax_gmm.sample(key, 32)
    _, z_rng = jax.random.split(key)
    eps = t(jax.random.normal(z_rng, (32, 2)))
    np.testing.assert_allclose(gmm.sample_from(t(comps).long(), eps).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    samples, labels = gmm.sample(4096, torch.Generator().manual_seed(0))
    assert samples.shape == (4096, 2) and set(labels.tolist()) == set(range(10))
    np.testing.assert_allclose(float(samples.norm(dim=1).mean()), 1.0, atol=0.05)
