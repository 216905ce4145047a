"""The port's BiGAN and InfoGAN against igm_tpu's, at a tiny size.

BiGAN: one train step (the shared forward, the G update of encoder and
decoder, the D update of the joint discriminator) over an 8x8 MLP encoder
and over a 32x32 conv encoder (ndf = ngf = 4, hidden_dim 8): the
discriminator's sub-networks carry Flax's automatic names, which differ
between the two (``MLPEncoder_0``, ``Encoder_0``, ``MLPEncoder_1`` against
``MLPEncoder_0``..``MLPEncoder_2``), and igm_tpu's parameter tree maps
onto them through interop.  InfoGAN: one train step (G with the mutual
information terms, then D, one latent for both) on 28x28 MNIST conv
networks (ndf = ngf = 4, encode_dim 16).  tests/_torch_gan.py holds what
is compared."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_gan import (BATCH, _flatten, batch, check_step, close, conv32,  # noqa: E402
                        conv_mnist, mlp, setup, t)
from igm_tpu.models.BiGAN import BiGAN as JaxBiGAN  # noqa: E402
from igm_tpu.models.info_gan import InfoGAN as JaxInfoGAN  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.BiGAN import BiGAN  # noqa: E402
from igm_tpu_torch.models.info_gan import InfoGAN  # noqa: E402

torch.set_num_threads(1)

LATENT = 6
BIGAN_KW = dict(latent_dim=LATENT, hidden_dim=8, lrG=1e-3, lrD=2e-3)
INFO_KW = dict(noise_dim=5, encode_dim=16, discrete_value=4, continuous_dim=2,
               lambda_I=0.7, loss_mode="lsgan", lrG=1e-3, lrD=2e-3, lrQ=5e-4)


@pytest.mark.parametrize("nets,parts", [
    (mlp(), ["MLPEncoder_0", "MLPEncoder_1", "MLPEncoder_2"]),
    (conv32(), ["MLPEncoder_0", "Encoder_0", "MLPEncoder_1"])], ids=["mlp", "conv32"])
def test_bigan_train_step_matches_igm_tpu(nets, parts):
    jm, state, tm, tstate = setup(JaxBiGAN, BiGAN, nets, names=("decoder", "encoder"),
                                  **BIGAN_KW)
    assert tm.modules["discriminator"].part_names == parts
    assert sorted(state.params["discriminator"]) == sorted(parts)
    imgs, labels = batch(nets, 30)
    _, rng = state.next_rng()
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels,
                                     {"g": 1e-3, "d": 2e-3},
                                     draws={"z": t(jax.random.normal(rng, (BATCH, LATENT)))})
    assert rec.order == ["g", "d"]
    assert all(np.isfinite(float(v)) for v in tmetrics.values())


def test_bigan_validation_matches_igm_tpu():
    nets = conv32()
    jm, state, tm, tstate = setup(JaxBiGAN, BiGAN, nets, names=("decoder", "encoder"),
                                  **BIGAN_KW)
    imgs, labels = batch(nets, 31)
    rng = jax.random.PRNGKey(5)
    result, _ = jm.validation_step(state, (imgs, labels), rng)
    res, _ = tm.validation_step(tstate, (t(imgs), t(labels)), torch.Generator().manual_seed(0))
    close(res.encode_latent.numpy(), result["encode_latent"])
    close(res.recon_image.numpy(), result["recon_image"])
    z = t(jax.random.normal(rng, (BATCH, LATENT)))
    close(tm.forward(tstate, z).numpy(), result["fake_image"])
    assert tm.weights_module == "decoder" and tm.has_sampler()


def _info_draws(jm, state):
    _, rng = state.next_rng()
    _, (dis, cont, z) = jm._make_latent(rng, BATCH)
    return {"dis": t(dis), "cont": t(cont), "z": t(z)}


def test_info_gan_train_step_matches_igm_tpu():
    nets = conv_mnist()
    jm, state, tm, tstate = setup(JaxInfoGAN, InfoGAN, nets, **INFO_KW)
    draws = _info_draws(jm, state)
    latent, _ = jm._make_latent(state.next_rng()[1], BATCH)
    np.testing.assert_array_equal(
        tm.make_latent(draws["dis"], draws["cont"], draws["z"]).numpy(), np.asarray(latent))
    imgs, labels = batch(nets, 32)
    _, _, tmetrics, rec = check_step(jm, state, tm, tstate, imgs, labels,
                                     {"g": 1e-3, "d": 2e-3}, draws=draws)
    assert rec.order == ["g", "d"]
    assert set(tmetrics) == {"train_loss/g_loss", "train_loss/I_discrete_loss",
                             "train_loss/I_continuous", "train_loss/d_loss",
                             "train_log/pred_real", "train_log/pred_fake"}
    # the g optimizer's param groups: lrG for netG, lrQ for netQ
    opt = tstate.opt_states["g"]
    assert [g["lr"] for g in opt.param_groups] == [1e-3, 5e-4]
    names = {id(p): k for k, p in tm.modules.named_parameters()}
    assert {names[id(p)].split(".")[0] for p in opt.param_groups[1]["params"]} == {"netQ"}
    assert sorted(flax_to_torch(_flatten(state.params["netQ"]))) == sorted(
        k for k, _ in tm.modules["netQ"].named_parameters())


def test_info_gan_epoch_end_logs_the_traversal_grids():
    nets = conv_mnist()
    tm = InfoGAN(datamodule=nets["dm"], netG=nets["decoder"], netD=nets["encoder"],
                 device="cpu", **INFO_KW)
    tm.init_state(0)
    logged = {}

    class Logger:
        def log_image(self, tag, img, step):
            logged[tag] = (img.shape, step, bool(np.isfinite(img).all()))

    class Trainer:
        state, current_epoch, logger = tm.state, 3, Logger()

    tm.on_train_epoch_end(Trainer())
    assert set(logged) == {"images/sample", "visual/traverse over discrete values",
                           "visual/traverse over first continuous values",
                           "visual/traverse over second continuous values"}
    assert all(step == 3 and finite for _, step, finite in logged.values())
    # 8 rows of 4 discrete values; 8 rows of 10 continuous steps (28 + 2 pixels a cell)
    assert logged["visual/traverse over discrete values"][0] == (2 + 8 * 30, 2 + 4 * 30, 3)
    assert logged["visual/traverse over first continuous values"][0] == (2 + 8 * 30,
                                                                         2 + 10 * 30, 3)
    got = tm.sample(4, torch.Generator().manual_seed(1))       # plain N(0, I) latents
    z = torch.randn((4, tm.latent_dim), generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, tm.forward(tm.state, z))
