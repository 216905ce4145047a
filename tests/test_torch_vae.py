"""The port's VAE, cVAE and FactorVAE against igm_tpu's, at a tiny size:
8x8 images through the MLP networks (widths 8-16, batch-normed) and 28x28
through the MNIST conv networks (ndf = ngf = 8).

Flax params and batch_stats (moved off their init) go through
igm_tpu_torch.interop, igm_tpu's noise and permutations are injected, and
one train step is compared: the loss, every gradient (igm_tpu's read back
from its Adam first moment, tests/_torch_parity.py), the parameters after
Adam and the BatchNorm buffers after the step; then ``validation_step``,
``forward`` and ``sample`` on the same weights and latents.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_parity import (G_FLOOR, GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                           PARAM_ATOL, PARAM_RTOL, _flatten, _perturb, adam_grads)
from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models.cvae import cVAE as JaxCVAE  # noqa: E402
from igm_tpu.models.factor_vae import FactorVAE as JaxFactorVAE  # noqa: E402
from igm_tpu.models.vae import VAE as JaxVAE  # noqa: E402
from igm_tpu_torch.interop import flax_mutables_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.models.cvae import cVAE  # noqa: E402
from igm_tpu_torch.models.factor_vae import FactorVAE, permute_dims  # noqa: E402
from igm_tpu_torch.models.vae import VAE  # noqa: E402

torch.set_num_threads(1)

BATCH, LATENT = 8, 4
# float32 outputs through <= 6 layers on both sides: a few ulps of the largest
RTOL = 1e-5
MLP = {"enc": {"_target_": "igm_tpu.networks.basic.MLPEncoder", "hidden_dims": [16, 12],
               "width": 8, "height": 8, "norm_type": "batch"},
       "dec": {"_target_": "igm_tpu.networks.basic.MLPDecoder", "hidden_dims": [12, 16],
               "width": 8, "height": 8, "norm_type": "batch"},
       "dm": {"width": 8, "height": 8, "channels": 1,
              "transforms": {"convert": True, "normalize": True}}}
CONV = {"enc": {"_target_": "igm_tpu.networks.basic.ConvEncoder", "ndf": 8,
                "norm_type": "batch"},
        "dec": {"_target_": "igm_tpu.networks.basic.ConvDecoder", "ngf": 8,
                "norm_type": "batch"},
        "dm": {"width": 28, "height": 28, "channels": 1,
               "transforms": {"convert": True, "normalize": False}}}
# the FactorVAE experiments' networks (conv_64 without norm) at ndf = ngf = 4
CONV64 = {"enc": {"_target_": "igm_tpu.networks.conv64.Encoder", "ndf": 4, "norm_type": None},
          "dec": {"_target_": "igm_tpu.networks.conv64.Decoder", "ngf": 4, "norm_type": None},
          "dm": {"width": 64, "height": 64, "channels": 1,
                 "transforms": {"convert": True, "normalize": False}}}


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _moved_stats(mutables, seed):
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return jnp.asarray(v * rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        return jnp.asarray(v + 0.1 * rng.normal(size=v.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(move, mutables)


def _setup(jax_cls, port_cls, nets, seed=0, **kw):
    """igm_tpu's model and state (params and stats moved), the port's model
    with the same weights, and the port's state."""
    jm = jax_cls(datamodule=to_node(nets["dm"]), encoder=to_node(nets["enc"]),
                 decoder=to_node(nets["dec"]), latent_dim=LATENT, **kw)
    jm.steps_per_epoch = 5
    state = jm.init_state(jax.random.PRNGKey(seed))
    state = state.replace(params=_perturb(state.params, seed + 1),
                          mutables=_moved_stats(state.mutables, seed + 2))
    tm = port_cls(datamodule=nets["dm"], encoder=nets["enc"], decoder=nets["dec"],
                  latent_dim=LATENT, device="cpu", **kw)
    tm.steps_per_epoch = 5
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(_weights(state), strict=True)
    return jm, state, tm, tstate


def _weights(state):
    return {**flax_to_torch(_flatten(state.params)),
            **flax_mutables_to_torch(_flatten(state.mutables))}


def _batch(nets, seed, n=BATCH):
    dm = nets["dm"]
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, dm["height"], dm["width"], dm["channels"]), np.uint8)
    return imgs, rng.integers(0, 10, n).astype(np.int32)


def _check_grads(got: dict, want_tree):
    want = {k: v.numpy() for k, v in flax_to_torch(_flatten(want_tree)).items()}
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], atol=GRAD_ATOL_SCALE * scale, rtol=GRAD_RTOL,
                                   err_msg=k)
    return want


def _check_after_step(tm, modules, new_state, want_grads: dict, before: dict):
    """The parameters of ``modules`` after the step where its sign is
    certain, every BatchNorm buffer of the model.  Adam's first step moves
    a parameter by lr * sign(g): held where |g| is above G_FLOOR and twice
    the gradients' tolerance (a Dense bias ahead of a BatchNorm has the
    gradient 0 up to rounding, of either sign on either side), elsewhere
    to |step| <= lr."""
    want_p = flax_to_torch(_flatten(new_state.params))
    lr = max(float(tm.hparams.get(n, 0)) for n in ("lr", "lrD"))
    floor = max(G_FLOOR, 2 * GRAD_ATOL_SCALE * max(np.abs(g).max()
                                                   for g in want_grads.values()))
    for m in modules:
        for k, p in tm.modules[m].named_parameters():
            name = f"{m}.{k}"
            big = np.abs(want_grads[name]) > floor
            got = p.detach().numpy()
            np.testing.assert_allclose(got[big], want_p[name].numpy()[big], atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=name)
            assert np.all(np.abs(got - before[name]) <= lr * (1 + 1e-3)), name
    want_b = flax_mutables_to_torch(_flatten(new_state.mutables))
    buffers = dict(tm.modules.named_buffers())
    assert set(buffers) == set(want_b)
    for k, v in want_b.items():
        close(buffers[k].numpy(), v.numpy())


def _port_grads(tm, modules, loss):
    names = [f"{m}.{k}" for m in modules for k, _ in tm.modules[m].named_parameters()]
    params = [p for m in modules for p in tm.modules[m].parameters()]
    return {k: g.numpy() for k, g in zip(names, torch.autograd.grad(loss, params))}


@pytest.mark.parametrize("nets,dist", [(MLP, "gaussian"), (CONV, "bernoulli")],
                         ids=["mlp-gaussian", "conv-bernoulli"])
def test_vae_train_step_matches_igm_tpu(nets, dist):
    jm, state, tm, tstate = _setup(JaxVAE, VAE, nets, beta=4.0, decoder_dist=dist,
                                   lr=1e-3)
    imgs, labels = _batch(nets, 10)
    _, rng = state.next_rng()
    eps = np.array(jax.random.normal(rng, (BATCH, LATENT)))
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                        jnp.asarray(labels)))
    before = {k: v.detach().clone().numpy() for k, v in tm.modules.state_dict().items()}
    x = tm.preprocess(torch.from_numpy(imgs))
    loss, tmetrics = tm.loss(x, torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss.detach()), -float(metrics["train_log/elbo"]),
                               rtol=LOSS_RTOL)
    for k in ("train_log/kl_divergence", "train_log/log_p_x_of_z"):
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]), rtol=LOSS_RTOL)
    mods = ["encoder", "decoder"]
    want_g = _check_grads(_port_grads(tm, mods, loss), _jax_grads(new_state, "opt", mods, 0.9))
    tm.modules.load_state_dict(_weights(state), strict=True)       # undo the stats' move
    tstate, step_metrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                                  torch.from_numpy(labels)),
                                         eps=torch.from_numpy(eps))
    assert tstate.step == 1
    np.testing.assert_allclose(float(step_metrics["train_log/elbo"]),
                               float(metrics["train_log/elbo"]), rtol=LOSS_RTOL)
    _check_after_step(tm, mods, new_state, want_g, before)


def _jax_grads(new_state, opt_name, modules, b1):
    return {m: adam_grads(new_state, opt_name, m, b1) for m in modules}


def test_vae_validation_forward_and_sample_match_igm_tpu():
    nets = MLP
    jm, state, tm, tstate = _setup(JaxVAE, VAE, nets)
    imgs, labels = _batch(nets, 11)
    rng = jax.random.PRNGKey(7)
    result, metrics = jm.validation_step(state, (jnp.asarray(imgs), jnp.asarray(labels)), rng)
    vae_rng, sample_rng = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(vae_rng, (BATCH, LATENT))))
    z_fake = torch.from_numpy(np.array(jax.random.normal(sample_rng, (BATCH, LATENT))))
    x = tm.preprocess(torch.from_numpy(imgs))
    with torch.no_grad():
        _, _, z, recon = tm._vae(x, eps, train=False)
        log_p = tm.decoder_dist.prob(recon, x).mean()
        fake = tm.forward(tstate, z_fake)
    close(z.numpy(), result["encode_latent"])
    close(recon.numpy(), result["recon_image"])
    close(fake.numpy(), result["fake_image"])
    np.testing.assert_allclose(float(log_p), float(metrics["val_log/log_p_x_of_z"]),
                               rtol=LOSS_RTOL)
    # the port's own draws: shapes, and sample == forward of the same latents
    res, _ = tm.validation_step(tstate, (torch.from_numpy(imgs), torch.from_numpy(labels)),
                                torch.Generator().manual_seed(3))
    assert res.fake_image.shape == res.recon_image.shape == (BATCH, 8, 8, 1)
    g = torch.Generator().manual_seed(4)
    got = tm.sample(5, g)
    z = torch.randn((5, LATENT), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, tm.forward(tstate, z))
    assert tm.has_sampler() and tm.weights_module == "decoder"


def test_cvae_train_step_matches_igm_tpu():
    jm, state, tm, tstate = _setup(JaxCVAE, cVAE, CONV, n_classes=10, lr=1e-3)
    imgs, labels = _batch(CONV, 12)
    _, rng = state.next_rng()
    eps = np.array(jax.random.normal(rng, (BATCH, LATENT)))
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                        jnp.asarray(labels)))
    before = {k: v.detach().clone().numpy() for k, v in tm.modules.state_dict().items()}
    x, y = tm.preprocess(torch.from_numpy(imgs)), torch.from_numpy(labels)
    loss, _ = tm.loss(x, y, torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss.detach()), -float(metrics["train_log/elbo"]),
                               rtol=LOSS_RTOL)
    mods = ["encoder", "decoder", "class_embedding"]
    want_g = _check_grads(_port_grads(tm, mods, loss), _jax_grads(new_state, "opt", mods, 0.9))
    tm.modules.load_state_dict(_weights(state), strict=True)
    tstate, _ = tm.train_step(tstate, (torch.from_numpy(imgs), y), eps=torch.from_numpy(eps))
    _check_after_step(tm, mods, new_state, want_g, before)


def test_cvae_validation_and_sample_match_igm_tpu():
    jm, state, tm, tstate = _setup(JaxCVAE, cVAE, CONV, n_classes=10)
    imgs, labels = _batch(CONV, 13)
    rng = jax.random.PRNGKey(8)
    result, metrics = jm.validation_step(state, (jnp.asarray(imgs), jnp.asarray(labels)), rng)
    vae_rng, sample_rng = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(vae_rng, (BATCH, LATENT))))
    z_fake = torch.from_numpy(np.array(jax.random.normal(sample_rng, (8 * 10, LATENT))))
    x, y = tm.preprocess(torch.from_numpy(imgs)), torch.from_numpy(labels)
    with torch.no_grad():
        _, _, z, recon = tm._vae(x, y, eps, train=False)
    fake = tm.sample(8, z=z_fake)
    assert fake.shape == (80, 28, 28, 1)
    close(z.numpy(), result["encode_latent"])
    close(recon.numpy(), result["recon_image"])
    close(fake.numpy(), result["fake_image"])


FACTOR = dict(loss_mode="lsgan", adv_weight=6.4, lr=1e-3, lrD=1e-3)
# halves of 8: at halves of 4, the critic's BatchNorm (256 features of 4
# samples) has features with mean^2 / var near 2000, whose batch variance
# the float32 rounding of its inputs alone moves by ~2e-4, on both sides
FACTOR_BATCH = 16


def _factor_draws(state, n_half):
    _, (r1, r2, perm_rng) = state.next_rng(3)
    eps1 = np.array(jax.random.normal(r1, (n_half, LATENT)))
    eps2 = np.array(jax.random.normal(r2, (n_half, LATENT)))
    keys = jax.random.split(perm_rng, LATENT)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n_half))(keys)
    return (torch.from_numpy(eps1), torch.from_numpy(eps2),
            torch.from_numpy(np.asarray(perms.T)).long())


@pytest.mark.parametrize("nets", [MLP, CONV64], ids=["mlp", "conv64"])
def test_factor_vae_train_step_matches_igm_tpu(nets):
    """Both optimizers in one step.  The AE phase: its loss and gradients,
    and the encoder's and decoder's parameters after the AE update.  The D
    phase then runs on igm_tpu's encoder after its AE update, written into
    the port's between the phases: Adam's first step moves a parameter
    whose gradient is 0 up to rounding (a bias ahead of a BatchNorm) by
    lr * a sign that rounding decides, which moves the second half's
    latents.  From there: every metric, netD's first Adam moment (the D
    loss's gradient alone), netD's parameters, and every BatchNorm buffer
    (the encoder's moved twice, netD's not at all)."""
    jm, state, tm, tstate = _setup(JaxFactorVAE, FactorVAE, nets, **FACTOR)
    imgs, labels = _batch(nets, 14, FACTOR_BATCH)
    eps1, eps2, perm = _factor_draws(state, FACTOR_BATCH // 2)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                        jnp.asarray(labels)))
    before = {k: v.detach().clone().numpy() for k, v in tm.modules.state_dict().items()}
    x = tm.preprocess(torch.from_numpy(imgs))
    loss, aux = tm.ae_loss(x[:FACTOR_BATCH // 2], eps1)
    want_loss = (metrics["train_loss/recon_loss"] + metrics["train_loss/reg_loss"]
                 + 6.4 * metrics["train_loss/g_adv_loss"])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    ae = ["encoder", "decoder"]
    want_g = _check_grads(_port_grads(tm, ae, loss), _jax_grads(new_state, "ae", ae, 0.9))
    tm.modules.load_state_dict(_weights(state), strict=True)

    jax_ae = {k: v for k, v in flax_to_torch(_flatten(new_state.params)).items()
              if k.split(".")[0] in ae}
    own_ae = {}
    grad_step = tm.optimizers.grad_step

    def ae_then_reference(state_, name, loss_fn, **kw):
        out = grad_step(state_, name, loss_fn, **kw)
        if name == "ae":
            params = dict(tm.modules.named_parameters())
            with torch.no_grad():
                for k, v in jax_ae.items():
                    own_ae[k] = params[k].detach().clone()
                    params[k].copy_(v)
        return out

    tm.optimizers.grad_step = ae_then_reference
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                              torch.from_numpy(labels)),
                                     eps1=eps1, eps2=eps2, perm=perm)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    with torch.no_grad():                  # the port's own AE update, then its D update
        for k, v in own_ae.items():
            dict(tm.modules.named_parameters())[k].copy_(v)
    opt_d = tstate.opt_states["d"]
    got_d = {f"netD.{k}": opt_d.state[p]["exp_avg"].numpy() / (1.0 - 0.5)
             for k, p in tm.modules["netD"].named_parameters()}
    want_g.update(_check_grads(got_d, _jax_grads(new_state, "d", ["netD"], 0.5)))
    _check_after_step(tm, ae + ["netD"], new_state, want_g, before)
    for k, v in tm.modules["netD"].named_buffers():
        assert torch.equal(v, torch.from_numpy(before[f"netD.{k}"])), k


def test_factor_vae_netd_stats_stay_at_init_and_ae_leaves_netd_grads_alone():
    """From the port's own init: no parameter holds a ``.grad`` after the
    step, netD's buffers stay 0 and 1, and netD's first Adam moment is
    (1 - b1) times the gradient of the D loss alone, recomputed here from
    the AE phase's z1 and the encoder after the AE update."""
    def model():
        m = FactorVAE(datamodule=MLP["dm"], encoder=MLP["enc"], decoder=MLP["dec"],
                      latent_dim=LATENT, device="cpu", **FACTOR)
        return m, m.init_state(0)

    tm, tstate = model()
    imgs, labels = _batch(MLP, 15)
    eps1, eps2 = torch.randn(4, LATENT), torch.randn(4, LATENT)
    perm = torch.stack([torch.randperm(4) for _ in range(LATENT)], 1)
    tstate, _ = tm.train_step(tstate, (torch.from_numpy(imgs), torch.from_numpy(labels)),
                              eps1=eps1, eps2=eps2, perm=perm)
    assert all(p.grad is None for p in tm.modules.parameters())
    bn = tm.modules["netD"].LinearAct_1.Norm_0.BatchNorm_0
    assert torch.equal(bn.mean, torch.zeros(256)) and torch.equal(bn.var, torch.ones(256))

    ref, rstate = model()
    x = ref.preprocess(torch.from_numpy(imgs))
    rstate, _, aux = ref.optimizers.grad_step(rstate, "ae", lambda: ref.ae_loss(x[:4], eps1))
    with torch.no_grad():
        z2 = ref.modules["encoder"](x[4:], True)
        z2 = z2[:, :LATENT] + torch.exp(z2[:, LATENT:]) * eps2
    d_loss, _ = ref.d_loss(permute_dims(z2, perm), aux["z1"])
    grads = torch.autograd.grad(d_loss, list(ref.modules["netD"].parameters()))
    opt = tstate.opt_states["d"]
    for p, g in zip(tm.modules["netD"].parameters(), grads):
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy() / 0.5, g.numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_permute_dims_matches_igm_tpu():
    from igm_tpu.models.factor_vae import permute_dims as jax_permute
    z = np.random.default_rng(16).normal(size=(6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_permute(key, jnp.asarray(z))
    keys = jax.random.split(key, 5)
    perms = jax.vmap(lambda k: jax.random.permutation(k, 6))(keys)
    got = permute_dims(torch.from_numpy(z), torch.from_numpy(np.asarray(perms.T)).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from igm_tpu_torch.models.factor_vae import draw_permutations
    p = draw_permutations(6, 5, torch.Generator().manual_seed(0), "cpu")
    assert all(sorted(p[:, j].tolist()) == list(range(6)) for j in range(5))


def test_factor_vae_validation_matches_igm_tpu():
    jm, state, tm, tstate = _setup(JaxFactorVAE, FactorVAE, MLP, **FACTOR)
    imgs, labels = _batch(MLP, 17)
    rng = jax.random.PRNGKey(9)
    result, _ = jm.validation_step(state, (jnp.asarray(imgs), jnp.asarray(labels)), rng)
    enc_rng, sample_rng = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(enc_rng, (BATCH, LATENT))))
    z_fake = torch.from_numpy(np.array(jax.random.normal(sample_rng, (BATCH, LATENT))))
    x = tm.preprocess(torch.from_numpy(imgs))
    with torch.no_grad():
        z2 = tm.modules["encoder"](x, False)
        z = z2[:, :LATENT] + torch.exp(z2[:, LATENT:]) * eps
        recon = tm.modules["decoder"](z, False).reshape(x.shape)
    close(z.numpy(), result["encode_latent"])
    close(recon.numpy(), result["recon_image"])
    close(tm.forward(tstate, z_fake).numpy(), result["fake_image"])
