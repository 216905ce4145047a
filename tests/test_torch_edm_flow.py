"""The port's EDM and flow matching (igm_tpu_torch/models/edm.py,
flow_matching.py) against igm_tpu's, at a tiny size, on both backbones.

Train steps: igm_tpu's key schedule replayed (``state.next_rng(2 or 3)``,
then EDM's N(0, 1) draw behind ln(sigma) or flow's t ~ U[0, 1), the
noise, the label drop), the draws handed to the port's ``train_step``;
the loss, every gradient and the parameters after one Adam step at
tests/test_torch_train_step.py's tolerances.  Samplers: EDM's Heun over
the Karras grid and flow's Euler and Heun ODE from the same initial
noise, float32, atol = rtol = 1e-4 (each step adds a few ulps of the
network's gap through O(1) coefficients; EDM's first step also scales
by sigma_max = 80).
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
from igm_tpu.models import edm as jedm  # noqa: E402
from igm_tpu.models.flow_matching import FlowMatching as JaxFlow  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.edm import EDM, karras_sigmas  # noqa: E402
from igm_tpu_torch.models.flow_matching import TIME_SCALE, FlowMatching  # noqa: E402
from tests._torch_parity import (LR, _flatten, _perturb, check_ema,  # noqa: E402
                                 check_train_step, dm)

torch.set_num_threads(1)

SAMPLE_ATOL = SAMPLE_RTOL = 1e-4
BATCH = 4
UNET = dict(hidden_dim=8, dim_mults=(1, 2))
DIT = dict(network="dit", hidden_dim=32, depth=2, heads=2)
CASES = {
    "unet": dict(UNET),
    "unet_conditional": dict(UNET, num_classes=3, cond_drop_prob=0.5, channels=1),
    "dit": dict(DIT),
    "dit_conditional_ema": dict(DIT, num_classes=3, cond_drop_prob=0.5, ema_decay=0.9),
}


def _setup(jcls, case):
    kw = dict(CASES[case])
    c = kw.pop("channels", 3)
    kw.update(lr=LR, compute_dtype="float32")
    jm = jcls(datamodule=to_node(dm(c)), **kw)
    jm.steps_per_epoch = 1
    state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
    module = next(iter(state.params))
    params = _perturb(state.params[module])
    opt_states = dict(state.opt_states)
    if "ema" in opt_states:
        opt_states["ema"] = params
    state = state.replace(params={module: params}, opt_states=opt_states)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (BATCH, 8, 8, c), np.uint8)
    labels = np.array([0, 1, 2, 1], np.int32)
    nc = jm.num_classes
    keys = jax.random.split(state.rng, (3 if nc else 2) + 1)[1:]
    drop = jax.random.bernoulli(keys[2], float(jm.hparams.cond_drop_prob), (BATCH,)) \
        if nc else None
    if nc:
        assert 0 < int(drop.sum()) < BATCH          # both branches of the drop occur
    y = jnp.where(drop, nc, jnp.asarray(labels)) if nc else None
    return kw, c, jm, state, module, params, imgs, labels, keys, drop, y


def _torch_model(tcls, kw, c, module, params, ema: bool):
    tm = tcls(datamodule=dm(c), device="cpu", **kw)
    tstate = tm.init_state(0)
    net = tm.modules[module]
    net.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    if ema:
        tstate.opt_states["ema"] = {k: p.detach().clone() for k, p in net.named_parameters()}
    return tm, tstate


@pytest.mark.parametrize("case", ["unet", "dit_conditional_ema"])
def test_edm_train_step_matches_igm_tpu(case):
    kw, c, jm, state, module, params, imgs, labels, keys, drop, y = _setup(jedm.EDM, case)
    hp = jm.hparams
    sd = float(hp.sigma_data)
    z = jax.random.normal(keys[0], (BATCH,))
    noise = jax.random.normal(keys[1], imgs.shape)
    x = jm.preprocess(jnp.asarray(imgs))

    def jax_loss(p):
        sigma = jnp.exp(float(hp.p_mean) + float(hp.p_std) * z)
        sb = sigma.reshape(-1, 1, 1, 1)
        x_sigma = x + sb * noise
        lam = (sb ** 2 + sd ** 2) / (sb * sd) ** 2
        f, _ = jm._apply_F({module: p}, state.mutables, jedm._c_in(sb, sd) * x_sigma,
                           jedm._c_noise(sigma), y, train=True)
        d = jedm._c_skip(sb, sd) * x_sigma + jedm._c_out(sb, sd) * f
        return jnp.mean(lam * (d - x) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    new_state, _ = jax.jit(jm.train_step)(state, (jnp.asarray(imgs), jnp.asarray(labels)))

    tm, tstate = _torch_model(EDM, kw, c, module, params, "ema" in state.opt_states)
    tz, tnoise = torch.from_numpy(np.array(z)), torch.from_numpy(np.array(noise))
    tdrop = None if drop is None else torch.from_numpy(np.array(drop))
    ty = None if y is None else torch.from_numpy(np.array(y, np.int64))
    tx = tm.preprocess(torch.from_numpy(imgs))
    sigma = torch.exp(float(hp.p_mean) + float(hp.p_std) * tz)

    def step():
        new, metrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                              torch.from_numpy(labels)),
                                     sigma_draw=tz, noise=tnoise, drop=tdrop)
        assert new.step == 1
        return metrics

    check_train_step(tm, module, params, want_loss, want_grads, new_state,
                     lambda: tm.loss(tx, sigma, tnoise, ty), step)
    check_ema(tstate, new_state, want_grads)


@pytest.mark.parametrize("case", ["unet_conditional", "dit"])
def test_flow_train_step_matches_igm_tpu(case):
    kw, c, jm, state, module, params, imgs, labels, keys, drop, y = _setup(JaxFlow, case)
    assert module == "velocity"
    sm = float(jm.hparams.sigma_min)
    t = jax.random.uniform(keys[0], (BATCH,))
    x0 = jax.random.normal(keys[1], imgs.shape)
    x1 = jm.preprocess(jnp.asarray(imgs))
    yy = () if y is None else (y,)

    def jax_loss(p):
        tb = t.reshape(-1, 1, 1, 1)
        x_t = (1.0 - (1.0 - sm) * tb) * x0 + tb * x1
        pred, _ = jm.modules.apply("velocity", {module: p}, state.mutables, x_t,
                                   t * TIME_SCALE, *yy)
        return jnp.mean((x1 - (1.0 - sm) * x0 - pred) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    new_state, _ = jax.jit(jm.train_step)(state, (jnp.asarray(imgs), jnp.asarray(labels)))

    tm, tstate = _torch_model(FlowMatching, kw, c, module, params,
                              "ema" in state.opt_states)
    tt, tx0 = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))
    tdrop = None if drop is None else torch.from_numpy(np.array(drop))
    ty = None if y is None else torch.from_numpy(np.array(y, np.int64))
    tx1 = tm.preprocess(torch.from_numpy(imgs))

    def step():
        new, metrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                              torch.from_numpy(labels)),
                                     t=tt, noise=tx0, drop=tdrop)
        assert new.step == 1
        return metrics

    check_train_step(tm, module, params, want_loss, want_grads, new_state,
                     lambda: tm.loss(tx1, tt, tx0, ty), step)
    check_ema(tstate, new_state, want_grads)


def test_karras_sigmas_match_igm_tpu():
    for steps in (2, 5, 18):
        np.testing.assert_array_equal(karras_sigmas(steps, 0.002, 80.0, 7.0),
                                      jedm.karras_sigmas(steps, 0.002, 80.0, 7.0))


def _sampler_pair(jcls, tcls, backbone, **kw):
    kw = dict(CASES[backbone], compute_dtype="float32", **kw)
    jm = jcls(datamodule=to_node(dm()), **kw)
    jm.steps_per_epoch = 1
    state = jm.init_state(jax.random.PRNGKey(0))
    module = next(iter(state.params))
    params = _perturb(state.params[module])
    state = state.replace(params={module: params})
    tm = tcls(datamodule=dm(), device="cpu", **kw)
    tm.modules[module].load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    return jm, state, tm


@pytest.mark.parametrize("backbone,guidance", [("dit", 1.0), ("dit_conditional_ema", 2.0)])
def test_edm_heun_sample_matches_igm_tpu(backbone, guidance):
    """Heun over a 5-sigma Karras grid: 4 Heun pairs and the final D (9
    forwards; a doubled batch each with guidance)."""
    jm, state, tm = _sampler_pair(jedm.EDM, EDM, backbone, ema_decay=0.0)
    rng = jax.random.PRNGKey(7)
    y = jnp.array([0, 2]) if jm.num_classes else None
    want = np.asarray(jm.heun_sample(state, rng, 2, steps=5, y=y, guidance=guidance))
    noise = np.array(jax.random.normal(rng, (2, 8, 8, 3)))
    got = tm.heun_sample(2, steps=5, noise=torch.from_numpy(noise),
                         y=None if y is None else torch.tensor([0, 2]),
                         guidance=guidance).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)


@pytest.mark.parametrize("backbone,sampler", [("dit", "euler"), ("dit", "heun")])
def test_flow_ode_sample_matches_igm_tpu(backbone, sampler):
    jm, state, tm = _sampler_pair(JaxFlow, FlowMatching, backbone, sampler=sampler)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jm.ode_sample(state, rng, 2, steps=4))
    x0 = np.array(jax.random.normal(rng, (2, 8, 8, 3)))
    got = tm.ode_sample(2, steps=4, x0=torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)


# ------------------------------------------------------- configs and CLIs
REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = {
    "ddpm/cifar10_dit": ("DDPM", "DiT", []),
    "ddpm/cifar10_dit_v": ("DDPM", "DiT", []),
    "edm/cifar10_dit": ("EDM", "DiT", []),
    "flow/cifar10_dit": ("FlowMatching", "DiT", []),
    "edm/cifar10": ("EDM", "Unet", []),
    "flow/cifar10": ("FlowMatching", "Unet", []),
    "flow/cond_mnist": ("FlowMatching", "Unet", []),
    "latent_ddpm/cifar10": ("LatentDDPM", "DiT", ["model.network=dit"]),
}


@pytest.mark.parametrize("experiment", list(EXPERIMENTS))
def test_experiment_builds_through_the_port_config(experiment):
    """Each config composes and instantiates the port's model at full width
    (the igm_tpu.* targets resolve to igm_tpu_torch), with its backbone;
    the DiT runs one forward at its datamodule's shape (the latent DDPM's
    8x8 latents make 16 tokens at patch 2)."""
    from igm_tpu_torch.config import compose, instantiate
    cls, net_cls, extra = EXPERIMENTS[experiment]
    cfg = compose(REPO / "configs", [f"experiment={experiment}", *extra,
                                     "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    assert type(model).__name__ == cls
    net = model.modules[model.weights_module]
    assert type(net).__name__ == net_cls
    if net_cls == "DiT":
        shape = ((1, model.latent_h, model.latent_w, model.denoise_channels)
                 if cls == "LatentDDPM" else (1, model.height, model.width, model.channels))
        tokens = shape[1] // net.patch * shape[2] // net.patch
        assert tokens == (16 if cls == "LatentDDPM" else 256)
        if cls != "LatentDDPM":       # 64 wide over 6 heads does not divide
            with torch.no_grad():
                out = net(torch.zeros(shape), torch.zeros(1))
            assert out.shape == shape


def test_edm_dit_train_resume_and_heun_cli(tmp_path, monkeypatch):
    """experiment=edm/cifar10_dit through the CLIs at a tiny width: train
    with validation samples, resume at the saved step, then --sampler heun
    from the checkpoints (the EMA weights)."""
    from igm_tpu_torch.cli import sample_main, train_main
    monkeypatch.chdir(tmp_path)
    tiny = ["experiment=edm/cifar10_dit", "model.hidden_dim=32", "model.depth=1",
            "model.heads=2", "+model.sample_batch=4", "model.sample_steps=2"]
    common = ["trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=4", "logger=null",
              "print_config=False", "optimized_metric=train_loss/loss",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    run = tmp_path / "logs" / "runs" / "edm" / "cifar10_dit"
    for epochs, ckpts in ((1, ["step_2.pt"]), (2, ["step_2.pt", "step_4.pt"])):
        loss = train_main([*tiny, f"trainer.max_epochs={epochs}",
                           f"trainer.resume={run / 'checkpoints'}", *common])
        assert np.isfinite(loss)
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
    assert sorted(p.name for p in (run / "results").iterdir()) == ["0.jpg", "1.jpg"]
    imgs = sample_main([*tiny, "--ckpt", str(run / "checkpoints"), "--n", "3",
                        "--sampler", "heun", "--device", "cpu",
                        "--out", str(tmp_path / "heun.png")])
    assert imgs.shape == (3, 32, 32, 3) and imgs.abs().max() <= 1.0
    assert (tmp_path / "heun.png").exists()


def test_weights_npz_loads_a_scan_layout_dit(tmp_path):
    """--weights takes an .npz of igm_tpu's DiT denoiser in the stacked
    block_mode=scan layout: it samples exactly as the same weights
    converted and saved by torch, and not as the seeded init."""
    import jax
    from igm_tpu.models.ddpm import DDPM as JaxDDPM
    from igm_tpu_torch.cli import sample_main
    from tests._torch_parity import _flatten, _perturb
    tiny = ["experiment=ddpm/cifar10_dit", "model.hidden_dim=32", "model.depth=2",
            "model.heads=2", "model.timesteps=6"]
    jm = JaxDDPM(datamodule=to_node(dm()), network="dit", hidden_dim=32, depth=2, heads=2,
                 timesteps=6, block_mode="scan", compute_dtype="float32")
    jm.steps_per_epoch = 1
    flat = _flatten(_perturb(jax.jit(jm.init_state)(jax.random.PRNGKey(3)).params["denoise"]))
    assert any(k.startswith("blocks/") for k in flat)
    np.savez(tmp_path / "w.npz", **flat)
    torch.save(flax_to_torch(flat), tmp_path / "w.pt")
    got = {}
    for name, extra in (("npz", ["--weights", str(tmp_path / "w.npz")]),
                        ("pt", ["--weights", str(tmp_path / "w.pt")]), ("init", [])):
        got[name] = sample_main([*tiny, "--n", "2", "--device", "cpu", "--sampler", "ddim",
                                 "--steps", "2", "--out", str(tmp_path / f"{name}.png"),
                                 *extra])
    assert torch.equal(got["npz"], got["pt"])
    assert not torch.equal(got["npz"], got["init"])
