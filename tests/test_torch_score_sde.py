"""The port's score-SDE (igm_tpu_torch/models/score_sde.py) against
igm_tpu's, at a tiny size (UNet hidden 8 at (1, 2), 8x8; one DiT case).

Train steps (VE, VP, sub-VP): igm_tpu's key schedule replayed
(``state.next_rng(2)``: t, then the noise), the draws handed to the port's
``train_step``; the loss, every gradient and the parameters after one Adam
step at tests/test_torch_train_step.py's tolerances.  Samplers: the PC chain
(VE, VP, sub-VP, 4 levels with 1 corrector) and the probability-flow ODE (VE,
VP) from the same injected draws, float32, atol = rtol = 1e-4 of the
output's largest magnitude (each step adds a few ulps of the network's gap
through the chain's coefficients).
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models import score_sde as jsde  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.score_sde import ScoreSDE, ve_sigma_grid  # noqa: E402
from tests._torch_parity import (LR, _flatten, _perturb, adam_grads, check_ema,  # noqa: E402
                                 check_train_step, dm)

torch.set_num_threads(1)

SAMPLE_TOL = 1e-4
BATCH = 4
UNET = dict(hidden_dim=8, dim_mults=(1, 2))
DIT = dict(network="dit", hidden_dim=32, depth=2, heads=2)
REPO = Path(__file__).resolve().parent.parent


_INIT = {}


def _jax_model(backbone: str, **kw):
    """igm_tpu's ScoreSDE (learning rate LR) with perturbed weights.  The
    initial state and the optimizer are made once per backbone (with an EMA
    slot, dropped where ema_decay is 0): neither depends on the SDE, and the
    init compiles slowly."""
    net_kw = UNET if backbone == "unet" else DIT
    jm = jsde.ScoreSDE(datamodule=to_node(dm()), compute_dtype="float32", lr=LR, **net_kw,
                       **kw)
    jm.steps_per_epoch = 1
    if backbone not in _INIT:
        init = jsde.ScoreSDE(datamodule=to_node(dm()), compute_dtype="float32", lr=LR,
                             ema_decay=0.9, **net_kw)
        init.steps_per_epoch = 1
        state = jax.jit(init.init_state)(jax.random.PRNGKey(0))
        _INIT[backbone] = (state.replace(params={"denoise": _perturb(state.params["denoise"])}),
                           init.optimizers)
    state, jm.optimizers = _INIT[backbone]
    params = state.params["denoise"]
    opt_states = dict(state.opt_states, ema=params)
    if not float(jm.hparams.ema_decay) > 0:
        del opt_states["ema"]
    return jm, state.replace(opt_states=opt_states), params


def _torch_model(backbone: str, params, **kw):
    net_kw = UNET if backbone == "unet" else DIT
    tm = ScoreSDE(datamodule=dm(), device="cpu", compute_dtype="float32", lr=LR, **net_kw,
                  **kw)
    tstate = tm.init_state(0)
    net = tm.modules["denoise"]
    net.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    if "ema" in tstate.opt_states:
        tstate.opt_states["ema"] = {k: p.detach().clone() for k, p in net.named_parameters()}
    return tm, tstate


@pytest.mark.parametrize("sde,backbone,ema", [("ve", "unet", 0.0), ("vp", "unet", 0.9),
                                              ("subvp", "unet", 0.0), ("ve", "dit", 0.0)])
def test_train_step_matches_igm_tpu(sde, backbone, ema):
    """igm_tpu's compiled train step gives the loss (its metric), the
    gradients (its Adam first moment) and the new parameters."""
    kw = dict(sde=sde, ema_decay=ema)
    jm, state, params = _jax_model(backbone, **kw)
    imgs = np.random.default_rng(1).integers(0, 256, (BATCH, 8, 8, 3), np.uint8)
    labels = np.zeros(BATCH, np.int32)
    keys = jax.random.split(state.rng, 3)[1:]
    if sde == "ve":
        t = jax.random.uniform(keys[0], (BATCH,))
    else:
        t = jax.random.uniform(keys[0], (BATCH,), minval=float(jm.hparams.t_eps), maxval=1.0)
    z = jax.random.normal(keys[1], imgs.shape)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.asarray(labels)))
    want_grads = adam_grads(new_state, "opt", "denoise", float(jm.hparams.b1))

    tm, tstate = _torch_model(backbone, params, **kw)
    tt, tz = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))
    tx = tm.preprocess(torch.from_numpy(imgs))

    def step():
        new, metrics = tm.train_step(tstate, (torch.from_numpy(imgs), torch.from_numpy(labels)),
                                     t=tt, noise=tz)
        assert new.step == 1
        return metrics

    check_train_step(tm, "denoise", params, metrics["train_loss/loss"], want_grads, new_state,
                     lambda: tm.loss(tx, tt, tz), step)
    check_ema(tstate, new_state, want_grads)


def test_ve_sigma_grid_matches_igm_tpu():
    for steps, lo, hi in ((2, 0.01, 50.0), (5, 0.01, 50.0), (64, 0.01, 50.0),
                          (1000, 0.002, 80.0)):
        np.testing.assert_array_equal(ve_sigma_grid(steps, lo, hi),
                                      jsde.ve_sigma_grid(steps, lo, hi))


def _pc_draws(rng, shape, steps: int, m_corr: int) -> list:
    """igm_tpu's PC draws in the order the chain makes them: the initial
    draw, then per level the predictor's and each corrector's."""
    rng, init = jax.random.split(rng)
    out, key = [jax.random.normal(init, shape)], rng
    for _ in range((steps - 1) * (1 + m_corr)):
        key, zk = jax.random.split(key)
        out.append(jax.random.normal(zk, shape))
    return [torch.from_numpy(np.array(a)) for a in out]


def _check_sample(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert np.isfinite(scale) and scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLE_TOL * scale, rtol=SAMPLE_TOL)


@pytest.mark.parametrize("sde,backbone", [("ve", "unet"), ("vp", "unet"), ("subvp", "unet"),
                                          ("ve", "dit")])
def test_pc_sample_matches_igm_tpu(sde, backbone):
    jm, state, params = _jax_model(backbone, sde=sde)
    tm, _ = _torch_model(backbone, params, sde=sde)
    rng = jax.random.PRNGKey(7)
    shape = (2, 8, 8, 3)
    want = jax.jit(functools.partial(jm.pc_sample, n=2, steps=4, corrector_steps=1))(state, rng)
    got = tm.pc_sample(2, steps=4, corrector_steps=1, noises=_pc_draws(rng, shape, 4, 1))
    _check_sample(got, want)


@pytest.mark.parametrize("sde", ["ve", "vp"])
def test_ode_sample_matches_igm_tpu(sde):
    jm, state, params = _jax_model("unet", sde=sde)
    tm, _ = _torch_model("unet", params, sde=sde)
    rng = jax.random.PRNGKey(9)
    want = jax.jit(functools.partial(jm.ode_sample, n=2, steps=5))(state, rng)
    got = tm.ode_sample(2, steps=5, noises=[torch.from_numpy(
        np.array(jax.random.normal(rng, (2, 8, 8, 3))))])
    _check_sample(got, want)


def test_sample_routes_by_sampler_and_clips():
    tm = ScoreSDE(datamodule=dm(), device="cpu", sampler="ode", **UNET)
    tm.init_state(0)
    gen = torch.Generator().manual_seed(0)
    draw = torch.randn((2, 8, 8, 3), generator=gen)
    got = tm.sample(2, steps=3, noises=[draw])
    assert torch.equal(got, torch.clamp(tm.ode_sample(2, steps=3, noises=[draw]), -1.0, 1.0))
    with pytest.raises(ValueError, match="sampler"):
        ScoreSDE(datamodule=dm(), device="cpu", sampler="euler", **UNET)
    with pytest.raises(ValueError, match="sde"):
        ScoreSDE(datamodule=dm(), device="cpu", sde="cld", **UNET)


@pytest.mark.parametrize("experiment,extra", [("score_sde/cifar10", []),
                                              ("score_sde/mnist_vp", ["model.sde=subvp",
                                                                      "model.sampler=ode"])])
def test_train_resume_and_sample_cli(tmp_path, monkeypatch, experiment, extra):
    """The train CLI at a tiny width (validation samples, checkpoints), a
    resume at the saved step, then the sampling CLI from the checkpoints."""
    from igm_tpu_torch.cli import sample_main, train_main
    monkeypatch.chdir(tmp_path)
    tiny = [f"experiment={experiment}", "model.hidden_dim=8", "model.dim_mults=[1,2]",
            "+model.sample_batch=4", "model.sample_steps=3", *extra]
    common = ["trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=4", "logger=null",
              "print_config=False", "optimized_metric=train_loss/loss",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    run = tmp_path / "logs" / "runs" / experiment
    for epochs, ckpts in ((1, ["step_2.pt"]), (2, ["step_2.pt", "step_4.pt"])):
        loss = train_main([*tiny, f"trainer.max_epochs={epochs}",
                           f"trainer.resume={run / 'checkpoints'}", *common])
        assert np.isfinite(loss)
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
    assert sorted(p.name for p in (run / "results").iterdir()) == ["0.jpg", "1.jpg"]
    saved = torch.load(run / "checkpoints" / "step_4.pt", weights_only=True)
    assert saved["step"] == 4 and "ema" in saved["opt_states"]
    imgs = sample_main([*tiny, "--ckpt", str(run / "checkpoints"), "--n", "3",
                        "--device", "cpu", "--out", str(tmp_path / "s.png")])
    size = 32 if experiment.endswith("cifar10") else 28
    assert imgs.shape[:3] == (3, size, size) and imgs.abs().max() <= 1.0
    assert (tmp_path / "s.png").exists()
