"""The port's consistency model (igm_tpu_torch/models/consistency.py)
against igm_tpu's, at a tiny size (UNet hidden 8 at (1, 2), 8x8; a DiT).

Train steps (unconditional on the DiT; class-conditional with EMA on the
UNet): igm_tpu's key schedule replayed (``state.next_rng(2)``: the pair
index, then the noise), the draws handed to the port's ``train_step``; the
loss, the raw l2 metric, every gradient, the parameters and the EMA shadow
after one Adam step at tests/test_torch_train_step.py's tolerances.
Multistep sampling at 1 and 3 steps (and where the refinement levels are
deduplicated) from the same injected draws, float32, atol = rtol = 1e-4 of
the output's largest magnitude.
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
from igm_tpu.models import consistency as jcm  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.consistency import (ConsistencyModel,  # noqa: E402
                                              lognormal_index_weights)
from tests._torch_parity import (LR, _flatten, _perturb, adam_grads, check_ema,  # noqa: E402
                                 check_train_step, dm)

torch.set_num_threads(1)

SAMPLE_TOL = 1e-4
BATCH = 4
CASES = {
    "dit": dict(network="dit", hidden_dim=32, depth=2, heads=2, ema_decay=0.0),
    "unet_conditional_ema": dict(hidden_dim=8, dim_mults=(1, 2), num_classes=3,
                                 ema_decay=0.9),
}
_INIT = {}


def _pair(case: str, **kw):
    """igm_tpu's model with perturbed weights (its state made once per case)
    and the port's with the same weights and EMA shadow."""
    kw = {**CASES[case], "lr": LR, "compute_dtype": "float32", "n_grid": 16, **kw}
    jm = jcm.ConsistencyModel(datamodule=to_node(dm()), **kw)
    jm.steps_per_epoch = 1
    if case not in _INIT:
        state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
        params = _perturb(state.params["denoise"])
        opt_states = dict(state.opt_states)
        if "ema" in opt_states:
            opt_states["ema"] = params
        _INIT[case] = (state.replace(params={"denoise": params}, opt_states=opt_states),
                       jm.optimizers)
    state, jm.optimizers = _INIT[case]
    params = state.params["denoise"]
    tm = ConsistencyModel(datamodule=dm(), device="cpu", **kw)
    tstate = tm.init_state(0)
    net = tm.modules["denoise"]
    net.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    if "ema" in tstate.opt_states:
        tstate.opt_states["ema"] = {k: p.detach().clone() for k, p in net.named_parameters()}
    return jm, state, params, tm, tstate


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_igm_tpu(case):
    """igm_tpu's compiled train step gives the loss and raw l2 (its
    metrics), the gradients (its Adam first moment) and the new state."""
    jm, state, params, tm, tstate = _pair(case)
    imgs = np.random.default_rng(1).integers(0, 256, (BATCH, 8, 8, 3), np.uint8)
    labels = np.array([0, 1, 2, 1], np.int32)
    keys = jax.random.split(state.rng, 3)[1:]
    grid = jm._grid()
    logp = jnp.asarray(np.log(jcm.lognormal_index_weights(
        grid, float(jm.hparams.p_mean), float(jm.hparams.p_std))))
    i = jax.random.categorical(keys[0], logp, shape=(BATCH,))
    assert len(set(np.asarray(i).tolist())) > 1
    z = jax.random.normal(keys[1], imgs.shape)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.asarray(labels)))
    want_grads = adam_grads(new_state, "opt", "denoise", float(jm.hparams.b1))

    ti, tz = torch.from_numpy(np.array(i, np.int64)), torch.from_numpy(np.array(z))
    tx = tm.preprocess(torch.from_numpy(imgs))
    ty = torch.from_numpy(labels.astype(np.int64)) if tm.num_classes else None

    def step():
        new, step_metrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                                   torch.from_numpy(labels)), i=ti, noise=tz)
        assert new.step == 1
        np.testing.assert_allclose(float(step_metrics["train_loss/raw_l2"]),
                                   float(metrics["train_loss/raw_l2"]), rtol=1e-5)
        return step_metrics

    check_train_step(tm, "denoise", params, metrics["train_loss/loss"], want_grads, new_state,
                     lambda: tm.loss(tx, ti, tz, ty), step,
                     want_metrics={"train_loss/raw_l2": metrics["train_loss/raw_l2"]})
    check_ema(tstate, new_state, want_grads)


def test_teacher_branch_uses_the_live_weights():
    """f- runs on the live weights, not the EMA shadow: with the shadow
    moved away from the parameters the loss is unchanged.  (That no
    gradient flows through f- is held by the train-step parity above.)"""
    tm = ConsistencyModel(datamodule=dm(), device="cpu", hidden_dim=8, dim_mults=(1, 2),
                          n_grid=16, ema_decay=0.9)
    state = tm.init_state(0)
    x = torch.rand(2, 8, 8, 3) * 2 - 1
    i, z = torch.tensor([3, 9]), torch.randn(2, 8, 8, 3)
    loss, _ = tm.loss(x, i, z)
    for e in state.opt_states["ema"].values():
        e.add_(1.0)
    assert torch.equal(tm.loss(x, i, z)[0], loss)


def test_grids_match_igm_tpu():
    for n_grid in (8, 64):
        jm = jcm.ConsistencyModel(datamodule=to_node(dm()), hidden_dim=8, dim_mults=(1, 2),
                                  n_grid=n_grid)
        tm = ConsistencyModel(datamodule=dm(), device="cpu", hidden_dim=8, dim_mults=(1, 2),
                              n_grid=n_grid)
        np.testing.assert_array_equal(tm._grid(), jm._grid())
        for p_mean, p_std in ((-1.1, 2.0), (0.3, 0.7)):
            np.testing.assert_array_equal(
                lognormal_index_weights(tm._grid(), p_mean, p_std),
                jcm.lognormal_index_weights(jm._grid(), p_mean, p_std))


def test_gumbel_index_draw_follows_the_lognormal_law():
    """The train step's device-side index draw has the law of
    jax.random.categorical over log p: 400k draws within 4 standard
    errors of p(i) for every index."""
    tm = ConsistencyModel(datamodule=dm(), device="cpu", hidden_dim=8, dim_mults=(1, 2),
                          n_grid=16)
    p = np.exp(tm._logp.numpy().astype(np.float64))
    n = 400_000
    got = tm.draw_index(n, torch.Generator().manual_seed(0)).numpy()
    freq = np.bincount(got, minlength=len(p)) / n
    assert got.min() >= 0 and got.max() < len(p)
    np.testing.assert_array_less(np.abs(freq - p), 4 * np.sqrt(p * (1 - p) / n) + 1e-12)


def _draws(rng, shape, n_refine: int) -> list:
    """igm_tpu's multistep draws: the initial one, then one a refinement."""
    rng, r0 = jax.random.split(rng)
    out = [jax.random.normal(r0, shape)]
    if n_refine:
        out += [jax.random.normal(k, shape) for k in jax.random.split(rng, n_refine)]
    return [torch.from_numpy(np.array(a)) for a in out]


@pytest.mark.parametrize("case,steps,n_grid", [("unet_conditional_ema", 1, 16),
                                               ("unet_conditional_ema", 3, 16),
                                               ("dit", 3, 16), ("dit", 6, 6)])
def test_multistep_sample_matches_igm_tpu(case, steps, n_grid):
    """n_grid 6 at 6 steps: the rounded grid indices collide, and both
    deduplicate to 4 refinements."""
    jm, state, _, tm, _ = _pair(case, n_grid=n_grid)
    n_refine = len(tm.refinement_sigmas(steps))
    assert n_refine == (min(steps, 5) - 1 if n_grid == 6 else steps - 1)
    y = jnp.array([0, 2]) if jm.num_classes else None
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(functools.partial(jm.multistep_sample, n=2, steps=steps))(
        state, rng, y=y))
    got = tm.multistep_sample(2, steps=steps, noises=_draws(rng, (2, 8, 8, 3), n_refine),
                              y=None if y is None else torch.tensor([0, 2])).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=SAMPLE_TOL * scale, rtol=SAMPLE_TOL)


def test_train_resume_and_cli_samplers(tmp_path, monkeypatch):
    """experiment=consistency/mnist through the CLIs at a tiny width: train
    with validation samples, resume at the saved step, then the default
    sample and --sampler multistep from the checkpoints."""
    from igm_tpu_torch.cli import sample_main, train_main
    monkeypatch.chdir(tmp_path)
    tiny = ["experiment=consistency/mnist", "model.hidden_dim=8", "model.n_grid=8",
            "+model.sample_batch=4"]
    common = ["trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=4", "logger=null",
              "print_config=False", "optimized_metric=train_loss/loss",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    run = tmp_path / "logs" / "runs" / "consistency" / "mnist"
    for epochs, ckpts in ((1, ["step_2.pt"]), (2, ["step_2.pt", "step_4.pt"])):
        loss = train_main([*tiny, f"trainer.max_epochs={epochs}",
                           f"trainer.resume={run / 'checkpoints'}", *common])
        assert np.isfinite(loss)
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
    assert sorted(p.name for p in (run / "results").iterdir()) == ["0.jpg", "1.jpg"]
    ckpt = ["--ckpt", str(run / "checkpoints"), "--n", "3", "--device", "cpu"]
    default = sample_main([*tiny, *ckpt, "--out", str(tmp_path / "a.png")])
    multi = sample_main([*tiny, *ckpt, "--sampler", "multistep", "--out",
                         str(tmp_path / "b.png")])
    assert default.shape == (3, 28, 28, 1) and default.abs().max() <= 1.0
    assert torch.equal(default, multi)           # sample_steps (2) both ways
    one = sample_main([*tiny, *ckpt, "--sampler", "multistep", "--steps", "1", "--out",
                       str(tmp_path / "c.png")])
    assert not torch.equal(one, multi)
