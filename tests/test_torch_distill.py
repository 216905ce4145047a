"""The port's progressive distillation (igm_tpu_torch/models/distill.py)
against igm_tpu's, at a tiny size (UNet hidden 8 at (1, 2), 8x8, T = 64,
4 student steps; a DiT).

The teacher's weights differ from the student's (another perturbation of
the same init), so a swap of the two would show.  Train steps:
igm_tpu's key schedule replayed (``state.next_rng(2)``: the student index,
then the noise), the draws handed to the port's ``train_step``, the
distillation target igm_tpu's (it is a constant of the step, held on its
own below); the loss, every gradient and the parameters after one Adam
step at tests/test_torch_train_step.py's tolerances, the teacher
untouched.  The distillation target and ``student_sample`` from the same
inputs and draws, float32, atol = rtol = 1e-4 of the output's largest
magnitude.  Then the teacher splice from the port's own checkpoint
directory, and the CLIs.
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
from igm_tpu.models.distill import ProgressiveDistillation as JaxDistill  # noqa: E402
from igm_tpu.ops import diffusion as jgd  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.distill import ProgressiveDistillation  # noqa: E402
from tests._torch_parity import (GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_RTOL, LR,  # noqa: E402
                                 _flatten, _perturb, adam_grads, check_train_step, dm)

torch.set_num_threads(1)

TOL = 1e-4
BATCH = 4
CASES = {"unet": dict(hidden_dim=8, dim_mults=(1, 2)),
         "dit": dict(network="dit", hidden_dim=32, depth=2, heads=2)}
_INIT = {}


def _pair(case: str, **kw):
    """igm_tpu's model with perturbed student and teacher weights (its state
    made once per case) and the port's with the same weights."""
    kw = {**CASES[case], "lr": LR, "compute_dtype": "float32", "timesteps": 64,
          "student_steps": 4, **kw}
    jm = JaxDistill(datamodule=to_node(dm()), **kw)
    jm.steps_per_epoch = 1
    if case not in _INIT:
        state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
        init = state.params["denoise"]
        state = state.replace(params={"denoise": _perturb(init, seed=1)},
                              opt_states={**state.opt_states,
                                          "teacher": _perturb(init, seed=2)})
        _INIT[case] = (state, jm.optimizers)
    state, jm.optimizers = _INIT[case]
    tm = ProgressiveDistillation(datamodule=dm(), device="cpu", **kw)
    tstate = tm.init_state(0)
    net = tm.modules["denoise"]
    net.load_state_dict(flax_to_torch(_flatten(state.params["denoise"])), strict=True)
    teacher = flax_to_torch(_flatten(state.opt_states["teacher"]))
    tstate.opt_states["teacher"] = {k: teacher[k].clone() for k, _ in net.named_parameters()}
    return jm, state, tm, tstate


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert np.isfinite(scale) and scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * scale, rtol=TOL)


def test_phase_grid_matches_igm_tpu():
    for timesteps, student in ((64, 4), (256, 8), (1000, 8), (1000, 500), (16, 1)):
        jm = JaxDistill(datamodule=to_node(dm()), hidden_dim=8, dim_mults=(1, 2),
                        timesteps=timesteps, student_steps=student)
        tm = ProgressiveDistillation(datamodule=dm(), device="cpu", hidden_dim=8,
                                     dim_mults=(1, 2), timesteps=timesteps,
                                     student_steps=student)
        np.testing.assert_array_equal(tm._phase_grid(), jm._phase_grid())
        assert tm.hparams.ddim_steps == student
        assert (tm.hparams.loss_type, tm.hparams.parameterization) == ("l2", "v")


def test_constructor_guards():
    with pytest.raises(ValueError, match="unconditional"):
        ProgressiveDistillation(datamodule=dm(), device="cpu", hidden_dim=8,
                                dim_mults=(1, 2), num_classes=3)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="student_steps"):
            ProgressiveDistillation(datamodule=dm(), device="cpu", hidden_dim=8,
                                    dim_mults=(1, 2), timesteps=64, student_steps=bad)


def _igm_tpu_step(jm, state, tm, monkeypatch):
    """igm_tpu's compiled train step on a batch, the draws it made
    (``state.next_rng(2)``: the student index, then the noise), and the
    port's ``_distill_target`` replaced by igm_tpu's compiled one on the same
    draws (see test_distill_target_matches_igm_tpu for why) -> (new state,
    metrics, its gradients, imgs, labels, i, noise)."""
    imgs = np.random.default_rng(1).integers(0, 256, (BATCH, 8, 8, 3), np.uint8)
    labels = np.zeros(BATCH, np.int32)
    keys = jax.random.split(state.rng, 3)[1:]
    i = jax.random.randint(keys[0], (BATCH,), 1, 5)
    assert len(set(np.asarray(i).tolist())) > 1
    noise = jax.random.normal(keys[1], imgs.shape)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.asarray(labels)))
    want_grads = adam_grads(new_state, "opt", "denoise", float(jm.hparams.b1))
    grid = jnp.asarray(jm._phase_grid())
    t = grid[2 * i]
    x_t = jgd.q_sample(jm.tables, jm.preprocess(jnp.asarray(imgs)), t, noise)
    target = torch.from_numpy(np.array(jax.jit(jm._distill_target)(
        state, x_t, t, grid[2 * i - 1], grid[2 * i - 2])))
    monkeypatch.setattr(tm, "_distill_target", lambda *args: target)
    return (new_state, metrics, want_grads, imgs, labels,
            torch.from_numpy(np.array(i, np.int64)), torch.from_numpy(np.array(noise)))


@pytest.mark.parametrize("case", ["unet", "dit"])
def test_train_step_matches_igm_tpu(case, monkeypatch):
    """igm_tpu's compiled train step gives the loss (its metric), the
    gradients (its Adam first moment) and the new parameters; both leave
    the teacher as it was."""
    jm, state, tm, tstate = _pair(case)
    new_state, metrics, want_grads, imgs, labels, ti, tnoise = _igm_tpu_step(
        jm, state, tm, monkeypatch)
    teacher = {k: v.clone() for k, v in tstate.opt_states["teacher"].items()}
    tx = tm.preprocess(torch.from_numpy(imgs))

    def step():
        new, step_metrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                                   torch.from_numpy(labels)), i=ti,
                                          noise=tnoise)
        assert new.step == 1
        return step_metrics

    check_train_step(tm, "denoise", state.params["denoise"], metrics["train_loss/loss"],
                     want_grads, new_state, lambda: tm.distill_loss(tstate, tx, ti, tnoise),
                     step)
    for k, v in tstate.opt_states["teacher"].items():
        assert torch.equal(v, teacher[k]), k


def test_eps_loss_and_gradients_match_igm_tpu(monkeypatch):
    """The eps-parameterised x0 (x_t - sigma pred) / alpha: the loss and
    every gradient at check_train_step's tolerances.  Its parameters after
    Adam's first step are not compared: alpha ~ 8e-4 at t = T-1 puts the
    loss near 5e5 (igm_tpu's reason for v by default), so gradient entries
    below 1e-5 of the largest are rounding noise, and Adam's first step
    moves each parameter by lr times the sign of its gradient."""
    jm, state, tm, tstate = _pair("dit", parameterization="eps")
    _, metrics, want_grads, imgs, _, ti, tnoise = _igm_tpu_step(jm, state, tm, monkeypatch)
    net = tm.modules["denoise"]
    names = [k for k, _ in net.named_parameters()]
    loss, _ = tm.distill_loss(tstate, tm.preprocess(torch.from_numpy(imgs)), ti, tnoise)
    grads = dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))
    want_loss = float(metrics["train_loss/loss"])
    assert want_loss > 1e3
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    want_g = {k: v.numpy() for k, v in flax_to_torch(_flatten(want_grads)).items()}
    scale = max(np.abs(g).max() for g in want_g.values())
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), want_g[k], atol=GRAD_ATOL_SCALE * scale,
                                   rtol=GRAD_RTOL, err_msg=k)


def test_distill_target_matches_igm_tpu():
    """Two teacher DDIM steps and the implied target, against igm_tpu's
    function evaluated op by op (each operation rounded once, as here), on
    every student time; against its compiled program on the times below
    T-1.  At t = T-1 the first step's implied x0 (x - sqrt(1 - a) eps) /
    sqrt(a) cancels catastrophically (1 / sqrt(a) = 1299 at T = 64): there
    XLA's fused program differs from igm_tpu's own op-by-op result by ~2e-4
    of the target, as the port does.  Then the teacher's weights, not the
    student's: with the student's the target moves."""
    jm, state, tm, tstate = _pair("unet")
    rng = np.random.default_rng(3)
    x_t = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    grid = tm._phase_grid()
    i = np.array([1, 2, 3, 4])
    t, tmid, tp = grid[2 * i], grid[2 * i - 1], grid[2 * i - 2]
    args = (jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(tmid), jnp.asarray(tp))
    op_by_op = np.asarray(jm._distill_target(state, *args))
    compiled = np.asarray(jax.jit(jm._distill_target)(state, *args))
    tt = [torch.from_numpy(a.astype(np.int64)) for a in (t, tmid, tp)]
    got = tm._distill_target(tstate, torch.from_numpy(x_t), *tt)
    _close(got, op_by_op)
    below = t < tm.timesteps - 1
    assert below.sum() == 3
    _close(got[below], compiled[below])
    swapped = dict(tstate.opt_states, teacher={
        k: p.detach().clone() for k, p in tm.modules["denoise"].named_parameters()})
    other = tm._distill_target(type(tstate)(tstate.modules, swapped, tstate.generator),
                               torch.from_numpy(x_t), *tt)
    assert (other - got).abs().max() > 100 * TOL * float(np.abs(op_by_op).max())


@pytest.mark.parametrize("case", ["unet", "dit"])
def test_student_sample_matches_igm_tpu(case):
    jm, state, tm, _ = _pair(case)
    rng = jax.random.PRNGKey(11)
    want = jax.jit(functools.partial(jm.student_sample, n=2))(state, rng)
    got = tm.student_sample(2, noises=[torch.from_numpy(
        np.array(jax.random.normal(rng, (2, 8, 8, 3))))])
    _close(got, want)


def _ddpm_checkpoint(directory: Path, hidden_dim: int = 8) -> dict:
    """A port DDPM checkpoint whose EMA shadow differs from its parameters;
    returns the shadow."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    from igm_tpu_torch.models.ddpm import DDPM
    teacher = DDPM(datamodule=dm(), device="cpu", hidden_dim=hidden_dim, dim_mults=(1, 2),
                   timesteps=64, ema_decay=0.999, parameterization="eps")
    teacher.steps_per_epoch = 10
    state = teacher.init_state(5)
    for e in state.opt_states["ema"].values():
        e.add_(1.0)
    manager = CheckpointManager(str(directory))
    manager.save(0, state)
    manager.wait()
    return {k: v.clone() for k, v in state.opt_states["ema"].items()}


def test_teacher_ckpt_splice(tmp_path):
    """init_state with teacher_ckpt (the port's checkpoint directory): the
    student and the teacher are the teacher's EMA shadow; a config whose
    denoiser differs raises; a directory without the port's checkpoints
    (an orbax one) raises naming it."""
    ema = _ddpm_checkpoint(tmp_path / "ckpt")
    kw = dict(datamodule=dm(), device="cpu", dim_mults=(1, 2), timesteps=64,
              student_steps=4, parameterization="eps", teacher_ckpt=str(tmp_path / "ckpt"))
    m = ProgressiveDistillation(hidden_dim=8, **kw)
    state = m.init_state(0)
    for k, p in m.modules["denoise"].named_parameters():
        assert torch.equal(p.detach(), ema[k]), k
        assert torch.equal(state.opt_states["teacher"][k], ema[k]), k
    with pytest.raises(ValueError, match="shape mismatch"):
        ProgressiveDistillation(hidden_dim=16, **kw).init_state(0)
    (tmp_path / "orbax" / "0").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="orbax"):
        ProgressiveDistillation(hidden_dim=8, **{**kw, "teacher_ckpt": str(tmp_path / "orbax")}
                                ).init_state(0)


def test_teacher_ckpt_starts_the_ema_shadow_from_the_teacher(tmp_path):
    ema = _ddpm_checkpoint(tmp_path / "ckpt")
    m = ProgressiveDistillation(datamodule=dm(), device="cpu", hidden_dim=8, dim_mults=(1, 2),
                                timesteps=64, student_steps=4, ema_decay=0.9,
                                teacher_ckpt=str(tmp_path / "ckpt"))
    state = m.init_state(0)
    for k, v in state.opt_states["ema"].items():
        assert torch.equal(v, ema[k]), k


def test_distill_from_a_port_checkpoint_through_the_clis(tmp_path, monkeypatch):
    """A ddpm/mnist teacher trained by the train CLI (v-prediction, T = 16,
    tiny width), then experiment=distill/mnist from its checkpoints: train,
    resume, and the sampling CLI (the student's sampler and --sampler ddim
    at student_steps)."""
    from igm_tpu_torch.cli import sample_main, train_main
    monkeypatch.chdir(tmp_path)
    width = ["model.hidden_dim=8", "model.dim_mults=[1,2]", "model.timesteps=16",
             "+model.sample_batch=4"]
    common = ["trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=4", "logger=null",
              "print_config=False", "optimized_metric=train_loss/loss",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    teacher = tmp_path / "logs" / "runs" / "ddpm" / "mnist" / "checkpoints"
    assert np.isfinite(train_main(["experiment=ddpm/mnist", *width,
                                   "+model.parameterization=v", "trainer.max_epochs=1",
                                   *common]))
    tiny = ["experiment=distill/mnist", *width, "model.student_steps=4",
            f"model.teacher_ckpt={teacher}"]
    run = tmp_path / "logs" / "runs" / "distill" / "mnist"
    for epochs, ckpts in ((1, ["step_2.pt"]), (2, ["step_2.pt", "step_4.pt"])):
        loss = train_main([*tiny, f"trainer.max_epochs={epochs}",
                           f"trainer.resume={run / 'checkpoints'}", *common])
        assert np.isfinite(loss)
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
    saved = torch.load(run / "checkpoints" / "step_4.pt", weights_only=True)
    start = torch.load(teacher / "step_2.pt", weights_only=True)["params"]
    for k, v in saved["opt_states"]["teacher"].items():
        assert torch.equal(v, start[f"denoise.{k}"]), k
    ckpt = ["--ckpt", str(run / "checkpoints"), "--n", "3", "--device", "cpu"]
    student = sample_main([*tiny, *ckpt, "--out", str(tmp_path / "a.png")])
    ddim = sample_main([*tiny, *ckpt, "--sampler", "ddim", "--out", str(tmp_path / "b.png")])
    assert student.shape == ddim.shape == (3, 28, 28, 1)
    assert student.abs().max() <= 1.0 and ddim.abs().max() <= 1.0
