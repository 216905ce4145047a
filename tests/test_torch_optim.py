"""The port's optimizers, schedules, train state and checkpoints
(igm_tpu_torch.core) against igm_tpu's optax-based ones, on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from igm_tpu.core import optim as jax_optim  # noqa: E402
from igm_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from igm_tpu_torch.core.optim import (  # noqa: E402
    OptimizerSet, adam, halving_lr, step_lr)
from igm_tpu_torch.core.state import TrainState  # noqa: E402

torch.set_num_threads(1)

# float32; torch.optim.Adam and optax order the moment updates' roundings
# differently (lerp vs b*m + (1-b)*g), a few ulps of lr-sized updates
ATOL, RTOL = 1e-7, 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32) * 1e-3}


@pytest.mark.parametrize("lr", [2e-4, "step_lr"], ids=["const", "schedule"])
def test_adam_matches_optax_over_three_steps(lr):
    """b1=0.5 as the DDPM defaults; eps=1e-8 added to sqrt(v_hat)."""
    jax_lr = jax_optim.step_lr(1e-3, 0.5, 1) if lr == "step_lr" else lr
    torch_lr = step_lr(1e-3, 0.5, 1) if lr == "step_lr" else lr
    params = _tree(0)
    tx = jax_optim.adam(jax_lr, 0.5, 0.999)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adam(torch_lr, 0.5, 0.999).create(list(tparams.values()))
    spec = OptimizerSet().add("opt", adam(torch_lr, 0.5, 0.999), ["m"])
    for step in range(3):
        grads = _tree(10 + step)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        spec._apply("opt", opt, list(tparams.values()),
                    [torch.from_numpy(grads[k]) for k in tparams])
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       atol=ATOL, rtol=RTOL)


def test_schedules_match_igm_tpu():
    for count in (0, 1, 5, 6, 17):
        assert step_lr(1e-3, 0.9, 3)(count) == pytest.approx(
            float(jax_optim.step_lr(1e-3, 0.9, 3)(count)), rel=1e-12)
        assert halving_lr(2e-4, 2, 3)(count) == pytest.approx(
            float(jax_optim.halving_lr(2e-4, 2, 3)(count)), rel=1e-12)


def _two_modules(seed=0):
    torch.manual_seed(seed)
    return nn.ModuleDict({"g": nn.Linear(3, 2), "d": nn.Linear(2, 1)})


def _state(mods, opts):
    return TrainState(modules=mods, opt_states=opts.init(mods),
                      generator=torch.Generator().manual_seed(0))


def test_optimizer_set_steps_only_its_modules():
    mods = _two_modules()
    opts = (OptimizerSet().add("opt_g", adam(1e-2), ["g"])
            .add("opt_d", adam(1e-2), ["d"]))
    assert opts.names() == ["opt_g", "opt_d"] and opts.modules_of("opt_d") == ("d",)
    state = _state(mods, opts)
    before = {k: v.clone() for k, v in mods.state_dict().items()}
    x = torch.randn(4, 3)

    def loss_fn():
        loss = mods["d"](mods["g"](x)).square().mean()
        return loss, {"loss": loss.detach()}

    state, loss, aux = opts.grad_step(state, "opt_g", loss_fn)
    after = mods.state_dict()
    assert not torch.equal(after["g.weight"], before["g.weight"])
    assert torch.equal(after["d.weight"], before["d.weight"])
    assert torch.equal(after["d.bias"], before["d.bias"])
    assert all(p.grad is None for p in mods.parameters())
    assert float(loss) == float(aux["loss"])


def test_apply_grads_equals_grad_step():
    runs = []
    for how in ("grad_step", "apply_grads"):
        mods = _two_modules(1)
        opts = OptimizerSet().add("opt", adam(1e-2), ["g", "d"])
        state = _state(mods, opts)
        x = torch.randn(4, 3, generator=torch.Generator().manual_seed(2))

        def loss_fn():
            return mods["d"](mods["g"](x)).square().mean(), {}

        if how == "grad_step":
            opts.grad_step(state, "opt", loss_fn)
        else:
            grads = torch.autograd.grad(loss_fn()[0], list(mods.parameters()))
            opts.apply_grads(state, "opt", grads)
        runs.append(mods.state_dict())
    for k in runs[0]:
        torch.testing.assert_close(runs[0][k], runs[1][k], atol=0, rtol=0)


def _trained_state(steps, ema=True):
    mods = _two_modules(3)
    opts = OptimizerSet().add("opt", adam(1e-2), ["g", "d"])
    state = _state(mods, opts)
    if ema:
        state.opt_states["ema"] = {k: p.detach().clone()
                                   for k, p in mods.named_parameters()}
    for _ in range(steps):
        x = torch.randn(4, 3, generator=state.generator)
        opts.grad_step(state, "opt",
                       lambda: (mods["d"](mods["g"](x)).square().mean(), {}))
        if ema:
            with torch.no_grad():
                for k, p in mods.named_parameters():
                    state.opt_states["ema"][k].mul_(0.9).add_(p, alpha=0.1)
        state.step += 1
    return state, opts


def test_checkpoint_restore_continues_the_trajectory_exactly(tmp_path):
    """Save after 2 steps, restore into a fresh state, take 2 more: the same
    parameters, optimizer moments, EMA shadow and random stream as 4 straight."""
    straight, _ = _trained_state(4)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    half, _ = _trained_state(2)
    mgr.save(half.step, half)
    mgr.wait()
    assert mgr.latest_step() == 2

    fresh, opts = _trained_state(0)
    mgr.restore(fresh)
    assert fresh.step == 2
    mods = fresh.modules
    for _ in range(2):
        x = torch.randn(4, 3, generator=fresh.generator)
        opts.grad_step(fresh, "opt",
                       lambda: (mods["d"](mods["g"](x)).square().mean(), {}))
        with torch.no_grad():
            for k, p in mods.named_parameters():
                fresh.opt_states["ema"][k].mul_(0.9).add_(p, alpha=0.1)
        fresh.step += 1
    want, got = straight.state_dict(), fresh.state_dict()
    for k in want["params"]:
        torch.testing.assert_close(got["params"][k], want["params"][k], atol=0, rtol=0)
    for k in want["opt_states"]["ema"]:
        torch.testing.assert_close(got["opt_states"]["ema"][k],
                                   want["opt_states"]["ema"][k], atol=0, rtol=0)
    for pid, s in want["opt_states"]["opt"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(got["opt_states"]["opt"]["state"][pid][key],
                                       s[key], atol=0, rtol=0)
    assert torch.equal(got["generator"], want["generator"])


def test_checkpoint_manager_keeps_the_newest_two(tmp_path):
    state, _ = _trained_state(1, ema=False)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step in (1, 2, 3):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2.pt", "step_3.pt"]


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """save() copies the state before it returns: a later in-place update
    does not reach the file being written."""
    state, opts = _trained_state(1, ema=False)
    mgr = CheckpointManager(str(tmp_path))
    want = {k: v.clone() for k, v in state.modules.state_dict().items()}
    mgr.save(1, state)
    with torch.no_grad():
        for p in state.modules.parameters():
            p.add_(1.0)
    mgr.wait()
    saved = torch.load(tmp_path / "step_1.pt", weights_only=True)
    for k, v in want.items():
        torch.testing.assert_close(saved["params"][k], v, atol=0, rtol=0)


def test_restore_rejects_a_state_of_another_shape(tmp_path):
    state, _ = _trained_state(1, ema=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    other, _ = _trained_state(0, ema=False)
    with pytest.raises(ValueError):
        mgr.restore(other)
