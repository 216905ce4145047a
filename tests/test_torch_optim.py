"""The port's optimizers, schedules, train state and checkpoints
(igm_tpu_torch.core) against igm_tpu's optax-based ones, on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
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


# ------------------------------------------ stochastic rounding, cast Adam, clipping
def _jax_seed(key):
    """The uint32 seed igm_tpu's stochastic_round_bf16 derives from its key."""
    import jax
    return int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32))


@pytest.mark.parametrize("shape", [(1000,), (37, 513)], ids=["1d", "2d"])
@pytest.mark.parametrize("key", [0, 5])
def test_hash_noise_and_stochastic_rounding_bit_for_bit(shape, key):
    import jax
    from igm_tpu_torch.core.optim import hash_noise_u16, stochastic_round_bf16
    k = jax.random.PRNGKey(key)
    seed = _jax_seed(k)
    want = np.asarray(jax_optim._hash_noise_u16(shape, jnp.uint32(seed)))
    got = hash_noise_u16(shape, seed)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert got.shape == shape
    x = np.random.default_rng(key).normal(size=shape).astype(np.float32) * 10.0 ** (
        np.random.default_rng(key + 1).integers(-30, 30, size=shape))
    want_r = np.asarray(jax_optim.stochastic_round_bf16(jnp.asarray(x), k)).view(np.uint16)
    for s in (seed, torch.tensor(seed)):
        got_r = stochastic_round_bf16(torch.from_numpy(x), s)
        assert got_r.dtype == torch.bfloat16
        np.testing.assert_array_equal(got_r.view(torch.int16).numpy().view(np.uint16), want_r)


def _find_mu(opt_state):
    """The Adam state (the one with ``mu``) inside an optax state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    return next(s for s in map(_find_mu, opt_state) if s is not None) if isinstance(
        opt_state, tuple) else None


def _ulps(got: np.ndarray, want: np.ndarray, mantissa_bits: int) -> float:
    """The largest |got - want| in ulps of ``mantissa_bits`` at the larger
    magnitude (0 where equal)."""
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-38))) - mantissa_bits)
    return float((np.abs(got.astype(np.float64) - want) / ulp).max())


@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"), ("bfloat16", None),
                                    (None, "bfloat16")],
                         ids=["mu_nu_bf16", "mu_bf16_optax", "nu_bf16"])
def test_cast_adam_matches_igm_tpu_over_three_steps(dtypes):
    """igm_tpu's adam with moment dtypes (``_scale_by_adam_cast``, or
    optax's mu_dtype alone) against CastAdam on the same gradients: the
    moments within one ulp of their storage dtype (XLA may contract b*m +
    (1-b)*g into an FMA), the parameters within 2 float32 ulps of the
    update (lr * |update| <= lr * ~1)."""
    from igm_tpu_torch.core.optim import CastAdam
    mu_dt, nu_dt = dtypes
    jdt = {None: None, "bfloat16": jnp.bfloat16}
    tdt = {None: None, "bfloat16": torch.bfloat16}
    lr = jax_optim.step_lr(1e-3, 0.5, 1)
    tx = jax_optim.adam(lr, 0.9, 0.999, mu_dtype=jdt[mu_dt], nu_dtype=jdt[nu_dt])
    params = _tree(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    spec = adam(step_lr(1e-3, 0.5, 1), 0.9, 0.999, mu_dtype=tdt[mu_dt], nu_dtype=tdt[nu_dt])
    opt = spec.create(list(tparams.values()))
    assert isinstance(opt, CastAdam)
    opts = OptimizerSet().add("opt", spec, ["m"])
    for step in range(3):
        grads = _tree(10 + step)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opts._apply("opt", opt, list(tparams.values()),
                    [torch.from_numpy(grads[k]) for k in tparams], count=step)
        adam_state = _find_mu(opt_state)
        for k, p in tparams.items():
            st = opt.state[p]
            for key, want in (("exp_avg", adam_state.mu[k]), ("exp_avg_sq", adam_state.nu[k])):
                bits = 7 if st[key].dtype == torch.bfloat16 else 23
                assert st[key].dtype == {jnp.bfloat16: torch.bfloat16,
                                         jnp.float32: torch.float32}[want.dtype.type]
                assert _ulps(st[key].float().numpy(), np.asarray(want, np.float32),
                             bits) <= 1.0, (step, k, key)
            step_size = 1e-3 * 0.5 ** step
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       atol=2 * step_size * 2.0 ** -23 * 2, rtol=0)


def test_cast_adam_keeps_moment_dtypes_through_a_checkpoint():
    """Optimizer.load_state_dict casts moments to the parameter's dtype;
    CastAdam's stay bfloat16."""
    from igm_tpu_torch.core.state import load_optimizer_state
    p = torch.nn.Parameter(torch.randn(4, 3))
    spec = adam(1e-3, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    opt = spec.create([p])
    p.grad = torch.randn(4, 3)
    opt.step()
    saved = opt.state_dict()
    fresh = spec.create([torch.nn.Parameter(p.detach().clone())])
    assert not load_optimizer_state(fresh, saved)          # built anew
    st = next(iter(fresh.state.values()))
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    assert torch.equal(st["exp_avg"], saved["state"][0]["exp_avg"])


def test_moment_dtypes_from_the_environment(monkeypatch):
    monkeypatch.setenv("IGM_MU_DTYPE", "bfloat16")
    monkeypatch.setenv("IGM_NU_DTYPE", "float32")
    spec = adam(1e-3, nu_dtype=torch.bfloat16)
    assert spec.mu_dtype == torch.bfloat16 and spec.nu_dtype is None
    monkeypatch.delenv("IGM_MU_DTYPE")
    monkeypatch.delenv("IGM_NU_DTYPE")
    assert adam(1e-3).mu_dtype is None
    assert isinstance(adam(1e-3).create([torch.nn.Parameter(torch.zeros(2))]),
                      torch.optim.Adam)


@pytest.mark.parametrize("max_norm", [100.0, 0.5], ids=["below", "above"])
def test_clip_by_global_norm_then_adam_matches_optax(max_norm):
    """optax.chain(clip_by_global_norm, adam) against Adam(clip_norm=...):
    the global norm below max_norm leaves the gradients; above, they are
    scaled to it (not clip_grad_norm_'s max_norm / (norm + 1e-6))."""
    from igm_tpu_torch.core.optim import clip_by_global_norm
    tx = optax.chain(optax.clip_by_global_norm(max_norm), jax_optim.adam(1e-2, 0.9, 0.99))
    params = _tree(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    spec = adam(1e-2, 0.9, 0.99, clip_norm=max_norm)
    opt = spec.create(list(tparams.values()))
    opts = OptimizerSet().add("opt", spec, ["m"])
    for step in range(3):
        grads = _tree(10 + step)
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
        assert (norm < max_norm) == (max_norm == 100.0)
        tg = [torch.from_numpy(grads[k]) for k in tparams]
        clipped = clip_by_global_norm(tg, max_norm)
        want_c = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, None)[0]
        for k, c in zip(tparams, clipped):
            np.testing.assert_allclose(c.numpy(), np.asarray(want_c[k]), rtol=1e-6, atol=0)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opts._apply("opt", opt, list(tparams.values()), tg, count=step)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       atol=ATOL, rtol=RTOL)


def test_rmsprop_matches_optax_over_five_steps():
    """optax.rmsprop (eps inside the square root) against the port's
    RMSprop over five steps, gradients from 1e-5 to 1: where g**2 is near
    eps, sqrt(nu + eps) and torch.optim.RMSprop's sqrt(nu) + eps differ."""
    from igm_tpu_torch.core.optim import RMSprop, rmsprop
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32)}
    tx = jax_optim.rmsprop(5e-5, 0.99)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    spec = rmsprop(5e-5, 0.99)
    opt = spec.create(list(tparams.values()))
    assert isinstance(opt, RMSprop)
    opts = OptimizerSet().add("opt", spec, ["m"])
    plain = torch.from_numpy(params["w"].copy())
    ref = torch.optim.RMSprop([plain], lr=5e-5, alpha=0.99, eps=1e-8)
    scales = np.logspace(-5, 0, 30).reshape(6, 5).astype(np.float32)
    for step in range(5):
        g = (rng.normal(size=(6, 5)) * scales).astype(np.float32)
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opts._apply("opt", opt, list(tparams.values()), [torch.from_numpy(g)])
        plain.grad = torch.from_numpy(g)
        ref.step()
        np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]),
                                   atol=1e-9, rtol=1e-6)
        if step == 0:      # the first step: lr g / sqrt(0.01 g^2 + eps) against ~10 lr
            small = scales < 1e-4
            moved = np.abs(tparams["w"].numpy() - params["w"])[small]
            torch_moved = np.abs(plain.detach().numpy() - params["w"])[small]
            assert np.all(moved < 0.5 * torch_moved)
    assert float(opt.state[tparams["w"]]["step"]) == 5


def test_grouped_adam_and_clip_params_match_igm_tpu():
    """grouped_adam: one Adam, a learning rate a module (optax's
    multi_transform of one adam a module); clip_params: WGAN's clamp."""
    from igm_tpu_torch.core.optim import clip_params, grouped_adam
    mods = _two_modules()
    for p in mods.parameters():
        torch.nn.init.normal_(p, std=0.05, generator=torch.Generator().manual_seed(1))
    jparams = {m: {k: jnp.asarray(p.detach().numpy()) for k, p in mods[m].named_parameters()}
               for m in ("g", "d")}
    tx = jax_optim.grouped_adam({"g": 1e-3, "d": 5e-4}, 0.5, 0.999)
    opt_state = tx.init(jparams)
    opts = OptimizerSet().add("opt", grouped_adam({"g": 1e-3, "d": 5e-4}, 0.5, 0.999),
                              ["g", "d"])
    state = _state(mods, opts)
    opt = state.opt_states["opt"]
    assert [g["lr"] for g in opt.param_groups] == [1e-3, 5e-4]
    rng = np.random.default_rng(4)
    for step in range(3):
        grads = {m: {k: rng.normal(size=p.shape).astype(np.float32)
                     for k, p in mods[m].named_parameters()} for m in ("g", "d")}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opts.apply_grads(state, "opt", [torch.from_numpy(grads[m][k])
                                                for m in ("g", "d")
                                                for k, _ in mods[m].named_parameters()])
        for m in ("g", "d"):
            for k, p in mods[m].named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[m][k]),
                                           atol=ATOL, rtol=RTOL, err_msg=f"{m}.{k}")
    assert state.counts == {"opt": 3}
    clip_params(mods["d"], 0.01)
    want = jax_optim.clip_params(jparams["d"], 0.01)
    for k, p in mods["d"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want[k]))
    assert max(float(p.detach().abs().max()) for p in mods["g"].parameters()) > 0.01


def test_scheduled_rates_follow_each_optimizers_own_count():
    """Two optimizers with halving schedules (one update an epoch): ``a``
    updates three times and ``b`` once in four steps; each rate follows its
    own count (TrainState.counts), as each optax state counts its own
    updates, and a restore reads the counts back from the optimizers."""
    mods = _two_modules()
    opts = (OptimizerSet().add("a", adam(halving_lr(1e-2, 1, 1)), ["g"])
            .add("b", adam(halving_lr(1e-2, 1, 1)), ["d"]))
    state = _state(mods, opts)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    used = []
    for step, name in enumerate(("a", "a", "b", "a")):
        state, _, _ = opts.grad_step(state, name, lambda: (mods["d"](mods["g"](x)).sum(), {}))
        used.append(state.opt_states[name].param_groups[0]["lr"])
        state.step = step + 1
    assert used == [1e-2, 5e-3, 1e-2, 2.5e-3]
    assert state.counts == {"a": 3, "b": 1}
    saved = state.snapshot()
    state.counts = {}
    state.load_state_dict(saved)
    assert state.counts == {"a": 3, "b": 1}
