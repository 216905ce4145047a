"""What the port's train-step parity tests share: Flax trees flattened by
``/``-joined path, perturbed weights, and the check of one train step
against igm_tpu's (the loss, every gradient, the parameters after one
Adam step) at tests/test_torch_train_step.py's tolerances."""
import numpy as np
import torch

import jax

from igm_tpu_torch.interop import flax_to_torch

# the tolerances of tests/test_torch_train_step.py: float32, the loss a mean
# of outputs that agree to a few ulps; gradients to a few ulps of the
# largest entry; Adam's first step moves a parameter by lr * sign(g) where
# |g| > G_FLOOR, and by at most lr elsewhere
LOSS_RTOL = 1e-5
GRAD_ATOL_SCALE, GRAD_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL, G_FLOOR = 1e-6, 1e-6, 1e-6
LR = 2e-4


def dm(c: int = 3, size: int = 8) -> dict:
    return {"width": size, "height": size, "channels": c,
            "transforms": {"convert": True, "normalize": True}}


def _flatten(tree) -> dict:
    return {"/".join(k.key for k in path): (v if isinstance(v, jax.ShapeDtypeStruct)
                                             else np.asarray(v))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(tree, seed: int = 1):
    """Every leaf + 0.05 N(0, 1): adaLN-Zero and zero biases would make a
    comparison at init vacuous."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32), tree)


def adam_grads(new_state, opt_name: str, module: str, b1: float):
    """The gradients of igm_tpu's train step, read back from its Adam first
    moment after one step (mu = (1 - b1) g), so one compiled train step
    gives the loss, the gradients and the new parameters."""
    adam = next(s for s in new_state.opt_states[opt_name] if hasattr(s, "mu"))
    assert int(adam.count) == 1
    return jax.tree_util.tree_map(lambda m: m / (1.0 - b1), adam.mu[module])


def check_ema(tstate, new_state, want_grads):
    """The port's EMA shadow after one step against igm_tpu's, where the
    step moved the parameter (|g| > G_FLOOR, as check_train_step holds the
    parameters)."""
    if "ema" not in tstate.opt_states:
        return
    want_e = {k: v.numpy() for k, v in flax_to_torch(
        _flatten(new_state.opt_states["ema"])).items()}
    want_g = {k: v.numpy() for k, v in flax_to_torch(_flatten(want_grads)).items()}
    for k, e in tstate.opt_states["ema"].items():
        big = np.abs(want_g[k]) > G_FLOOR
        np.testing.assert_allclose(e.numpy()[big], want_e[k][big], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


def check_train_step(tm, module, params, want_loss, want_grads, new_state, torch_loss,
                     torch_step, want_metrics=None):
    """The port's loss and gradients (``torch_loss()``), then one train step
    (``torch_step()``), against igm_tpu's at the tolerances above."""
    net = tm.modules[module]
    net.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    names = [k for k, _ in net.named_parameters()]
    loss, tmetrics = torch_loss()
    grads = dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    want_g = {k: v.numpy() for k, v in flax_to_torch(_flatten(want_grads)).items()}
    scale = max(np.abs(g).max() for g in want_g.values())
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), want_g[k], atol=GRAD_ATOL_SCALE * scale,
                                   rtol=GRAD_RTOL, err_msg=k)
    for key, value in (want_metrics or {}).items():
        np.testing.assert_allclose(float(tmetrics[key]), float(value), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    before = {k: p.detach().clone().numpy() for k, p in net.named_parameters()}
    step_metrics = torch_step()
    np.testing.assert_allclose(float(step_metrics["train_loss/loss"]), float(want_loss),
                               rtol=LOSS_RTOL)
    want_p = {k: v.numpy() for k, v in flax_to_torch(
        _flatten(new_state.params[module])).items()}
    for k, p in net.named_parameters():
        big = np.abs(want_g[k]) > G_FLOOR
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], want_p[k][big], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
        assert np.all(np.abs(got - before[k]) <= LR * (1 + 1e-3)), k
