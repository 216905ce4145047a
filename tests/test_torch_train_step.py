"""The port's DDPM train step against igm_tpu's, at a tiny size.

Both models hold the same denoiser weights (Flax init, perturbed, converted
through igm_tpu_torch.interop); the timesteps, noise and label-drop mask
are igm_tpu's own draws (its key schedule replayed: ``state.next_rng(2 or
3)``, then randint, normal, bernoulli) and are handed to the port's
``train_step``.  Compared: the loss, every parameter gradient (JAX side:
``jax.value_and_grad`` of the same loss), the parameters after one full
Adam step, and the EMA shadow.
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
from igm_tpu.models.ddpm import DDPM as JaxDDPM  # noqa: E402
from igm_tpu.ops import diffusion as jgd  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.ddpm import DDPM  # noqa: E402

torch.set_num_threads(1)

DM = {"width": 8, "height": 8, "channels": 3,
      "transforms": {"convert": True, "normalize": True}}
T_STEPS, BATCH, LR = 20, 4, 2e-4
# float32: the loss is a mean over 768 elements of UNet outputs that agree to
# a few ulps (test_torch_unet); gradients sum over the batch and the image in
# another order, a few ulps of the largest gradient entry
LOSS_RTOL = 1e-5
GRAD_ATOL_SCALE, GRAD_RTOL = 1e-5, 1e-4
# Adam's first step moves a parameter by lr * g / (|g| + 1e-8): where |g| >
# 1e-6 that is lr * sign(g) up to 1%, so the parameters after the step agree
# to f32 rounding of p - lr * sign(g); smaller gradients are held to the
# step's bound, |change| <= lr
PARAM_ATOL, PARAM_RTOL, G_FLOOR = 1e-6, 1e-6, 1e-6


def _flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_torch(tree) -> dict:
    return {k: v.numpy() for k, v in flax_to_torch(_flatten(tree)).items()}


CASES = {
    "l1_eps": {},
    "v_min_snr": dict(parameterization="v", snr_gamma=5.0, loss_type="l2"),
    "conditional_drop": dict(num_classes=3, cond_drop_prob=0.5),
    "ema": dict(ema_decay=0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_igm_tpu(case):
    kw = dict(hidden_dim=8, dim_mults=(1, 2), timesteps=T_STEPS, lr=LR,
              compute_dtype="float32", **CASES[case])
    jm = JaxDDPM(datamodule=to_node(DM), **kw)
    jm.steps_per_epoch = 1
    state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        state.params["denoise"])
    opt_states = dict(state.opt_states)
    if "ema" in opt_states:
        opt_states["ema"] = params
    state = state.replace(params={"denoise": params}, opt_states=opt_states)

    imgs = rng.integers(0, 256, (BATCH, 8, 8, 3), np.uint8)
    labels = np.array([0, 1, 2, 1], np.int32)
    nc = jm.num_classes
    # igm_tpu's draws: next_rng(2 or 3) splits the carried key, then
    keys = jax.random.split(state.rng, (3 if nc else 2) + 1)[1:]
    t = jax.random.randint(keys[0], (BATCH,), 0, T_STEPS)
    noise = jax.random.normal(keys[1], imgs.shape)
    drop = (jax.random.bernoulli(keys[2], float(jm.hparams.cond_drop_prob), (BATCH,))
            if nc else None)
    if nc:
        assert 0 < int(drop.sum()) < BATCH      # both branches of the drop occur

    x0 = jm.preprocess(jnp.asarray(imgs))
    y = (jnp.where(drop, nc, jnp.asarray(labels)),) if nc else ()

    def jax_loss(p):
        x_noisy = jgd.q_sample(jm.tables, x0, t, noise)
        target = (jgd.v_target(jm.tables, x0, t, noise)
                  if jm.hparams.parameterization == "v" else noise)
        w = jgd.loss_weight(jm.tables, t, x0.ndim, jm.hparams.parameterization,
                            float(jm.hparams.snr_gamma))
        pred, _ = jm.modules.apply("denoise", {"denoise": p}, state.mutables,
                                   x_noisy, t, *y)
        err = target - pred
        return (w * (jnp.abs(err) if jm.hparams.loss_type == "l1" else err ** 2)).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                        jnp.asarray(labels)))
    assert float(metrics["train_loss/loss"]) == pytest.approx(float(want_loss), rel=1e-6)

    tm = DDPM(datamodule=DM, device="cpu", **kw)
    tstate = tm.init_state(0)
    net = tm.modules["denoise"]
    net.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    if "ema" in tstate.opt_states:
        tstate.opt_states["ema"] = {k: p.detach().clone()
                                    for k, p in net.named_parameters()}
    tt = torch.from_numpy(np.array(t, np.int64))
    tnoise = torch.from_numpy(np.array(noise))
    tdrop = None if drop is None else torch.from_numpy(np.array(drop))
    ty = None
    if nc:
        ty = torch.where(tdrop, torch.tensor(nc), torch.from_numpy(labels).long())
    loss, _ = tm.loss(tm.preprocess(torch.from_numpy(imgs)), tt, tnoise, ty)
    names = [k for k, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    want_g = _to_torch(want_grads)
    scale = max(np.abs(g).max() for g in want_g.values())
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), want_g[k],
                                   atol=GRAD_ATOL_SCALE * scale, rtol=GRAD_RTOL,
                                   err_msg=k)

    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                              torch.from_numpy(labels)),
                                     t=tt, noise=tnoise, drop=tdrop)
    assert tstate.step == 1
    np.testing.assert_allclose(float(tmetrics["train_loss/loss"]), float(want_loss),
                               rtol=LOSS_RTOL)
    want_p = _to_torch(new_state.params["denoise"])
    before = _to_torch(params)
    for k, p in net.named_parameters():
        big = np.abs(want_g[k]) > G_FLOOR
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], want_p[k][big], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
        assert np.all(np.abs(got - before[k]) <= LR * (1 + 1e-3)), k
    if "ema" in tstate.opt_states:
        want_e = _to_torch(new_state.opt_states["ema"])
        for k, e in tstate.opt_states["ema"].items():
            big = np.abs(want_g[k]) > G_FLOOR
            np.testing.assert_allclose(e.numpy()[big], want_e[k][big],
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)
