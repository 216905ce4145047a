"""The port's RealNVP (igm_tpu_torch/models/realnvp.py) against igm_tpu's,
on the CPU, at 8x8 (1 and 3 channels), hidden 16, couplings [2, 2, 2].

Tolerances, float32: z, the logdet and bpd with igm_tpu's dequantisation
draw to atol 1e-5 (with perturbed weights, so the couplings are not the
identity); the analytic logdet against the autodiff Jacobian's log|det| to
1e-4 (tests/test_realnvp.py's); inverse(forward(x)) to 2e-4 (its); the
clipped train step's loss rtol 1e-5, its gradients 1e-5 of the largest and
the parameters after one Adam step at tests/_torch_parity.py's tolerances,
with the global norm below and above ``grad_clip``; samples from the same z
to atol 1e-5.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models import realnvp as jnvp  # noqa: E402
from igm_tpu_torch.interop import flax_key_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.models import realnvp as tnvp  # noqa: E402
from tests._torch_parity import G_FLOOR, PARAM_ATOL, PARAM_RTOL, _flatten, _perturb  # noqa: E402

torch.set_num_threads(1)

KW = dict(hidden_dim=16, n_couplings=(2, 2, 2), lr=1e-3)


def _dm(c):
    return {"width": 8, "height": 8, "channels": c,
            "transforms": {"convert": True, "normalize": True}}


_STATES = {}


def _pair(c=1, **kw):
    """igm_tpu's RealNVP with its weights moved by 0.05 N(0, 1) (its state
    made once per configuration), the port's with the same weights."""
    jm = jnvp.RealNVP(to_node(_dm(c)), **{**KW, **kw})
    jm.steps_per_epoch = 1
    key = (c, tuple(sorted(kw.items())))
    if key not in _STATES:
        state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
        _STATES[key] = (state.replace(params=_perturb(state.params, seed=2)), jm.optimizers)
    state, jm.optimizers = _STATES[key]
    tm = tnvp.RealNVP(_dm(c), device="cpu", **{**KW, **kw})
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(flax_to_torch(_flatten(state.params)), strict=True)
    return jm, state, tm, tstate


def _imgs(c, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8, c), np.uint8)


def test_squeeze_round_trip_and_layout():
    x = np.random.default_rng(0).normal(size=(3, 8, 6, 2)).astype(np.float32)
    z = tnvp.squeeze(torch.from_numpy(x))
    assert z.shape == (3, 4, 3, 8)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jnvp.squeeze(jnp.asarray(x))))
    np.testing.assert_array_equal(tnvp.unsqueeze(z).numpy(), x)


def test_interop_covers_every_parameter():
    _, state, tm, _ = _pair(3)
    flat = _flatten(state.params)
    assert set(flax_to_torch(flat)) == set(tm.modules.state_dict())
    assert "flow/check1_0/net/Conv_0/Conv_0/kernel" in flat
    assert "flow/check1_0/net/Conv_2/kernel" in flat and "flow/chan_1/net/s_scale" in flat
    for path, value in flat.items():
        assert tm.modules.state_dict()[flax_key_to_torch(path)].numel() == value.size, path


def test_identity_at_init_and_closed_form_bpd():
    """Zero-init Conv_2: the flow is the squeeze with logdet 0, and bpd at
    init is the closed-form logit-normal value (numpy)."""
    tm = tnvp.RealNVP(_dm(1), device="cpu", **KW)
    imgs = torch.from_numpy(_imgs(1))
    u = torch.rand(imgs.shape, generator=torch.Generator().manual_seed(2))
    y = ((tm._to_unit(imgs) * 255.0 + u) / 256.0).numpy().astype(np.float64)
    a = 0.05
    q = a + (1 - 2 * a) * y
    z0 = np.log(q) - np.log(1 - q)
    with torch.no_grad():
        z, ld = tm.flow(torch.from_numpy(z0.astype(np.float32)))
        bpd = tm.bpd(imgs, u)
    np.testing.assert_allclose(tnvp.unsqueeze(z).numpy(), z0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), 0.0, atol=1e-6)
    ld_pre = (math.log(1 - 2 * a) - np.log(q) - np.log(1 - q)).sum(axis=(1, 2, 3))
    log_prior = -0.5 * (z0 ** 2 + math.log(2 * math.pi)).sum(axis=(1, 2, 3))
    want = (-(log_prior + ld_pre) / (64 * math.log(2)) + 8.0).mean()
    np.testing.assert_allclose(float(bpd), want, rtol=1e-5)


@pytest.mark.parametrize("c", [1, 3])
def test_z_logdet_and_bpd_match_with_injected_u(c):
    jm, state, tm, _ = _pair(c)
    imgs = _imgs(c, seed=1)
    u_rng = jax.random.PRNGKey(3)
    want_bpd, _ = jax.jit(lambda p, im: jm._bpd(p, {}, im, u_rng))(state.params,
                                                                  jnp.asarray(imgs))
    u = np.asarray(jax.random.uniform(u_rng, imgs.shape))
    x = np.random.default_rng(2).normal(size=imgs.shape).astype(np.float32)
    (want_z, want_ld), _ = jm.modules.apply("flow", state.params, {}, jnp.asarray(x))
    with torch.no_grad():
        z, ld = tm.flow(torch.from_numpy(x))
        bpd = tm.bpd(torch.from_numpy(imgs), torch.tensor(u))
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(want_ld), atol=1e-5)
    np.testing.assert_allclose(float(bpd), float(want_bpd), atol=1e-5)


def test_logdet_matches_autodiff_jacobian():
    _, _, tm, _ = _pair(1)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(16,)).astype(np.float32))

    def flat_flow(xf):
        return tm.flow(xf.reshape(1, 4, 4, 1))[0].reshape(-1)

    jac = torch.autograd.functional.jacobian(flat_flow, x)
    _, want = np.linalg.slogdet(jac.double().numpy())
    with torch.no_grad():
        _, ld = tm.flow(x.reshape(1, 4, 4, 1))
    np.testing.assert_allclose(float(ld[0]), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grad_clip", [50.0, 0.05], ids=["below", "clipped"])
def test_clipped_train_step_matches_igm_tpu(grad_clip):
    jm, state, tm, tstate = _pair(3, grad_clip=grad_clip)
    imgs = _imgs(3, seed=4)
    u_rng = jax.random.split(state.rng, 2)[1]            # state.next_rng() in train_step
    u = torch.from_numpy(np.asarray(jax.random.uniform(u_rng, imgs.shape)))
    loss_fn = jax.jit(jax.value_and_grad(lambda p: jm._bpd(p, {}, jnp.asarray(imgs), u_rng)[0]))
    want_loss, want_g = loss_fn(state.params)
    flat_g = _flatten(want_g)
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in flat_g.values()))
    assert (norm < grad_clip) == (grad_clip == 50.0), norm
    want_g = flax_to_torch(flat_g)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.zeros((4,), jnp.int32)))
    names, params = zip(*tm.modules.named_parameters())
    got_loss = tm.bpd(torch.from_numpy(imgs), u)
    grads = torch.autograd.grad(got_loss, params)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs), torch.zeros(4)), u=u)
    assert tstate.step == 1
    np.testing.assert_allclose(float(tmetrics["train_bpd"]), float(metrics["train_bpd"]),
                               rtol=1e-5)
    want_p = flax_to_torch(_flatten(new_state.params))
    for name, p in tm.modules.named_parameters():
        big = want_g[name].abs().numpy() > G_FLOOR
        np.testing.assert_allclose(p.detach().numpy()[big], want_p[name].numpy()[big],
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=name)


def test_inverse_of_forward_after_a_step():
    _, _, tm, tstate = _pair(3)
    tm.train_step(tstate, (torch.from_numpy(_imgs(3, seed=5)), torch.zeros(4)))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        back = tm.flow.inverse(tm.flow(x)[0])
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=2e-4, atol=2e-4)


def test_sample_matches_igm_tpu_from_the_same_z():
    jm, state, tm, _ = _pair(3)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(jm.sample(state, rng, 5))
    z = np.asarray(jax.random.normal(rng, (5, 4, 4, 12)))
    got = tm.sample(5, z=torch.from_numpy(z))
    assert got.shape == (5, 8, 8, 3) and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_validation_step_and_odd_size_guard():
    _, _, tm, tstate = _pair(1, sample_batch=6)
    result, metrics = tm.validation_step(tstate, (torch.from_numpy(_imgs(1)), torch.zeros(4)),
                                         torch.Generator().manual_seed(0), sample=True)
    assert result.fake_image.shape == (6, 8, 8, 1)
    assert np.isfinite(float(metrics["val_bpd"]))
    with pytest.raises(ValueError, match="even H and W"):
        tnvp.RealNVP({"width": 7, "height": 8, "channels": 1}, device="cpu")
