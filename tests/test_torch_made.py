"""The port's MADE (igm_tpu_torch/models/made.py) against igm_tpu's, on the
CPU, at 8x8x1 (D = 64), hidden 32, 2 masked layers.

Tolerances: float32 logits, pixel logits and bpd to atol 1e-5; gradients to
1e-5 of their largest entry, the masked entries exactly 0; one f32 Adam step
at tests/_torch_parity.py's tolerances.  The bfloat16-weight step with
stochastic rounding takes igm_tpu's seeds: the output kernel is equal bit for
bit except where the two float32 sums fall on either side of a truncation
boundary, at most one bfloat16 ulp apart (the bf16 products' gradients sum
in another order, so the float32 sums differ in their last bits); the Adam
first moments are within one bfloat16 ulp (the bf16 gradient's rounding
flips) and the second within two (its square); the f32 hidden
kernels within lr x 2**-7 (an update reads those moments).  The sampler
matches draw for draw on igm_tpu's Gumbel draws: teacher-forced on igm_tpu's
samples, every pixel's draw is the same unless it is a near tie (counted; 0
here), which makes the chains equal.
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
from igm_tpu.models import made as jmade  # noqa: E402
from igm_tpu_torch.interop import flax_key_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.models import made as tmade  # noqa: E402
from tests._torch_parity import G_FLOOR, PARAM_ATOL, PARAM_RTOL, _flatten  # noqa: E402

torch.set_num_threads(1)

H = W = 8
D = H * W
KW = dict(hidden_dim=32, n_layer=2, lr=1e-3)
BF16_ULP = 2.0 ** -7          # relative spacing of bfloat16 (8 significant bits)


def _dm():
    return {"width": W, "height": H, "channels": 1, "n_classes": 10,
            "transforms": {"convert": True, "normalize": True}}


def _imgs(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 1), np.uint8)


_STATES = {}


def exact_targets(jm):
    """igm_tpu's model with the pixel's integer as its target, as the port
    computes it (models/made.py ``pixel_targets``): igm_tpu truncates a
    float32 expression whose last bit depends on how XLA compiles it."""
    jm._targets = lambda x: jnp.round((x + 1.0) / 2.0 * 255.0).astype(jnp.int32)
    return jm


def _pair(dtype="float32"):
    """igm_tpu's MADE and state (made once per dtype) and the port's with
    the same weights."""
    jm = exact_targets(jmade.MADE(to_node(_dm()), compute_dtype=dtype, weight_dtype=dtype,
                                  **KW))
    jm.steps_per_epoch = 1
    if dtype not in _STATES:
        state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
        _STATES[dtype] = (state, jm.optimizers)
    state, jm.optimizers = _STATES[dtype]
    tm = tmade.MADE(_dm(), compute_dtype=dtype, weight_dtype=dtype, device="cpu", **KW)
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(flax_to_torch(_flatten(state.params)), strict=True)
    return jm, state, tm, tstate


def _logits_jax(jm, params, imgs):
    """igm_tpu's logits and bpd, compiled as its trainer compiles them."""
    def run(params, imgs):
        x = jm._flatten(jm.preprocess(imgs))
        logits, _ = jm.modules.apply("net", params, {}, x, train=False)
        return logits, jm._bpd(logits, jm._targets(x))
    return jax.jit(run)(params, jnp.asarray(imgs))


def test_targets_are_the_pixel_values():
    """The port's targets are the pixels' integers; igm_tpu's truncation
    gives one less for 63 of the 256 values op by op, and its compiled step gives
    the integer or one less depending on the fusion around it."""
    raw = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    tm = tmade.MADE(_dm(), device="cpu", **KW)
    got = tm._targets(tm._flatten(tm.preprocess(torch.from_numpy(raw))))
    np.testing.assert_array_equal(got.numpy().ravel(), np.arange(256))
    jm = jmade.MADE(to_node(_dm()), compute_dtype="float32", **KW)
    op_by_op = np.asarray(jm._targets(jm._flatten(jm.preprocess(jnp.asarray(raw))))).ravel()
    assert set(np.arange(256) - op_by_op) == {0, 1} and (op_by_op != np.arange(256)).sum() == 63


def test_masks_equal_igm_tpu():
    for args in ((D, 32, 2, 0), (784, 64, 3, 0), (12, 5, 1, 3)):
        jh, jo = jmade.build_masks(*args)
        th, to = tmade.build_masks(*args)
        assert all(np.array_equal(a, b) for a, b in zip(jh, th)) and len(jh) == len(th)
        assert np.array_equal(jo, to)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_covers_every_parameter(dtype):
    """Every leaf lands on a parameter, the kernels untransposed (Flax's
    layout) and the bfloat16 output kernel in the bfloat16 parameter."""
    _, state, tm, _ = _pair(dtype)
    flat = _flatten(state.params)
    converted = flax_to_torch(flat)
    assert set(converted) == set(tm.modules.state_dict())
    for path, value in flat.items():
        got = tm.modules.state_dict()[flax_key_to_torch(path)]
        assert tuple(got.shape) == value.shape, path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(value, np.float32))
    out = tm.net.out_layer.weight
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tm.net.layers_0.weight.dtype == torch.float32


def test_logits_pixel_logits_and_bpd_match():
    jm, state, tm, _ = _pair()
    imgs = _imgs(3)
    want, want_bpd = _logits_jax(jm, state.params, imgs)
    x = tm._flatten(tm.preprocess(torch.from_numpy(imgs)))
    with torch.no_grad():
        got = tm.net(x)
        bpd = tm._bpd(got, tm._targets(x))
        for i in (0, 1, 17, D - 1):
            want_i = jm.modules["net"].apply({"params": state.params["net"]},
                                             jnp.asarray(x.numpy()), i,
                                             method=jmade.MADENet.pixel_logits)
            np.testing.assert_allclose(tm.net.pixel_logits(x, i).numpy(), np.asarray(want_i),
                                       atol=1e-5)
            np.testing.assert_allclose(tm.net.pixel_logits(x, i).numpy(), got[:, i].numpy(),
                                       atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(bpd), float(want_bpd), atol=1e-5)


def test_gradients_match_and_masked_entries_are_zero():
    jm, state, tm, _ = _pair()
    imgs = _imgs(4, seed=1)

    def loss(params):
        return _logits_jax(jm, params, imgs)[1]

    want = flax_to_torch(_flatten(jax.grad(loss)(state.params)))
    x = tm._flatten(tm.preprocess(torch.from_numpy(imgs)))
    names, params = zip(*tm.modules.named_parameters())
    grads = torch.autograd.grad(tm._bpd(tm.net(x), tm._targets(x)), params)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)
    net = tm.net
    for layer, g in ((net.layers_0, grads[0]), (net.layers_1, grads[2]),
                     (net.out_layer, grads[4])):
        mask = layer.mask_t if hasattr(layer, "mask_t") else layer.expanded_mask()
        assert torch.equal(g[mask == 0], torch.zeros_like(g[mask == 0]))
        assert (g[mask == 1] != 0).any()


def test_f32_train_step_matches_igm_tpu():
    """Loss, then every parameter after one Adam step (where |g| > G_FLOOR),
    and the masked entries still exactly 0."""
    jm, state, tm, tstate = _pair()
    imgs = _imgs(4, seed=2)
    batch = (jnp.asarray(imgs), jnp.zeros((4,), jnp.int32))
    grads = flax_to_torch(_flatten(jax.grad(
        lambda p: _logits_jax(jm, p, imgs)[1])(state.params)))
    new_state, metrics = jax.jit(jm.train_step)(state, batch)
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs), torch.zeros(4)))
    assert tstate.step == 1
    np.testing.assert_allclose(float(tmetrics["train_bpd"]), float(metrics["train_bpd"]),
                               rtol=1e-5)
    want = flax_to_torch(_flatten(new_state.params))
    for name, p in tm.modules.named_parameters():
        big = grads[name].abs().numpy() > G_FLOOR
        np.testing.assert_allclose(p.detach().numpy()[big], want[name].numpy()[big],
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=name)
    out = tm.net.out_layer
    assert torch.equal(out.weight[out.expanded_mask() == 0],
                       torch.zeros(int((out.expanded_mask() == 0).sum())))


def _sr_seeds(state, tm):
    """igm_tpu's per-leaf SR seeds for its next train step
    (``state.next_rng()``, then ``apply_updates_sr``'s split), in the port's
    parameter order."""
    key = jax.random.split(state.rng, 2)[1]
    paths = list(_flatten({"net": state.params["net"]}))
    keys = jax.random.split(key, len(paths))
    seeds = {flax_key_to_torch(p): int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max,
                                                         jnp.int32))
             for p, k in zip(paths, keys)}
    return torch.tensor([seeds[n] for n, _ in tm.modules.named_parameters()])


def _ulps_bf16(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """|got - want| in bfloat16 ulps of the larger magnitude (0 where equal)."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    big = np.maximum(np.abs(g), np.abs(w))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-38))) - 7), 1.0)
    return np.abs(g - w) / ulp


def test_bf16_weight_sr_step_matches_igm_tpu():
    jm, state, tm, tstate = _pair("bfloat16")
    assert tm.bf16_weights and tm.sr_active()
    assert isinstance(tstate.opt_states["opt"], torch.optim.Optimizer)
    imgs = _imgs(8, seed=3)
    seeds = _sr_seeds(state, tm)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.zeros((8,), jnp.int32)))
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs), torch.zeros(8)),
                                     sr_seeds=seeds)
    np.testing.assert_allclose(float(tmetrics["train_bpd"]), float(metrics["train_bpd"]),
                               rtol=1e-4)
    want = flax_to_torch(_flatten(new_state.params))
    out = tm.net.out_layer.weight
    assert out.dtype == torch.bfloat16
    ulps = _ulps_bf16(out.detach(), want["net.out_layer.weight"].numpy())
    assert ulps.max() <= 1.0, ulps.max()
    assert (ulps > 0).mean() < 0.01, (ulps > 0).mean()
    # the SR really rounded up and down: not every entry a round-to-nearest
    before = flax_to_torch(_flatten(state.params))["net.out_layer.weight"]
    assert (out.float() != before).any()
    lr = float(jm.hparams.lr)
    for name, p in tm.modules.named_parameters():
        if p.dtype == torch.float32:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=lr * BF16_ULP, err_msg=name)
    mu = new_state.opt_states["opt"][0].mu
    nu = new_state.opt_states["opt"][0].nu
    opt = tstate.opt_states["opt"]
    # mu = (1 - b1) g: one ulp where the bf16 gradient's rounding flips; nu
    # = (1 - b2) g**2 doubles that relative difference: two
    for moments, key, ulps in ((mu, "exp_avg", 1.0), (nu, "exp_avg_sq", 2.0)):
        want_m = flax_to_torch(_flatten(moments))
        for name, p in tm.modules.named_parameters():
            got = opt.state[p][key]
            assert got.dtype == torch.bfloat16, (name, key)
            assert _ulps_bf16(got, want_m[name].numpy()).max() <= ulps, (name, key)


def test_made_causality():
    """tests/test_causality.py's test_made_causality on the port's net: the
    gradient of output i with respect to inputs >= i is exactly 0."""
    d = 16
    net = tmade.MADENet(in_dim=d, hidden_dim=32, n_class=4, n_layer=2)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "reset_parameters") and m is not net:
            m.reset_parameters(gen)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(d,)).astype(np.float32))
    for i in (0, 5, d - 1):
        x_ = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(net(x_[None])[0, i].sum(), x_)
        assert torch.equal(g[i:], torch.zeros(d - i)), f"leak at {i}"


def test_mask_invariant_survives_training():
    """Masked kernel entries and their Adam moments stay exactly 0 over 5
    steps (tests/test_causality.py's test_made_mask_invariant_survives_training)."""
    dm = {"width": 4, "height": 4, "channels": 1,
          "transforms": {"convert": True, "normalize": True}}
    tm = tmade.MADE(dm, hidden_dim=12, n_layer=2, lr=1e-2, device="cpu")
    tm.steps_per_epoch = 10
    state = tm.init_state(0)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.integers(0, 255, (8, 4, 4, 1)).astype(np.uint8)),
             torch.zeros(8))
    for _ in range(5):
        state, _ = tm.train_step(state, batch)
    opt = state.opt_states["opt"]
    net = tm.net
    for w, mask in ((net.layers_0.weight, net.layers_0.mask_t),
                    (net.layers_1.weight, net.layers_1.mask_t),
                    (net.out_layer.weight, net.out_layer.expanded_mask())):
        for t in (w, opt.state[w]["exp_avg"], opt.state[w]["exp_avg_sq"]):
            assert torch.equal(t[mask == 0], torch.zeros_like(t[mask == 0]))
        assert (w[mask == 1] != 0).any()


def test_on_restore_is_idempotent_and_migrates():
    _, _, tm, tstate = _pair()
    imgs = torch.from_numpy(_imgs(4, seed=4))
    tstate, _ = tm.train_step(tstate, (imgs, torch.zeros(4)))
    before = tstate.snapshot()
    tm.on_restore(tstate)
    after = tstate.snapshot()
    for k, v in before["params"].items():
        assert torch.equal(after["params"][k], v), k
    for pid, st in before["opt_states"]["opt"]["state"].items():
        for key, v in st.items():
            assert torch.equal(after["opt_states"]["opt"]["state"][pid][key], v)
    # a checkpoint without the invariant: masked entries nonzero everywhere
    out = tm.net.out_layer
    opt = tstate.opt_states["opt"]
    with torch.no_grad():
        for t in (out.weight, opt.state[out.weight]["exp_avg"],
                  opt.state[out.weight]["exp_avg_sq"]):
            t.add_(1.0)
    tm.on_restore(tstate)
    mask = out.expanded_mask()
    for t in (out.weight, opt.state[out.weight]["exp_avg"],
              opt.state[out.weight]["exp_avg_sq"]):
        assert torch.equal(t[mask == 0], torch.zeros_like(t[mask == 0]))


def test_sample_images_match_igm_tpu_draw_for_draw():
    """The same Gumbel draws as igm_tpu's scan takes (one split key per
    pixel); given pixels (not -1) are kept."""
    jm, state, tm, _ = _pair()
    n = 3
    init = np.full((n, D), -1.0, np.float32)
    init[:, 10:14] = 0.5
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jm.sample_images(state, rng, n, jnp.asarray(init))).reshape(n, D)
    gumbels = np.stack([np.asarray(jax.random.gumbel(k, (n, 256), jnp.float32))
                        for k in jax.random.split(rng, D)])
    # teacher-forced on igm_tpu's samples: each pixel's draw
    values = np.round((want + 1.0) / 2.0 * 255.0).astype(np.int64)
    near_ties = 0
    with torch.no_grad():
        for i in range(D):
            if (init[:, i] != -1.0).all():
                continue
            s = tm.net.pixel_logits(torch.tensor(want), i) + torch.tensor(gumbels[i])
            draw = s.argmax(-1).numpy()
            for j in np.nonzero(draw != values[:, i])[0]:
                gap = float(s[j, draw[j]] - s[j, values[j, i]])
                assert gap <= 1e-5 * float(s[j].abs().max()), (i, j, gap)
                near_ties += 1
    got = tm.sample_images(n, init_flat=torch.from_numpy(init),
                           gumbels=torch.from_numpy(gumbels))
    assert got.shape == (n, H, W, 1)
    assert near_ties == 0
    got = got.reshape(n, D).numpy()
    # the same draws; a value is draw / 255 * 2 - 1, which XLA's compiled
    # scan body may round differently in the last bit
    np.testing.assert_array_equal(np.round((got + 1.0) / 2.0 * 255.0), values)
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
    assert (got[:, 10:14] == 0.5).all()


def test_validation_step_samples_a_batch():
    _, _, tm, tstate = _pair()
    imgs = torch.from_numpy(_imgs(4, seed=5))
    result, metrics = tm.validation_step(tstate, (imgs, torch.zeros(4)),
                                         torch.Generator().manual_seed(0), sample=True)
    assert result.fake_image.shape == (4, H, W, 1)
    assert result.fake_image.abs().max() <= 1.0
    assert np.isfinite(float(metrics["val_bpd"]))


def test_made_sr_off_rounds_to_nearest_without_drawing_seeds(monkeypatch):
    """IGM_MADE_SR=0 (igm_tpu's measurement arm): the bf16 output kernel's
    update is rounded to nearest and no seed is drawn."""
    monkeypatch.setenv("IGM_MADE_SR", "0")
    _, _, tm, tstate = _pair("bfloat16")
    assert tm.bf16_weights and not tm.sr_active()
    before_gen = tstate.generator.get_state()
    before = tm.net.out_layer.weight.detach().clone()
    tstate, _ = tm.train_step(tstate, (torch.from_numpy(_imgs(4, seed=6)), torch.zeros(4)))
    assert torch.equal(tstate.generator.get_state(), before_gen)
    assert tm.net.out_layer.weight.dtype == torch.bfloat16
    assert not torch.equal(tm.net.out_layer.weight, before)
