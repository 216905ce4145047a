"""The port's gated PixelCNN (igm_tpu_torch/models/pixelcnn.py) against
igm_tpu's, on the CPU, at 8x8 (1 and 3 channels), hidden 8, 11 layers.

Tolerances, float32 on both sides: logits atol 1e-5 (the ``pixel=`` slice
against the full forward too), ``row_logits`` against the full forward atol
1e-4 (tests/test_causality.py's), bpd rtol 1e-5, gradients 1e-5 of their
largest entry, one Adam step at tests/_torch_parity.py's tolerances.  The
fast sampler matches draw for draw on igm_tpu's Gumbel draws: teacher-forced
on igm_tpu's samples, every pixel's draw is the same unless it is a near tie
(counted; 0 here), which makes the chains equal.  Both models take the
pixel's integer as the target (tests/test_torch_made.py ``exact_targets``).
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
from igm_tpu.models import pixelcnn as jpx  # noqa: E402
from igm_tpu_torch.interop import flax_key_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.models import pixelcnn as tpx  # noqa: E402
from tests._torch_parity import G_FLOOR, PARAM_ATOL, PARAM_RTOL, _flatten  # noqa: E402
from tests.test_torch_made import exact_targets  # noqa: E402

torch.set_num_threads(1)

H = W = 8
HIDDEN = 8
CASES = {"mnist": (1, False), "cifar_cond": (3, True)}


def _dm(c):
    return {"width": W, "height": H, "channels": c, "n_classes": 10,
            "transforms": {"convert": True, "normalize": True}}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """igm_tpu's PixelCNN and state, the port's with the same weights."""
    c, cond = CASES[request.param]
    jm = exact_targets(jpx.PixelCNN(to_node(_dm(c)), hidden_dim=HIDDEN, class_condition=cond,
                                    n_classes=10))
    jm.steps_per_epoch = 1
    state = jm.init_state(jax.random.PRNGKey(0))
    tm = tpx.PixelCNN(_dm(c), hidden_dim=HIDDEN, class_condition=cond, n_classes=10,
                      device="cpu")
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(flax_to_torch(_flatten(state.params)), strict=True)
    return jm, state, tm, tstate


def _batch(c, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, H, W, c), np.uint8),
            rng.integers(0, 10, (n,)).astype(np.int32))


def _y(tm, labels):
    return tm._one_hot(torch.from_numpy(labels)) if tm.hparams.class_condition else None


def _jy(jm, labels):
    return jax.nn.one_hot(labels, 10) if jm.hparams.class_condition else None


def test_masks_equal_igm_tpu():
    for k in (3, 5):
        for center in (False, True):
            assert np.array_equal(tpx.vertical_mask(k, center), jpx.vertical_mask(k, center))
            assert np.array_equal(tpx.horizontal_mask(k, center),
                                  jpx.horizontal_mask(k, center))


def test_interop_covers_every_parameter(pair):
    _, state, tm, _ = pair
    flat = _flatten(state.params)
    assert set(flax_to_torch(flat)) == set(tm.modules.state_dict())
    assert any("cond_proj_vert1" in k for k in flat) == tm.hparams.class_condition
    for path, value in flat.items():
        got = tm.modules.state_dict()[flax_key_to_torch(path)]
        assert got.numel() == value.size, path


def test_logits_pixel_slice_and_bpd_match(pair):
    jm, state, tm, _ = pair
    imgs, labels = _batch(tm.channels)

    @jax.jit
    def run(params, imgs, labels):
        x = jm.preprocess(imgs)
        logits, _ = jm.modules.apply("net", params, {}, x, _jy(jm, labels), train=False)
        return logits, jm._bpd(logits, jm._targets(x))

    want, want_bpd = run(state.params, jnp.asarray(imgs), jnp.asarray(labels))
    x, y = tm.preprocess(torch.from_numpy(imgs)), _y(tm, labels)
    with torch.no_grad():
        got = tm.net(x, y)
        for hh, ww in ((0, 0), (3, 5), (H - 1, W - 1)):
            np.testing.assert_allclose(tm.net(x, y, pixel=(hh, ww)).numpy(),
                                       got[:, hh, ww].numpy(), atol=1e-5)
        bpd = tm._bpd(got, tm._targets(x))
    assert got.shape == (4, H, W, tm.channels, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(bpd), float(want_bpd), rtol=1e-5)


def test_row_logits_match_full_forward(pair):
    _, _, tm, _ = pair
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, H, W, tm.channels)).astype(np.float32))
    y = _y(tm, np.array([2, 7], np.int32))
    with torch.no_grad():
        full = tm.net(x, y)
    np.testing.assert_allclose(tm.net.row_logits(x, y).numpy(), full.numpy(), atol=1e-4)


def test_causality():
    """tests/test_causality.py's test_pixelcnn_causality on the port's net:
    the logits at (h, w) have zero gradient with respect to every input at
    or after (h, w) in raster order."""
    net = tpx.PixelCNNNet(channels=1, hidden_dim=8)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 7, 7, 1)).astype(np.float32))
    for hh, ww in ((0, 0), (3, 3), (6, 2)):
        x_ = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(net(x_)[0, hh, ww].sum(), x_)
        g = g[0, :, :, 0].reshape(-1)
        assert torch.equal(g[hh * 7 + ww:], torch.zeros_like(g[hh * 7 + ww:]))


def test_train_step_matches_igm_tpu(pair):
    jm, state, tm, tstate = pair
    imgs, labels = _batch(tm.channels, seed=1)

    def loss(params):
        x = jm.preprocess(jnp.asarray(imgs))
        logits, _ = jm.modules.apply("net", params, {}, x, _jy(jm, jnp.asarray(labels)))
        return jm._bpd(logits, jm._targets(x))

    want_loss, want_g = jax.jit(jax.value_and_grad(loss))(state.params)
    want_g = flax_to_torch(_flatten(want_g))
    x, y = tm.preprocess(torch.from_numpy(imgs)), _y(tm, labels)
    names, params = zip(*tm.modules.named_parameters())
    got_loss = tm._bpd(tm.net(x, y), tm._targets(x))
    # the last layer's vertical output (and its cond_proj_vert*) feeds nothing
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(got_loss, params, allow_unused=True))]
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                       jnp.asarray(labels)))
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs), torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tmetrics["train_bpd"]), float(metrics["train_bpd"]),
                               rtol=1e-5)
    want_p = flax_to_torch(_flatten(new_state.params))
    for name, p in tm.modules.named_parameters():
        big = want_g[name].abs().numpy() > G_FLOOR
        np.testing.assert_allclose(p.detach().numpy()[big], want_p[name].numpy()[big],
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=name)
    tm.modules.load_state_dict(flax_to_torch(_flatten(state.params)))


def test_fast_sampler_matches_igm_tpu_draw_for_draw(pair):
    """igm_tpu's sample_rows with one split key per row, then per column;
    the given pixels (not -1) stay."""
    jm, state, tm, _ = pair
    n, c = 2, tm.channels
    init = np.full((n, H, W, c), -1.0, np.float32)
    init[:, 2, 3:5] = 0.5
    labels = np.array([3, 8], np.int32)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jm.sample_images(state, rng, n, cond=_jy(jm, jnp.asarray(labels)),
                                       init_img=jnp.asarray(init)))
    gumbels = np.stack([np.stack([np.asarray(jax.random.gumbel(k, (n, c, 256), jnp.float32))
                                  for k in jax.random.split(row_key, W)])
                        for row_key in jax.random.split(rng, H)])
    values = np.round((want + 1.0) / 2.0 * 255.0).astype(np.int64)
    y = _y(tm, labels)
    with torch.no_grad():                    # teacher-forced: the causal logits
        s = tm.net(torch.tensor(want), y) + torch.tensor(gumbels).permute(2, 0, 1, 3, 4)
    draws = s.argmax(-1).numpy()
    free = init == -1.0
    near_ties = 0
    for idx in zip(*np.nonzero((draws != values) & free)):
        gap = float(s[idx][draws[idx]] - s[idx][values[idx]])
        assert gap <= 1e-5 * float(s[idx].abs().max()), (idx, gap)
        near_ties += 1
    assert near_ties == 0
    got = tm.sample_images(n, cond=y, init_img=torch.from_numpy(init),
                           gumbels=torch.from_numpy(gumbels)).numpy()
    np.testing.assert_array_equal(np.round((got + 1.0) / 2.0 * 255.0), values)
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
    assert (got[:, 2, 3:5] == 0.5).all()


def test_validation_samples_eight_of_each_class(pair):
    _, _, tm, tstate = pair
    imgs, labels = _batch(tm.channels, n=3, seed=2)
    result, metrics = tm.validation_step(tstate, (torch.from_numpy(imgs),
                                                  torch.from_numpy(labels)),
                                         torch.Generator().manual_seed(0), sample=True)
    n = 80 if tm.hparams.class_condition else 3
    assert result.fake_image.shape == (n, H, W, tm.channels)
    assert result.fake_image.abs().max() <= 1.0 and (result.fake_image != -1.0).any()
    assert np.isfinite(float(metrics["val_bpd"]))


def test_string_none_n_classes_is_zero():
    """The CelebA config's n_classes is the string "None"."""
    tm = tpx.PixelCNN(_dm(3), hidden_dim=4, n_classes="None", device="cpu")
    assert tm.n_classes == 0 and not tm.net.class_condition
