"""The port's TAR (igm_tpu_torch.models.tar) against igm_tpu's, on the CPU.

A tiny TARNet (d 32, 2 heads, 2 layers, 6x6x1 binary pixels) with
igm_tpu's Flax weights carried over by ``igm_tpu_torch.interop``: the forward
logits, ``cal_loss`` and its gradients (dropout 0), the KV-cached decode, the
sampler with injected Gumbel draws, token for token, and the token rules.
Tolerances: float32 on both sides, summed in other orders: logits and loss
1e-5 relative to their scale, gradients 1e-5 of their largest entry.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.models.tar import TAR as JaxTAR  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.models.tar import TAR  # noqa: E402

torch.set_num_threads(1)

H = W = 6
S = 1 + H * W
KW = dict(d_model=32, nhead=2, num_layers=2)


def _dm():
    return {"width": W, "height": H, "channels": 1, "n_classes": 10,
            "transforms": {"convert": True, "normalize": True}}


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=[False, True], ids=["uncond", "cond"])
def pair(request):
    """(igm_tpu TAR, its state, the port's TAR with the same weights)."""
    cond = request.param
    jm = JaxTAR(_dm(), class_cond=cond, dropout=0.0, **KW)
    jm.steps_per_epoch = 1
    state = jm.init_state(jax.random.PRNGKey(0))
    tm = TAR(_dm(), class_cond=cond, dropout=0.0, device="cpu", **KW)
    tm.net.load_state_dict(flax_to_torch(_flat(state.params["net"])), strict=True)
    return jm, state, tm


def _tokens(n, cond, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 2, (n, S))
    toks[:, 0] = rng.integers(0, 10, n) if cond else 0
    return toks.astype(np.int32)


def test_interop_covers_every_parameter(pair):
    jm, state, tm = pair
    names = set(flax_to_torch(_flat(state.params["net"])))
    assert names == set(tm.net.state_dict())
    assert any(k.endswith("query.weight") for k in names)
    assert "h_pe" in names and "Embed_1.embedding" in names


def test_forward_logits_match(pair):
    jm, state, tm = pair
    toks = _tokens(3, tm.hparams.class_cond)
    want, _ = jm.modules.apply("net", state.params, state.mutables,
                               jnp.asarray(toks), train=False)
    with torch.no_grad():
        got = tm.net(torch.from_numpy(toks).long(), train=False)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(np.abs(want).max(), 1))


def test_cal_loss_and_gradients_match(pair):
    jm, state, tm = pair
    toks = _tokens(4, tm.hparams.class_cond, seed=1)

    def loss_fn(params):
        return jm.cal_loss(params, state.mutables, jnp.asarray(toks), train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(state.params)
    got_loss = tm.cal_loss(torch.from_numpy(toks).long(), train=True)
    names, params = zip(*tm.net.named_parameters())
    got_grads = torch.autograd.grad(got_loss, params)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = flax_to_torch(_flat(want_grads["net"]))
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(names, got_grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)


def test_kv_decode_matches_full_forward(pair):
    _, _, tm = pair
    toks = torch.from_numpy(_tokens(2, tm.hparams.class_cond, seed=2)).long()
    net = tm.net
    with torch.no_grad():
        full = net(toks, train=False)
        net.init_cache(2, S)
        steps = [net.decode_step(toks[:, i:i + 1], i)[:, 0] for i in range(S)]
        net.clear_cache()
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=1e-5)


def test_sample_tokens_match_igm_tpu_draw_for_draw(pair):
    """The same Gumbel draws as jax.random.categorical takes inside
    igm_tpu's scan (one split key per position) give the same tokens."""
    jm, state, tm = pair
    n = 3
    init = np.full((n, S), -1, np.int32)
    init[:, 0] = [1, 4, 7] if tm.hparams.class_cond else 0
    init[:, 5:9] = 1                                   # given tokens stay
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jm.sample_tokens(state, rng, jnp.asarray(init)))
    keys = jax.random.split(rng, S - 1)
    gumbels = np.stack([np.asarray(jax.random.gumbel(k, (n, 2), jnp.float32))
                        for k in keys])
    got = tm.sample_tokens(torch.from_numpy(init), gumbels=torch.from_numpy(gumbels))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 5:9] == 1).all() and set(np.unique(got[:, 1:].numpy())) <= {0, 1}


def test_masked_completion_keeps_the_given_half(pair):
    _, _, tm = pair
    toks = torch.from_numpy(_tokens(2, tm.hparams.class_cond, seed=3)).long()
    half = 1 + (S - 1) // 2
    masked = toks.clone()
    masked[:, half:] = -1
    out = tm.sample_tokens(masked, torch.Generator().manual_seed(0))
    assert torch.equal(out[:, :half], toks[:, :half])
    assert ((out[:, half:] == 0) | (out[:, half:] == 1)).all()


def test_class_conditional_sos_and_threshold_quirk():
    tm = TAR(_dm(), class_cond=True, device="cpu", **KW)
    # normalised pixels: 0.5 in [-1, 1] is 191.25/255 raw; the quirk
    # thresholds the normalised value, so 191 -> 0 and 192 -> 1
    raw = torch.zeros(2, H, W, 1, dtype=torch.uint8)
    raw[0, 0, 0] = 191
    raw[0, 0, 1] = 192
    raw[1] = 255
    toks = tm.img2tokens(tm.preprocess(raw), torch.tensor([3, 9]))
    assert toks[:, 0].tolist() == [3, 9]
    assert toks[0, 1:3].tolist() == [0, 1] and int(toks[0, 3:].sum()) == 0
    assert int(toks[1, 1:].sum()) == H * W
    jm = JaxTAR(_dm(), class_cond=True, **KW)
    want = np.asarray(jm.img2tokens(jm.preprocess(jnp.asarray(raw.numpy())),
                                    jnp.asarray([3, 9])))
    np.testing.assert_array_equal(toks.numpy(), want)
    imgs = tm.sample(3, torch.Generator().manual_seed(1), labels=torch.tensor([2, 5, 7]))
    assert imgs.shape == (3, H, W, 1)
    un = TAR(_dm(), class_cond=False, device="cpu", **KW)
    assert un.img2tokens(un.preprocess(raw), torch.tensor([3, 9]))[:, 0].tolist() == [0, 0]


def test_validation_step_and_train_step_run():
    tm = TAR(_dm(), class_cond=True, device="cpu", flash_attention="dropout", **KW)
    tm.steps_per_epoch = 2
    state = tm.init_state(0)
    gen = torch.Generator().manual_seed(0)
    batch = (torch.randint(0, 256, (4, H, W, 1), generator=gen, dtype=torch.uint8),
             torch.tensor([0, 1, 2, 3]))
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    state, metrics = tm.train_step(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["train_log/bpd"]))
    assert any(not torch.equal(before[k], v) for k, v in tm.net.state_dict().items())
    result, vm = tm.validation_step(state, batch, gen, sample=True)
    assert set(vm) == {"val_log/bpd", "val_log/rand_bpd"}
    assert result.fake_image.shape == (80, H, W, 1)          # 8 per class
    assert result.others["mask_image"].shape == (4, H, W, 1)


def test_attention_modes_agree_on_one_seed_stream():
    """``dropout`` (the kernels' plain versions on the CPU) and ``hashdrop``
    draw the same seeds and masks from one generator and drop the same
    probabilities; at eval every mode is exact causal attention."""
    toks = torch.from_numpy(_tokens(2, False, seed=4)).long()
    nets = {}
    for mode in ("dropout", "hashdrop", "off", "true", "eval"):
        m = TAR(_dm(), device="cpu", flash_attention=mode, **KW)
        nets[mode] = m.net
    ref = nets["off"].state_dict()
    for net in nets.values():
        net.load_state_dict(ref)
    with torch.no_grad():
        outs = {mode: net(toks, train=True, generator=torch.Generator().manual_seed(3))
                for mode, net in nets.items() if mode in ("dropout", "hashdrop")}
        evals = {mode: net(toks, train=False) for mode, net in nets.items()}
    torch.testing.assert_close(outs["dropout"], outs["hashdrop"], atol=1e-5, rtol=1e-5)
    for mode, out in evals.items():
        torch.testing.assert_close(out, evals["off"], atol=1e-5, rtol=1e-5, msg=mode)
