"""The zoo's normalisation and networks (igm_tpu_torch/networks/base.py
``Norm``, basic.py, conv32.py, conv64.py) against igm_tpu's Flax modules,
at a tiny size: widths 4-16, 8x8 to 64x64 images of batch 4.

Flax params and batch_stats (moved off their init, so a leaf loaded into the
wrong place shows) go through igm_tpu_torch.interop; the same numpy inputs
go through both sides in float32 on the CPU.  Train mode: the output and the
moved running statistics; eval mode: the output from them.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu.networks import base as jbase  # noqa: E402
from igm_tpu.networks import basic as jbasic  # noqa: E402
from igm_tpu.networks import conv32 as jconv32  # noqa: E402
from igm_tpu.networks import conv64 as jconv64  # noqa: E402
from igm_tpu_torch.interop import flax_mutables_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.networks import base as tbase  # noqa: E402
from igm_tpu_torch.networks import basic as tbasic  # noqa: E402
from igm_tpu_torch.networks import conv32 as tconv32  # noqa: E402
from igm_tpu_torch.networks import conv64 as tconv64  # noqa: E402

torch.set_num_threads(1)

# float32 on both sides: the statistics and convolutions sum in another
# order, a few ulps of the largest output per layer over <= 6 layers
RTOL = 1e-5


def flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def moved(tree, seed, positive=False):
    rng = np.random.default_rng(seed)

    def move(p):
        p = np.asarray(p)
        if positive:                       # running variances stay positive
            return (p * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32)
        return (p + 0.05 * rng.normal(size=p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(move, tree)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _pair(flax_mod, port_mod, x, seed=1, **kw):
    """Flax's variables moved off their init, loaded into the port's module."""
    variables = dict(flax_mod.init({"params": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), **kw))
    params = moved(variables.pop("params", {}), seed)
    stats = variables.get("batch_stats")
    if stats is not None:
        rng = np.random.default_rng(seed + 1)
        stats = {k: v for k, v in flatten(stats).items()}
        stats = {k: (v + 0.1 * rng.normal(size=v.shape) if k.endswith("mean")
                     else v * rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                 for k, v in stats.items()}
    state = flax_to_torch(flatten(params))
    if stats:
        state.update(flax_mutables_to_torch({f"batch_stats/{k}": v for k, v in stats.items()}))
    port_mod.load_state_dict(state, strict=True)
    flax_vars = {"params": params}
    if stats:
        nested = {}
        for k, v in stats.items():
            node = nested
            *head, leaf = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(v)
        flax_vars["batch_stats"] = nested
    return flax_vars


def _check(flax_mod, port_mod, x, **kw):
    """Train mode (output and the moved statistics), then eval mode."""
    flax_vars = _pair(flax_mod, port_mod, x, **kw)
    xt = torch.from_numpy(x)
    if "batch_stats" in flax_vars:
        want, new = flax_mod.apply(flax_vars, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"], **kw)
    else:
        want, new = flax_mod.apply(flax_vars, jnp.asarray(x), train=True, **kw), {}
    with torch.no_grad():
        got = port_mod(xt, train=True)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), w)
    if new:
        want_stats = flax_mutables_to_torch({f"batch_stats/{k}": v for k, v in
                                             flatten(new["batch_stats"]).items()})
        buffers = dict(port_mod.named_buffers())
        assert set(want_stats) == set(buffers)
        for k, v in want_stats.items():
            close(buffers[k].numpy(), v.numpy())
        flax_vars["batch_stats"] = new["batch_stats"]
    want = flax_mod.apply(flax_vars, jnp.asarray(x), train=False, **kw)
    with torch.no_grad():
        got = port_mod(xt, train=False)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("norm_type,shape", [
    ("batch", (4, 8, 8, 16)), ("batch", (4, 16)), ("layer", (4, 8, 8, 16)),
    ("layer", (4, 16)), ("instance", (4, 8, 8, 16)), (None, (4, 16))],
    ids=["batch-nhwc", "batch-nc", "layer-nhwc", "layer-nc", "instance-nhwc", "none-nc"])
def test_norm_matches_flax(norm_type, shape):
    x = (np.random.default_rng(3).normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    _check(jbase.Norm(norm_type), tbase.Norm(norm_type, shape[-1]), x)


def test_batchnorm_running_var_is_biased_as_flax():
    """At the FactorVAE critic's shape (a batch of 64, no spatial axes) torch's
    BatchNorm1d moves running_var by the unbiased n/(n-1) variance, 1.6% off
    Flax's; the port's BatchNorm moves it as Flax does."""
    x = np.random.default_rng(4).normal(size=(64, 256)).astype(np.float32) * 3.0
    flax_bn = jbase.Norm("batch")
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, new = flax_bn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = np.asarray(new["batch_stats"]["BatchNorm_0"]["var"])
    port = tbase.Norm("batch", 256)
    port.BatchNorm_0.reset_parameters(torch.Generator())
    port(torch.from_numpy(x), train=True)
    close(port.BatchNorm_0.var.numpy(), want)
    close(port.BatchNorm_0.mean.numpy(), np.asarray(new["batch_stats"]["BatchNorm_0"]["mean"]))
    stock = torch.nn.BatchNorm1d(256, momentum=0.1)
    stock.train()
    stock(torch.from_numpy(x))
    gap = np.abs(stock.running_var.detach().numpy() - want).max() / np.abs(want).max()
    assert gap > 1e-3, gap              # torch's update is not Flax's


def test_frozen_stats_keeps_the_buffers_and_the_train_output():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 16)).astype(np.float32))
    net = tbasic.MLPEncoder(16, 1, hidden_dims=[8, 8])
    net.apply(lambda m: m.reset_parameters(torch.Generator().manual_seed(0))
              if hasattr(m, "reset_parameters") else None)
    before = {k: v.clone() for k, v in net.named_buffers()}
    with torch.no_grad():
        want = net(x, train=True)
        for k, v in before.items():
            dict(net.named_buffers())[k].copy_(v)
        with tbase.frozen_stats(net):
            got = net(x, train=True)
    assert torch.equal(got, want)
    for k, v in net.named_buffers():
        assert torch.equal(v, before[k]), k
    assert all(m.update_stats for m in net.modules() if isinstance(m, tbase.BatchNorm))


NETWORKS = {
    "mlp_encoder": (lambda: jbasic.MLPEncoder(1, 6, hidden_dims=(16, 12), width=8, height=8),
                    lambda: tbasic.MLPEncoder(1, 6, hidden_dims=[16, 12], width=8, height=8),
                    (4, 8, 8, 1)),
    "mlp_encoder_features": (
        lambda: jbasic.MLPEncoder(3, 4, hidden_dims=(8,), width=4, height=4,
                                  return_features=True, norm_type="batch"),
        lambda: tbasic.MLPEncoder(3, 4, hidden_dims=[8], width=4, height=4,
                                  return_features=True), (4, 4, 4, 3)),
    "mlp_decoder": (lambda: jbasic.MLPDecoder(6, 1, hidden_dims=(12, 16), width=8, height=8),
                    lambda: tbasic.MLPDecoder(6, 1, hidden_dims=[12, 16], width=8, height=8),
                    (4, 6)),
    "conv_encoder": (lambda: jbasic.ConvEncoder(2, 6, ndf=4),
                     lambda: tbasic.ConvEncoder(2, 6, ndf=4), (4, 28, 28, 2)),
    "conv_encoder_features": (lambda: jbasic.ConvEncoder(1, 6, ndf=4, return_features=True),
                              lambda: tbasic.ConvEncoder(1, 6, ndf=4, return_features=True),
                              (4, 28, 28, 1)),
    "conv_decoder": (lambda: jbasic.ConvDecoder(6, 1, ngf=4, output_act="sigmoid"),
                     lambda: tbasic.ConvDecoder(6, 1, ngf=4, output_act="sigmoid"), (4, 6)),
    "conv32_encoder": (lambda: jconv32.Encoder(3, 6, ndf=4),
                       lambda: tconv32.Encoder(3, 6, ndf=4), (4, 32, 32, 3)),
    "conv32_decoder": (lambda: jconv32.Decoder(6, 3, ngf=4),
                       lambda: tconv32.Decoder(6, 3, ngf=4), (4, 6)),
    "conv64_encoder": (lambda: jconv64.Encoder(3, 6, ndf=4, return_features=True),
                       lambda: tconv64.Encoder(3, 6, ndf=4, return_features=True),
                       (2, 64, 64, 3)),
    "conv64_decoder": (lambda: jconv64.Decoder(6, 1, ngf=4, norm_type=None,
                                               output_act="sigmoid"),
                       lambda: tconv64.Decoder(6, 1, ngf=4, norm_type=None,
                                               output_act="sigmoid"), (2, 6)),
    "conv64_encoder_instance": (lambda: jconv64.Encoder(1, 6, ndf=4, norm_type="instance"),
                                lambda: tconv64.Encoder(1, 6, ndf=4, norm_type="instance"),
                                (2, 64, 64, 1)),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_flax(name):
    make_flax, make_port, shape = NETWORKS[name]
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    _check(make_flax(), make_port(), x)
