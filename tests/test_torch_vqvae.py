"""The port's VQ-VAE (networks and model) against igm_tpu's, at a tiny size:
16x16x3 images, 4x4x8 latents, K = 16 codes, encoder/decoder widths 8.

Flax params (perturbed off their init so a leaf loaded into the wrong place
shows) go through igm_tpu_torch.interop; the same numpy inputs go through
both sides in float32 on the CPU, where the nearest-code search takes its
plain version.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from igm_tpu.models.vqvae import VectorQuantizer as JaxVQ  # noqa: E402
from igm_tpu.networks import vqvae as jnets  # noqa: E402
from igm_tpu.networks.base import ConvTranspose as FlaxConvTranspose  # noqa: E402
from igm_tpu_torch.interop import flax_mutables_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.models.vqvae import VQVAE, VectorQuantizer  # noqa: E402
from igm_tpu_torch.networks import vqvae as tnets  # noqa: E402
from igm_tpu_torch.networks.base import ConvTranspose  # noqa: E402

torch.set_num_threads(1)

DM = {"width": 16, "height": 16, "channels": 3,
      "transforms": {"convert": True, "normalize": True}}
ENC = {"_target_": "igm_tpu.networks.vqvae.Encoder", "res_h_dim": 8}
DEC = {"_target_": "igm_tpu.networks.vqvae.Decoder", "h_dim": 8, "res_h_dim": 8}
LATENT, K, LR, BATCH = 8, 16, 1e-3, 4
# float32 on both sides; convolutions sum in another order, a few ulps of the
# outputs (relative to the largest) per layer over ~10 layers
RTOL = 1e-5
# one Adam step, as tests/test_torch_train_step.py: where |g| > 1e-6 the step
# is lr * sign(g) to f32 rounding; smaller gradients are held to |step| <= lr
PARAM_ATOL, G_FLOOR = 1e-6, 1e-6


def flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + scale * rng.normal(size=p.shape).astype(np.float32), tree)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _flax_vs_port(flax_mod, port_mod, x):
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = perturbed(params, 1)
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    port_mod.load_state_dict(flax_to_torch(flatten(params)), strict=True)
    with torch.no_grad():
        got = port_mod(torch.from_numpy(x))
    assert got.shape == want.shape
    close(got.numpy(), want)


def test_encoder_matches_flax():
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    _flax_vs_port(jnets.Encoder(3, LATENT, res_h_dim=8),
                  tnets.Encoder(3, LATENT, res_h_dim=8), x)


def test_decoder_matches_flax():
    z = np.random.default_rng(1).normal(size=(2, 4, 4, LATENT)).astype(np.float32)
    _flax_vs_port(jnets.Decoder(LATENT, 3, h_dim=8, res_h_dim=8),
                  tnets.Decoder(LATENT, 3, h_dim=8, res_h_dim=8), z)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_residual_stack_matches_flax(tied):
    """Tied: one ResidualLayer's parameters applied three times."""
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 8)).astype(np.float32)
    port = tnets.ResidualStack(8, 6, 3, tied=tied)
    assert len(list(port.children())) == (1 if tied else 3)
    _flax_vs_port(jnets.ResidualStack(8, 6, 3, tied=tied), port, x)


def test_conv_transpose_k3_s1_p1_matches_flax():
    """The decoder's first layer: ConvTranspose(3, 1, 1) keeps the grid."""
    x = np.random.default_rng(3).normal(size=(2, 4, 4, LATENT)).astype(np.float32)
    flax_mod = FlaxConvTranspose(8, 3, 1, 1)
    holder = nn.Module()
    holder.ConvTranspose_0 = ConvTranspose(LATENT, 8, 3, 1, 1)
    params = perturbed(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    holder.load_state_dict(flax_to_torch(
        {f"ConvTranspose_0/{k}": v for k, v in flatten(params).items()}), strict=True)
    with torch.no_grad():
        got = holder.ConvTranspose_0(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 4, 4, 8)
    close(got.numpy(), want)


def _ema_mutables(mutables, seed):
    """The EMA codebook moved off its init, with positive cluster sizes."""
    rng = np.random.default_rng(seed)
    cb = dict(mutables["codebook"])
    cb["embedding"] = cb["embedding"] + 0.05 * rng.normal(size=cb["embedding"].shape)
    cb["cluster_sum"] = cb["embedding"] * 1.5
    cb["cluster_size"] = rng.uniform(0.5, 2.0, cb["cluster_size"].shape)
    return {"codebook": {k: jnp.asarray(v, jnp.float32) for k, v in cb.items()}}


@pytest.mark.parametrize("mode", ["gradient", "ema"])
def test_vector_quantizer_matches_igm_tpu(mode):
    """quant, vq loss, commit loss and indices; in ema mode one train-mode
    call also moves the codebook buffers."""
    ema = mode == "ema"
    z = np.random.default_rng(5).normal(size=(2, 4, 4, LATENT)).astype(np.float32) * 0.1
    jvq = JaxVQ(K, LATENT, ema=ema)
    variables = dict(jvq.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    params = perturbed(variables.get("params", {}), 6)
    mutables = _ema_mutables(variables, 7) if ema else {}
    (jq, jvl, jcl, jidx), new_vars = jvq.apply(
        {"params": params, **mutables}, jnp.asarray(z), train=True,
        mutable=["codebook"])

    tvq = VectorQuantizer(K, LATENT, ema=ema)
    state = {**{f"vq/{k}": v for k, v in flatten(params).items()},
             **{f"vq/{k}": v for k, v in flatten(mutables).items()}}
    converted = {**flax_to_torch({k: v for k, v in state.items() if "codebook" not in k}),
                 **flax_mutables_to_torch({k: v for k, v in state.items()
                                           if "codebook" in k})}
    tvq.load_state_dict({k[len("vq."):]: v for k, v in converted.items()}, strict=True)
    tq, tvl, tcl, tidx = tvq(torch.from_numpy(z), train=True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tq.detach().numpy(), jq)
    close(tvl.detach().numpy(), jvl)
    close(tcl.detach().numpy(), jcl)
    if ema:
        new = flax_mutables_to_torch({f"vq/{k}": v for k, v in flatten(new_vars).items()})
        for name in ("embedding", "cluster_size", "cluster_sum"):
            close(getattr(tvq, name).numpy(), new[f"vq.{name}"].numpy())


def _models(mode):
    kw = dict(latent_dim=LATENT, num_embeddings=K, lr=LR, b1=0.9, b2=0.999,
              codebook_update=mode)
    jm = JaxVQVAE(datamodule=to_node(DM), encoder=to_node(ENC), decoder=to_node(DEC), **kw)
    jm.steps_per_epoch = 1
    state = jm.init_state(jax.random.PRNGKey(0))
    params = perturbed(state.params, 8)
    mutables = dict(state.mutables)
    if mode == "ema":
        mutables["vq"] = _ema_mutables(state.mutables["vq"], 9)
    state = state.replace(params=params, mutables=mutables)
    tm = VQVAE(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu", **kw)
    weights = {**flax_to_torch(flatten(params)),
               **flax_mutables_to_torch(flatten(mutables))}
    return jm, state, tm, weights


@pytest.mark.parametrize("mode", ["gradient", "ema"])
def test_train_step_matches_igm_tpu(mode):
    """One step from the same parameters: the loss terms, every gradient,
    the parameters after Adam, and (ema) the codebook buffers."""
    jm, state, tm, weights = _models(mode)
    imgs = np.random.default_rng(10).integers(0, 256, (BATCH, 16, 16, 3), np.uint8)
    labels = np.zeros(BATCH, np.int32)
    x = jm.preprocess(jnp.asarray(imgs))

    def jax_loss(p):
        recon, vq_loss, commit, _ = jm._autoencode(p, state.mutables, x, train=True,
                                                   straight_through=True)
        return jnp.mean((recon - x) ** 2) + vq_loss + 0.25 * commit

    want_g = flax_to_torch(flatten(jax.jit(jax.grad(jax_loss))(state.params)))
    new_state, metrics = jax.jit(jm.train_step)(state, (jnp.asarray(imgs),
                                                        jnp.asarray(labels)))
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(weights, strict=True)
    names = [k for k, _ in tm.modules.named_parameters()]
    loss, _ = tm.loss(tm.preprocess(torch.from_numpy(imgs)))
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.modules.parameters()))))
    scale = max(g.abs().max().item() for g in want_g.values())
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), want_g[k].numpy(),
                                   atol=1e-5 * scale, rtol=1e-4, err_msg=k)

    tm.modules.load_state_dict(weights, strict=True)     # undo the ema move
    tstate, tmetrics = tm.train_step(tstate, (torch.from_numpy(imgs),
                                              torch.from_numpy(labels)))
    assert tstate.step == 1
    for key in ("train_loss/vq_loss", "train_loss/recon_loss", "train_loss/commit_loss"):
        np.testing.assert_allclose(float(tmetrics[key]), float(metrics[key]),
                                   rtol=RTOL, atol=1e-12, err_msg=key)
    want_p = flax_to_torch(flatten(new_state.params))
    for k, p in tm.modules.named_parameters():
        big = want_g[k].abs().numpy() > G_FLOOR
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], want_p[k].numpy()[big], atol=PARAM_ATOL,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(got - weights[k].numpy()) <= LR * (1 + 1e-3)), k
    if mode == "ema":
        new = flax_mutables_to_torch(flatten(new_state.mutables))
        for name in ("embedding", "cluster_size", "cluster_sum"):
            close(getattr(tm.modules["vq"], name).numpy(), new[f"vq.{name}"].numpy())


def test_forward_sample_and_validation():
    jm, state, tm, weights = _models("gradient")
    tm.modules.load_state_dict(weights, strict=True)
    imgs = np.random.default_rng(11).integers(0, 256, (2, 16, 16, 3), np.uint8)
    x = jm.preprocess(jnp.asarray(imgs))
    close(tm.forward(None, torch.from_numpy(np.array(x))).numpy(), jm.forward(state, x))
    result, metrics = tm.validation_step(
        None, (torch.from_numpy(imgs), torch.zeros(2, dtype=torch.int32)))
    assert result.recon_image.shape == (2, 16, 16, 3)
    assert float(metrics["val/recon_loss"]) > 0
    gen = torch.Generator().manual_seed(0)
    out = tm.sample(3, gen)
    assert out.shape == (3, 16, 16, 3) and torch.isfinite(out).all()
    # the reference config's K: spelling
    assert VQVAE(datamodule=DM, encoder=ENC, decoder=DEC, latent_dim=LATENT,
                 K=32, device="cpu").modules["vq"].embedding.shape == (32, LATENT)
