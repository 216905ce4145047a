"""The port's LatentDDPM against igm_tpu's, at a tiny size: 16x16x3 images,
4x4x8 latents, K = 16 codes, encoder/decoder widths 8, a UNet of hidden 8
with dim_mults [1, 2], T = 20.

Both models hold the same weights (Flax init, perturbed, converted through
igm_tpu_torch.interop, the latent scale included); every random draw is
igm_tpu's, replayed from its keys and handed to the port.  Also: the
first-stage splice from a port VQ-VAE checkpoint, and the latent scale and
EMA codebook through checkpoints and a resumed fit.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.core.state import TrainState  # noqa: E402
from igm_tpu.models.latent_ddpm import LatentDDPM as JaxLatentDDPM  # noqa: E402
from igm_tpu.ops import diffusion as jgd  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from igm_tpu_torch.core.trainer import Trainer  # noqa: E402
from igm_tpu_torch.interop import (  # noqa: E402
    flax_key_to_torch, flax_mutables_to_torch, flax_to_torch)
from igm_tpu_torch.models.ddpm import DDPM  # noqa: E402
from igm_tpu_torch.models.latent_ddpm import LatentDDPM  # noqa: E402
from igm_tpu_torch.models.vqvae import VQVAE  # noqa: E402

torch.set_num_threads(1)

DM = {"width": 16, "height": 16, "channels": 3,
      "transforms": {"convert": True, "normalize": True}}
ENC = {"_target_": "igm_tpu.networks.vqvae.Encoder", "res_h_dim": 8}
DEC = {"_target_": "igm_tpu.networks.vqvae.Decoder", "h_dim": 8, "res_h_dim": 8}
T_STEPS, SCALE = 20, 1.7
KW = dict(latent_dim=8, num_embeddings=16, hidden_dim=8, dim_mults=(1, 2),
          timesteps=T_STEPS, compute_dtype="float32")
# float32 on both sides: convolutions and reductions sum in another order, a
# few ulps per layer of O(1) values
RTOL = 1e-5
# DDIM without the x0 clip (x0_bound = 0): the first step divides the eps gap
# by sqrt(alphas_cumprod[19]) = 2.5e-3 on the way to x0, and nothing bounds it
# back; the decode then carries that gap through the decoder
DDIM_ATOL = DDIM_RTOL = 2e-4
TINY = ["experiment=latent_ddpm/cifar10", "datamodule.width=16", "datamodule.height=16",
        "model.latent_dim=8", "model.num_embeddings=16", "model.hidden_dim=8",
        "model.timesteps=8", "+networks.encoder.res_h_dim=8",
        "+networks.decoder.h_dim=8", "+networks.decoder.res_h_dim=8"]


def flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol=RTOL, atol=None):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max() if atol is None else atol)


def _to_flax(path: str, value: np.ndarray) -> np.ndarray:
    """The inverse of interop's layout change for one leaf."""
    if not path.endswith("/kernel"):
        return value
    if value.ndim == 2:
        return value.T
    if path.split("/")[-3].startswith("ConvTranspose_"):
        return value.transpose(2, 3, 0, 1)[::-1, ::-1]
    return value.transpose(2, 3, 1, 0)


@pytest.fixture(scope="module")
def pair():
    """igm_tpu's param tree filled from the port's init (perturbed), which
    saves compiling igm_tpu's init; the round trip through interop is
    checked."""
    jm = JaxLatentDDPM(datamodule=to_node(DM), encoder=to_node(ENC),
                       decoder=to_node(DEC), **KW)
    jm.steps_per_epoch = 1
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.init_state, key)
    tm = LatentDDPM(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu", **KW)
    rng = np.random.default_rng(1)
    weights = {k: (v + 0.05 * torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)))
               for k, v in tm.modules.state_dict().items() if k != "latent.scale"}
    leaves = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.params)[0]:
        flat = "/".join(k.key for k in path)
        value = _to_flax(flat, weights[flax_key_to_torch(flat)].numpy())
        assert value.shape == leaf.shape, flat
        leaves.append(jnp.asarray(np.ascontiguousarray(value)))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes.params),
                                          leaves)
    mutables = {"denoise": {}, "encoder": {}, "decoder": {}, "vq": {},
                "latent": {"scale": jnp.float32(SCALE)}}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, mutables=mutables,
                       opt_states={}, rng=key)
    converted = {**flax_to_torch(flatten(params)), **flax_mutables_to_torch(flatten(mutables))}
    assert set(converted) == set(weights) | {"latent.scale"}
    for k, v in weights.items():
        assert torch.equal(converted[k], v), k
    tm.modules.load_state_dict(converted, strict=True)
    return jm, state, tm


def _imgs(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3), np.uint8)


def test_encode_decode_match_igm_tpu(pair):
    jm, state, tm = pair
    assert float(tm.scale) == pytest.approx(SCALE)
    x = jm.preprocess(jnp.asarray(_imgs(4, 2)))
    want_z = jm.encode(state, x)
    got_z = tm.encode(torch.from_numpy(np.array(x)))
    assert got_z.shape == (4, 4, 4, 8)
    close(got_z.numpy(), want_z)
    # decode from latents spread over the codes: the same codes chosen, then
    # the decoder
    z = np.random.default_rng(3).normal(size=(4, 4, 4, 8)).astype(np.float32)
    z = z * 0.05 * SCALE
    (_, _, _, want_idx), _ = jm.modules.apply("vq", state.params, state.mutables,
                                              jnp.asarray(z) / SCALE, train=False)
    (_, _, _, got_idx) = tm.modules["vq"](torch.from_numpy(z) / tm.scale, train=False)
    assert len(set(got_idx.tolist())) > 4           # many codes in play
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    close(tm.decode(torch.from_numpy(z)).numpy(), jm.decode(state, jnp.asarray(z)))


def test_on_fit_start_calibrates_the_scale_as_igm_tpu(pair):
    """latent_scale=auto: 1/std (the population std) of the encoder latents
    over the first 256 training images.

    Held within 1e-6 relative to igm_tpu's formula evaluated in float64 on
    igm_tpu's own latents, and within 4e-6 to igm_tpu's float32 value:
    ``jnp.std``'s float32 sums over the 32,768 latents run in XLA's order
    and land 1.4e-6 (relative) off the float64 value for these weights,
    where torch's sums land within 2e-8 of it."""
    jm, state, tm = pair
    arrays = (_imgs(300, 4), np.zeros(300, np.int32))
    want = float(jm.on_fit_start(state, arrays).mutables["latent"]["scale"])
    z = np.asarray(jm.modules.apply("encoder", state.params, state.mutables,
                                    jm.preprocess(jnp.asarray(arrays[0][:256])),
                                    train=False)[0], np.float64)
    exact = 1.0 / max(z.std(), 1e-6)
    try:
        tm.on_fit_start(None, arrays)
        got = float(tm.scale)
    finally:
        tm.scale.fill_(SCALE)
    assert got != pytest.approx(SCALE)
    assert got == pytest.approx(exact, rel=1e-6)
    assert got == pytest.approx(want, rel=4e-6)


def test_ddim_eta0_then_decode_matches_igm_tpu(pair):
    jm, state, tm = pair
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jm.ddim_sample(state, rng, 2, steps=5))
    init_rng, _ = jax.random.split(rng)              # as ddim_sample draws x_T
    x_T = np.asarray(jax.random.normal(init_rng, (2, 4, 4, 8)))
    got = tm.ddim_sample(2, steps=5, x_T=torch.from_numpy(x_T.copy()))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=DDIM_RTOL)


def test_train_step_loss_matches_igm_tpu(pair):
    """The l1 eps loss on the encoded batch, with igm_tpu's own timesteps and
    noise (its key schedule replayed: next_rng(2), randint, normal), as
    igm_tpu's train_step computes it (``models/ddpm.py:205-236``)."""
    jm, state, tm = pair
    imgs = _imgs(4, 5)
    labels = np.zeros(4, np.int32)
    keys = jax.random.split(state.rng, 3)[1:]
    t = jax.random.randint(keys[0], (4,), 0, T_STEPS)
    noise = jax.random.normal(keys[1], (4, 4, 4, 8))

    @jax.jit
    def jax_loss(imgs):
        x0 = jm._to_diffusion_space(state, jm.preprocess(imgs))
        x_noisy = jgd.q_sample(jm.tables, x0, t, noise)
        pred, _ = jm.modules.apply("denoise", state.params, state.mutables, x_noisy, t)
        return jnp.abs(noise - pred).mean()

    want = float(jax_loss(jnp.asarray(imgs)))
    before = {k: v.clone() for k, v in tm.modules.state_dict().items()}
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(before, strict=True)
    try:
        tstate, tmetrics = tm.train_step(
            tstate, (torch.from_numpy(imgs), torch.from_numpy(labels)),
            t=torch.from_numpy(np.array(t, np.int64)), noise=torch.from_numpy(np.array(noise)))
        after = tm.modules.state_dict()
        # only the denoiser moves
        for k, v in before.items():
            assert torch.equal(after[k], v) == (not k.startswith("denoise.")), k
    finally:
        tm.modules.load_state_dict(before, strict=True)
    np.testing.assert_allclose(float(tmetrics["train_loss/loss"]), want, rtol=RTOL)


def _vqvae(tmp_path, latent_dim=8, mode="gradient"):
    """A port VQ-VAE checkpoint (moved off its init) in tmp_path."""
    vq = VQVAE(datamodule=DM, encoder=ENC, decoder=DEC, latent_dim=latent_dim,
               num_embeddings=16, codebook_update=mode, device="cpu")
    state = vq.init_state(3)
    with torch.no_grad():
        for p in vq.modules.parameters():
            p.add_(0.01)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    mgr.wait()
    return vq


@pytest.mark.parametrize("mode", ["gradient", "ema"])
def test_first_stage_splice_from_a_port_checkpoint(tmp_path, mode):
    vq = _vqvae(tmp_path, mode=mode)
    tm = LatentDDPM(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu",
                    first_stage_ckpt=str(tmp_path), codebook_update=mode, **KW)
    tm.init_state(0)
    for name in ("encoder", "decoder", "vq"):
        want = vq.modules[name].state_dict()
        got = tm.modules[name].state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), f"{name}.{k}"
    # frozen: the optimizer owns the denoiser only
    owned = {id(p) for g in tm.state.opt_states["opt"].param_groups for p in g["params"]}
    assert owned == {id(p) for p in tm.modules["denoise"].parameters()}


def test_first_stage_splice_refuses_what_does_not_fit(tmp_path):
    _vqvae(tmp_path / "narrow", latent_dim=4)
    with pytest.raises(ValueError, match="first-stage 'encoder' shape mismatch"):
        LatentDDPM(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu",
                   first_stage_ckpt=str(tmp_path / "narrow"), **KW).init_state(0)
    ddpm = DDPM(datamodule=DM, hidden_dim=8, dim_mults=(1, 2), timesteps=4,
                device="cpu")
    mgr = CheckpointManager(str(tmp_path / "other"))
    mgr.save(1, ddpm.init_state(0))
    mgr.wait()
    with pytest.raises(ValueError, match="not a vqvae checkpoint"):
        LatentDDPM(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu",
                   first_stage_ckpt=str(tmp_path / "other"), **KW).init_state(0)
    with pytest.raises(FileNotFoundError):
        LatentDDPM(datamodule=DM, encoder=ENC, decoder=DEC, device="cpu",
                   first_stage_ckpt=str(tmp_path / "missing"), **KW).init_state(0)


def test_checkpoint_keeps_the_scale_and_ema_codebook_and_wins_on_resume(tmp_path,
                                                                        monkeypatch):
    """A fit writes the calibrated scale and the EMA buffers; a resumed fit
    calibrates afresh (on_fit_start), then restores, so the checkpoint's
    values win."""
    monkeypatch.chdir(tmp_path)
    cfg = compose(REPO / "configs", [*TINY, "model.codebook_update=ema",
                                     "datamodule.batch_size=16",
                                     f"datamodule.data_dir={tmp_path / 'data'}"])
    datamodule = instantiate(cfg.datamodule)

    def fit(epochs, resume=None):
        model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
        trainer = Trainer(max_epochs=epochs, limit_train_batches=2, limit_val_batches=1,
                          check_val_every_n_epoch=10, resume=resume)
        trainer.fit(model, datamodule)
        return model

    first = fit(1, resume=str(tmp_path / "ckpt"))
    scale = float(first.scale)
    assert scale != 1.0 and np.isfinite(scale)
    path = tmp_path / "ckpt" / "step_2.pt"
    saved = torch.load(path, weights_only=True)
    assert float(saved["params"]["latent.scale"]) == scale
    for name in ("embedding", "cluster_size", "cluster_sum"):
        assert f"vq.{name}" in saved["params"]
    saved["params"]["latent.scale"] = torch.tensor(2.5)
    saved["params"]["vq.cluster_size"] = torch.full((16,), 3.0)
    torch.save(saved, path)
    resumed = fit(2, resume=str(tmp_path / "ckpt"))
    assert float(resumed.scale) == 2.5
    assert torch.equal(resumed.modules["vq"].cluster_size, torch.full((16,), 3.0))
    # a fit from scratch calibrates the first stage's own scale
    assert float(fit(1).scale) == scale


def test_dpm_sample_then_decode_matches_igm_tpu(pair):
    jm, state, tm = pair
    rng = jax.random.PRNGKey(8)
    want = np.asarray(jm.dpm_sample(state, rng, 2, steps=6, schedule="logsnr"))
    init_rng, _ = jax.random.split(rng)              # as dpm_sample draws x_T
    x_T = np.asarray(jax.random.normal(init_rng, (2, 4, 4, 8)))
    got = tm.dpm_sample(2, steps=6, schedule="logsnr", x_T=torch.from_numpy(x_T.copy()))
    assert got.shape == (2, 16, 16, 3)
    # no x0 clip in latent space, as DDIM
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=DDIM_RTOL)


def test_inpaint_matches_igm_tpu(pair):
    """Latent RePaint with a hole that straddles latent cells: the pixel mask
    min-pooled to the 4x4 latent grid (holes grow to whole cells), the draws
    of igm_tpu's key schedule in latent shape, the decode, then the known
    pixels composited back bit for bit."""
    from test_torch_ddpm import repaint_draws
    jm, state, tm = pair
    x0 = np.asarray(jm.preprocess(jnp.asarray(_imgs(2, 9))))
    mask = np.ones((1, 16, 16, 1), np.float32)
    mask[:, 3:9, 5:14] = 0.0                         # rows 3-8, cols 5-13: cells 0-2 x 1-3
    key = jax.random.PRNGKey(9)
    want = np.asarray(jm.inpaint(state, key, jnp.asarray(x0), jnp.asarray(mask)))
    x_T, draws = repaint_draws(key, T_STEPS, 1, (2, 4, 4, 8))
    got = tm.inpaint(torch.from_numpy(x0.copy()), torch.from_numpy(mask), x_T=x_T,
                     draws=draws)
    assert got.shape == (2, 16, 16, 3)
    known = np.broadcast_to(mask, x0.shape) == 1
    np.testing.assert_array_equal(got.numpy()[known], x0[known])      # bit for bit
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=DDIM_RTOL)
