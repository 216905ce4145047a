"""The port's sampling CLI (igm_tpu_torch.cli.sample_main) on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.cli import sample_main  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402

torch.set_num_threads(1)

TINY = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
        "model.timesteps=6"]


def _grid(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


@pytest.mark.parametrize("sampler", [[], ["--sampler", "ddim", "--steps", "3"]],
                         ids=["ancestral", "ddim"])
def test_sample_main_writes_png(tmp_path, capsys, sampler):
    out = tmp_path / "grid.png"
    sample_main([*TINY, "--n", "4", "--device", "cpu", "--out", str(out),
                 *sampler])
    assert "random init from seed 0" in capsys.readouterr().out
    grid = _grid(out)
    # 4 images of 32x32 in one row, 2 px padding
    assert grid.shape == (2 + 34, 2 + 4 * 34, 3) and grid.dtype == np.uint8


def test_sample_main_loads_state_dict_weights(tmp_path):
    """--weights with a torch.save'd state_dict: the grid follows the
    weights, not the seed's init."""
    cfg = compose(REPO / "configs", TINY)
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    model.init_params(123)
    weights = tmp_path / "w.pt"
    torch.save(model.modules["denoise"].state_dict(), weights)
    args = [*TINY, "--n", "2", "--device", "cpu", "--sampler", "ddim",
            "--steps", "2"]
    sample_main([*args, "--weights", str(weights), "--out", str(tmp_path / "a.png")])
    sample_main([*args, "--out", str(tmp_path / "b.png")])
    model.init_params(0)
    torch.save(model.modules["denoise"].state_dict(), weights)
    sample_main([*args, "--weights", str(weights), "--out", str(tmp_path / "c.png")])
    a, b, c = (_grid(tmp_path / f"{s}.png") for s in "abc")
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(b, c)


def test_sample_main_loads_igm_tpu_npz_weights(tmp_path):
    """--weights with an .npz of igm_tpu denoiser leaves by '/'-joined path
    samples exactly as the same weights converted and saved by torch."""
    import jax

    from igm_tpu.config import compose as jax_compose
    from igm_tpu.config import instantiate as jax_instantiate
    from igm_tpu_torch.interop import flax_to_torch

    cfg = jax_compose(REPO / "configs", TINY)
    jm = jax_instantiate(cfg.model, datamodule=cfg.datamodule,
                         compute_dtype="float32")
    jm.steps_per_epoch = 1
    params = jm.init_state(jax.random.PRNGKey(3)).params["denoise"]
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    torch.save(flax_to_torch(flat), tmp_path / "w.pt")
    args = [*TINY, "--n", "2", "--device", "cpu", "--sampler", "ddim",
            "--steps", "2"]
    for ext in ("npz", "pt"):
        sample_main([*args, "--weights", str(tmp_path / f"w.{ext}"),
                     "--out", str(tmp_path / f"{ext}.png")])
    np.testing.assert_array_equal(_grid(tmp_path / "npz.png"),
                                  _grid(tmp_path / "pt.png"))


FIRST_STAGE_TINY = ["datamodule.width=16", "datamodule.height=16", "model.latent_dim=8",
                    "model.num_embeddings=16", "+networks.encoder.res_h_dim=8",
                    "+networks.decoder.h_dim=8", "+networks.decoder.res_h_dim=8"]


def test_vqvae_then_latent_ddpm_then_sample(tmp_path, monkeypatch):
    """The user's chain through the CLIs: train a VQ-VAE, train a latent DDPM
    on its frozen first stage, sample from the latent DDPM's checkpoint."""
    from igm_tpu_torch.cli import train_main
    monkeypatch.chdir(tmp_path)
    common = [*FIRST_STAGE_TINY, "trainer.max_epochs=1", "trainer.limit_train_batches=2",
              "trainer.limit_val_batches=1", "datamodule.batch_size=16", "logger=null",
              "print_config=False", f"datamodule.data_dir={tmp_path / 'data'}",
              "--device", "cpu"]
    vq_loss = train_main(["experiment=vqvae/cifar10", "optimized_metric=val/recon_loss",
                          *common])
    assert np.isfinite(vq_loss)
    vq_run = tmp_path / "logs" / "runs" / "vqvae" / "cifar10"
    assert [p.name for p in (vq_run / "checkpoints").iterdir()] == ["step_2.pt"]
    assert (vq_run / "results" / "recon_0.jpg").is_file()

    latent = ["experiment=latent_ddpm/cifar10", "model.hidden_dim=8", "model.timesteps=6"]
    loss = train_main([*latent, f"model.first_stage_ckpt={vq_run / 'checkpoints'}",
                       "model.val_sampler=ddim", "model.ddim_steps=2", "model.sample_batch=4",
                       "optimized_metric=train_loss/loss", *common])
    assert np.isfinite(loss)
    run = tmp_path / "logs" / "runs" / "latent_ddpm" / "cifar10"
    saved = torch.load(run / "checkpoints" / "step_2.pt", weights_only=True)
    first = torch.load(vq_run / "checkpoints" / "step_2.pt", weights_only=True)
    for k, v in first["params"].items():               # the frozen first stage
        assert torch.equal(saved["params"][k], v), k
    scale = float(saved["params"]["latent.scale"])
    assert np.isfinite(scale) and scale != 1.0          # calibrated at fit start
    assert (run / "results" / "0.jpg").is_file()

    out = tmp_path / "samples.png"
    # overrides may follow the options
    sample_main([*latent, "--ckpt", str(run / "checkpoints"), *FIRST_STAGE_TINY,
                 "--sampler", "ddim", "--steps", "3", "--n", "4", "--device", "cpu",
                 "--out", str(out)])
    assert _grid(out).shape == (2 + 18, 2 + 4 * 18, 3)
    sample_main(["experiment=vqvae/cifar10", *FIRST_STAGE_TINY, "--ckpt",
                 str(vq_run / "checkpoints"), "--n", "2", "--device", "cpu",
                 "--out", str(tmp_path / "codes.png")])
    assert _grid(tmp_path / "codes.png").shape == (2 + 18, 2 + 2 * 18, 3)


TAR_TINY = ["experiment=tar/mnist", "datamodule.width=6", "datamodule.height=6",
            "model.d_model=16", "model.nhead=2", "model.num_layers=1",
            "model.flash_attention=dropout"]


def test_tar_train_resume_and_sample(tmp_path, monkeypatch):
    """TAR through the CLIs with the dropout flash attention (its plain
    versions on the CPU): train with validation (samples and the masked
    completion), resume at the saved step, sample from the checkpoints."""
    from igm_tpu_torch.cli import train_main
    monkeypatch.chdir(tmp_path)
    common = ["trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=8", "logger=null",
              "print_config=False", "optimized_metric=val_log/bpd",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    run = tmp_path / "logs" / "runs" / "tar" / "mnist"
    for epochs, ckpts, grids in ((1, ["step_2.pt"], ["0.jpg", "mask_image_0.jpg"]),
                                 (2, ["step_2.pt", "step_4.pt"],
                                  ["0.jpg", "1.jpg", "mask_image_0.jpg", "mask_image_1.jpg"])):
        bpd = train_main([*TAR_TINY, f"trainer.max_epochs={epochs}",
                          f"trainer.resume={run / 'checkpoints'}", *common])
        assert np.isfinite(bpd)
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
        assert sorted(p.name for p in (run / "results").iterdir()) == grids
    out = tmp_path / "tar.png"
    sample_main([*TAR_TINY, "--ckpt", str(run / "checkpoints"), "--n", "4", "--device",
                 "cpu", "--out", str(out)])
    grid = _grid(out)
    assert grid.shape == (2 + 8, 2 + 4 * 8, 3)
    # samples are binary pixels: black or white in the grid, padding black
    assert set(np.unique(grid)) <= {0, 127, 128, 255}


def test_tar_weights_load_into_the_net(tmp_path):
    """--weights takes TAR's net: an .npz of igm_tpu's TARNet leaves samples
    exactly as the same weights converted and saved by torch."""
    import jax

    from igm_tpu.config import compose as jax_compose
    from igm_tpu.config import instantiate as jax_instantiate
    from igm_tpu_torch.interop import flax_to_torch

    cfg = jax_compose(REPO / "configs", TAR_TINY)
    jm = jax_instantiate(cfg.model, datamodule=cfg.datamodule)
    jm.steps_per_epoch = 1
    params = jm.init_state(jax.random.PRNGKey(3)).params["net"]
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    torch.save(flax_to_torch(flat), tmp_path / "w.pt")
    for ext in ("npz", "pt"):
        sample_main([*TAR_TINY, "--n", "3", "--device", "cpu", "--weights",
                     str(tmp_path / f"w.{ext}"), "--out", str(tmp_path / f"{ext}.png")])
    sample_main([*TAR_TINY, "--n", "3", "--device", "cpu", "--out", str(tmp_path / "r.png")])
    a, b, c = (_grid(tmp_path / f"{s}.png") for s in ("npz", "pt", "r"))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sample_main_dpm_sampler(tmp_path):
    out = tmp_path / "dpm.png"
    imgs = sample_main([*TINY, "--n", "4", "--device", "cpu", "--sampler", "dpm",
                        "--steps", "3", "--out", str(out)])
    assert imgs.shape == (4, 32, 32, 3) and imgs.abs().max() <= 1.0
    assert _grid(out).shape == (2 + 34, 2 + 4 * 34, 3)


COND_TINY = ["experiment=ddpm/cond_mnist", "model.hidden_dim=8", "model.dim_mults=[1,2]",
             "model.timesteps=6"]


def test_sample_main_label_on_a_conditional_model(tmp_path):
    """--label draws every sample from one class: the class changes the
    samples of the same seed; a model without labels refuses it."""
    common = [*COND_TINY, f"datamodule.data_dir={tmp_path / 'data'}", "--n", "4",
              "--device", "cpu", "--sampler", "ddim", "--steps", "3"]
    grids = []
    for label in (1, 7):
        out = tmp_path / f"label{label}.png"
        sample_main([*common, "--label", str(label), "--out", str(out)])
        grids.append(_grid(out))
        assert grids[-1].shape == (2 + 30, 2 + 4 * 30, 3)
    assert not np.array_equal(*grids)
    with pytest.raises(SystemExit, match="VQVAE is not class-conditional"):
        sample_main(["experiment=vqvae/cifar10", *FIRST_STAGE_TINY, "--label", "1", "--n",
                     "2", "--device", "cpu", "--out", str(tmp_path / "vq.png")])


def test_sample_main_inpaint(tmp_path):
    """--inpaint center --resample 2 on validation images: the grid holds the
    masked inputs, then the results, whose known pixels are the inputs'."""
    out = tmp_path / "inpaint.png"
    imgs = sample_main([*TINY, f"datamodule.data_dir={tmp_path / 'data'}", "--n", "3",
                        "--device", "cpu", "--inpaint", "center", "--resample", "2",
                        "--out", str(out)])
    assert imgs.shape == (6, 32, 32, 3)
    known = torch.ones(32, 32, dtype=torch.bool)
    known[8:24, 8:24] = False
    masked, painted = imgs[:3], imgs[3:]
    assert torch.equal(painted[:, known], masked[:, known])
    assert (masked[:, ~known] == 0).all() and not (painted[:, ~known] == 0).all()
    assert _grid(out).shape == (2 + 34, 2 + 6 * 34, 3)


@pytest.mark.parametrize("sampler", ["heun", "multistep"])
def test_sample_main_refuses_a_sampler_the_model_lacks(tmp_path, sampler):
    with pytest.raises(SystemExit, match=f"--sampler {sampler}: DDPM has no {sampler}_sample"):
        sample_main([*TINY, "--n", "2", "--device", "cpu", "--sampler", sampler,
                     "--out", str(tmp_path / "x.png")])
