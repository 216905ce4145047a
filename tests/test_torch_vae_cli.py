"""The VAE slice through the port's config and entry points on the CPU: the
12 experiments (vae/*, beta_vae/*, cvae/*, factor_vae/*) compose and
instantiate with their callbacks and take a train step at a tiny width;
``python -m igm_tpu_torch.train`` on vae/mnist_conv, then the sampling CLI
from its checkpoint; a vae/cifar10 fit whose FID callback logs
``metrics/fid_random_torch`` and whose traversal grids are written."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.config import compose, instantiate  # noqa: E402

torch.set_num_threads(1)

EXPERIMENTS = {
    "vae/celeba": "VAE", "vae/cifar10": "VAE", "vae/mnist_conv": "VAE",
    "vae/mnist_mlp": "VAE", "beta_vae/celeba": "VAE", "beta_vae/dsprites": "VAE",
    "cvae/mnist": "cVAE", "cvae/cifar10": "cVAE",
    "factor_vae/celeba": "FactorVAE", "factor_vae/dsprites": "FactorVAE"}
DEFAULT_CALLBACKS = {"eval_fid": "FIDEvaluationCallback",
                     "latent_visual": "LatentVisualizationCallback",
                     "sample": "SampleImagesCallback", "traverse": "TraverseLatentCallback",
                     "tqdm": "ProgressBar"}


def _tiny(cfg_overrides, networks: str):
    if networks.endswith("MLPEncoder"):
        return [*cfg_overrides, "networks.encoder.hidden_dims=[16]",
                "networks.decoder.hidden_dims=[16]"]
    return [*cfg_overrides, "networks.encoder.ndf=4", "networks.decoder.ngf=4"]


@pytest.mark.parametrize("experiment", sorted(EXPERIMENTS))
def test_experiment_instantiates_and_steps_in_the_port(experiment, tmp_path):
    cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
    cfg = compose(REPO / "configs", _tiny([f"experiment={experiment}", "print_config=False",
                                           f"datamodule.data_dir={tmp_path}"],
                                          cfg.networks.encoder._target_))
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    assert type(model).__name__ == EXPERIMENTS[experiment]
    assert type(model).__module__.startswith("igm_tpu_torch.")
    callbacks = {k: type(instantiate(v)).__name__ for k, v in cfg.callbacks.items()
                 if isinstance(v, dict) and "_target_" in v}
    if experiment.startswith("cvae/"):
        assert callbacks == {"sample": "SampleImagesCallback", "tqdm": "ProgressBar"}
    else:
        assert callbacks == DEFAULT_CALLBACKS
    for cb in cfg.callbacks.values():
        assert instantiate(cb).__class__.__module__.startswith("igm_tpu_torch.")
    model.steps_per_epoch = 2
    state = model.init_state(0)
    n = 4
    imgs = torch.randint(0, 256, (n, model.height, model.width, model.channels),
                         dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    if cfg.datamodule.get("transforms", {}).get("normalize") is False:
        imgs = (imgs > 127).to(torch.uint8)           # dSprites' {0, 1} pixels
    state, metrics = model.train_step(state, (imgs, torch.arange(n, dtype=torch.int32)))
    assert state.step == 1 and all(np.isfinite(float(v)) for v in metrics.values())
    fake = model.sample(2, torch.Generator().manual_seed(1))
    per = model.n_classes if experiment.startswith("cvae/") else 1
    assert fake.shape == (2 * per, model.height, model.width, model.channels)


@pytest.mark.parametrize("experiment,overrides,cls", [
    ("ddpm/celeba", ["model.hidden_dim=8", "model.dim_mults=[1,2]", "model.timesteps=8"],
     "DDPM"),
    ("pixelcnn/celeba", ["model.hidden_dim=4"], "PixelCNN")], ids=["ddpm", "pixelcnn"])
def test_celeba_experiments_of_ported_models_instantiate(experiment, overrides, cls,
                                                         tmp_path):
    """The CelebA datamodule opens the CelebA experiments of models ported
    before: they compose, instantiate and take a train step on the synthetic
    set (no files under data_dir)."""
    cfg = compose(REPO / "configs", [f"experiment={experiment}", *overrides,
                                     "print_config=False", f"datamodule.data_dir={tmp_path}"])
    dm = instantiate(cfg.datamodule)
    assert type(dm).__name__ == "CelebADataModule"
    dm.prepare_data()
    dm.setup()
    imgs, labels = dm.train_arrays()
    assert imgs.shape[1:] == (64, 64, 3) and imgs.dtype == np.uint8
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    assert type(model).__name__ == cls
    model.steps_per_epoch = 2
    state = model.init_state(0)
    state, metrics = model.train_step(state, (torch.from_numpy(imgs[:2]),
                                              torch.from_numpy(labels[:2])))
    assert all(np.isfinite(float(v)) for v in metrics.values())


def _train(tmp_path, monkeypatch, *overrides):
    from igm_tpu_torch.cli import train_main
    monkeypatch.chdir(tmp_path)
    return train_main([*overrides, "trainer.max_epochs=1", "trainer.limit_train_batches=2",
                       "trainer.limit_val_batches=1", "datamodule.batch_size=8",
                       "logger=null", "print_config=False",
                       f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"])


def test_cli_trains_vae_mnist_conv_then_samples(tmp_path, monkeypatch):
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.core.logging import NoOpLogger
    tiny = ["experiment=vae/mnist_conv", "networks.encoder.ndf=4",
            "networks.decoder.ngf=4", "model.latent_dim=8"]
    logged = {}
    monkeypatch.setattr(NoOpLogger, "log_image",
                        lambda self, tag, img, step: logged.setdefault(tag, (img.shape, step)))
    elbo = _train(tmp_path, monkeypatch, *tiny, "optimized_metric=train_log/elbo")
    assert np.isfinite(elbo)
    run = tmp_path / "logs" / "runs" / "vae" / "mnist_conv"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_2.pt"]
    results = sorted(p.name for p in (run / "results").iterdir())
    assert "0.jpg" in results
    grid = (2 + 11 * 30, 2 + 8 * 30, 3)          # 11 values x 8 latent dims, gray as RGB
    for tag in ("random_traverse_latents", "fixed_traverse_latents_1",
                "fixed_traverse_latents_2"):
        assert logged[f"sample/{tag}"] == (grid, 0)
    out = tmp_path / "samples.png"
    imgs = sample_main([*tiny, "--ckpt", str(run / "checkpoints"), "--n", "6",
                        "--out", str(out), "--device", "cpu"])
    assert imgs.shape == (6, 28, 28, 1) and bool(torch.isfinite(imgs).all())
    with Image.open(out) as img:
        assert img.size == (2 + 6 * 30, 2 + 30)
    # --weights takes the decoder (weights_module), as a state_dict file
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    saved = CheckpointManager(str(run / "checkpoints")).restore_raw()
    dec = {k[len("decoder."):]: v for k, v in saved["params"].items()
           if k.startswith("decoder.")}
    torch.save(dec, tmp_path / "decoder.pt")
    again = sample_main([*tiny, "--weights", str(tmp_path / "decoder.pt"), "--n", "6",
                         "--out", str(out), "--device", "cpu"])
    assert torch.equal(again, imgs)


def test_vae_cifar10_fit_logs_fid_random_torch(tmp_path, monkeypatch):
    """An RGB fit through the trainer with the default callbacks: the FID
    callback's value reaches callback_metrics (the optimized metric)."""
    monkeypatch.delenv("IGM_INCEPTION_WEIGHTS", raising=False)
    fid = _train(tmp_path, monkeypatch, "experiment=vae/cifar10", "networks.encoder.ndf=4",
                 "networks.decoder.ngf=4", "model.latent_dim=8",
                 "optimized_metric=metrics/fid_random_torch")
    assert fid is not None and np.isfinite(fid) and fid > 0
