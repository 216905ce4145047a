"""The port's training path on the CPU at a tiny size: Trainer.fit with
validation, the sample-grid callback and checkpoints; resume; the training
CLI (python -m igm_tpu_torch.train ... --device cpu)."""
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.cli import train_main  # noqa: E402
from igm_tpu_torch.config import compose  # noqa: E402
from igm_tpu_torch.core.trainer import Trainer  # noqa: E402
from igm_tpu_torch.train import train  # noqa: E402

torch.set_num_threads(1)

TINY = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
        "model.timesteps=8", "model.val_sampler=ddim", "model.ddim_steps=2",
        "model.sample_batch=4", "datamodule.batch_size=16",
        "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
        "trainer.check_val_every_n_epoch=1", "logger=null", "print_config=False",
        "optimized_metric=train_loss/loss"]


def _run(tmp_path, monkeypatch, name, *overrides):
    run_dir = tmp_path / name
    run_dir.mkdir(exist_ok=True)
    monkeypatch.chdir(run_dir)
    cfg = compose(REPO / "configs", [*TINY, f"datamodule.data_dir={tmp_path / 'data'}",
                                     *overrides])
    return train(cfg, "cpu"), run_dir


def test_resumed_run_equals_the_uninterrupted_one(tmp_path, monkeypatch):
    """Two epochs straight == one epoch, a resume from its checkpoint, and
    one more epoch: the same parameters, Adam moments and generator state,
    bit for bit (the resumed run skips the data permutation of the epoch it
    does not rerun, and continues the generator from the checkpoint)."""
    loss, straight = _run(tmp_path, monkeypatch, "straight", "trainer.max_epochs=2")
    assert math.isfinite(loss)
    _, cut = _run(tmp_path, monkeypatch, "cut", "trainer.max_epochs=1")
    assert sorted(p.name for p in (cut / "checkpoints").iterdir()) == ["step_2.pt"]
    _run(tmp_path, monkeypatch, "cut", "trainer.max_epochs=2",
         f"trainer.resume={cut / 'checkpoints'}")
    want = torch.load(straight / "checkpoints" / "step_4.pt", weights_only=True)
    got = torch.load(cut / "checkpoints" / "step_4.pt", weights_only=True)
    assert got["step"] == want["step"] == 4
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=0, rtol=0)
    for pid, s in want["opt_states"]["opt"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got["opt_states"]["opt"]["state"][pid][key],
                                       s[key], atol=0, rtol=0)
    assert torch.equal(got["generator"], want["generator"])
    # validation ran after each epoch (with its own generator, so it does not
    # move the training stream) and wrote its sample grid
    assert sorted(p.name for p in (straight / "results").iterdir()) == ["0.jpg", "1.jpg"]


def test_fit_with_ema_samples_from_the_shadow(tmp_path, monkeypatch):
    from igm_tpu_torch.config import instantiate
    cfg = compose(REPO / "configs", [*TINY, f"datamodule.data_dir={tmp_path}",
                                     "model.ema_decay=0.5"])
    monkeypatch.chdir(tmp_path)
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    trainer = Trainer(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                      enable_checkpointing=False)
    trainer.fit(model, instantiate(cfg.datamodule))
    ema = trainer.state.opt_states["ema"]
    live = dict(model.modules["denoise"].named_parameters())
    assert any(not torch.equal(ema[k], live[k]) for k in ema)
    x, t = torch.randn(2, 32, 32, 3), torch.tensor([1.0, 5.0])
    with torch.no_grad():
        want = torch.func.functional_call(model.modules["denoise"], ema, (x, t))
        torch.testing.assert_close(model._denoise(x, t), want, atol=0, rtol=0)


def test_train_main_trains_validates_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["experiment=ddpm/cifar10", "trainer.max_epochs=1",
            "trainer.limit_train_batches=2", "model.hidden_dim=8", "model.timesteps=8",
            "model.sample_batch=4", "datamodule.batch_size=16",
            f"datamodule.data_dir={tmp_path / 'data'}", "logger=null",
            "print_config=False", "optimized_metric=train_loss/loss"]
    first = train_main([*args, "--device", "cpu"])
    assert math.isfinite(first)
    run = tmp_path / "logs" / "runs" / "ddpm" / "cifar10"
    assert (run / "results" / "0.jpg").is_file()
    assert [p.name for p in (run / "checkpoints").iterdir()] == ["step_2.pt"]
    second = train_main([*args[:1], "trainer.max_epochs=2", *args[2:],
                         f"trainer.resume={run / 'checkpoints'}", "--device", "cpu"])
    assert math.isfinite(second)
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_2.pt",
                                                                      "step_4.pt"]
    assert "optimized_metric:" in capsys.readouterr().out


def test_trainer_takes_one_device_only():
    assert Trainer(steps_per_execution="auto").steps_per_execution == "auto"   # until fit
    Trainer(mesh={"data": -1, "model": 1})
    # a model axis builds; one process cannot make its two ranks (igm_tpu's error)
    trainer = Trainer(mesh={"data": -1, "model": 2})
    from igm_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="model axis 2 does not divide 1"):
        make_mesh(trainer.mesh_data, devices="cpu", **trainer.mesh_axes)
    with pytest.raises(ValueError, match="launch them"):
        Trainer(devices=4)          # its ranks: python -m igm_tpu_torch.train trainer.devices=4
    with pytest.raises(ValueError):
        Trainer(steps_per_execution="sometimes")
