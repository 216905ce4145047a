"""The port's Trainer against igm_tpu's on the same tiny run (a VAE on 8x8
synthetic images, MLP networks of width 8): the steps it logs, exactly, by
igm_tpu's rule (core/trainer.py:270-281); ``trainer.profile=true`` writing
a trace into the logger's save_dir on both sides; ``Trainer.log``."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu.config import compose as jax_compose  # noqa: E402
from igm_tpu.config import instantiate as jax_instantiate  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402

torch.set_num_threads(1)

TINY = ["experiment=vae/mnist_mlp", "datamodule.width=8", "datamodule.height=8",
        "datamodule.batch_size=8", "model.latent_dim=2",
        "networks.encoder.hidden_dims=[8]", "networks.decoder.hidden_dims=[8]",
        "trainer.limit_train_batches=3", "trainer.limit_val_batches=0",
        "trainer.enable_checkpointing=False", "print_config=False"]


class Recorder:
    """A logger that keeps the steps at which train metrics arrive."""

    def __init__(self, save_dir: str = ""):
        self.save_dir = save_dir
        self.steps, self.scalars = [], []

    def log_scalars(self, metrics, step):
        if any(k.startswith("train_log/") for k in metrics):
            self.steps.append(int(step))

    def log_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def log_image(self, *a, **k):
        pass

    def log_hyperparams(self, params):
        pass

    def finalize(self):
        pass


def _fit(package: str, tmp_path, overrides, logger):
    args = [*TINY, f"datamodule.data_dir={tmp_path / 'no_data'}", *overrides]
    if package == "igm_tpu":
        cfg = jax_compose(str(REPO / "configs"), args)
        dm = jax_instantiate(cfg.datamodule)
        model = jax_instantiate(cfg.model, datamodule=cfg.datamodule)
        trainer = jax_instantiate(cfg.trainer, logger=logger, callbacks=[])
    else:
        cfg = compose(REPO / "configs", args)
        dm = instantiate(cfg.datamodule)
        model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
        trainer = instantiate(cfg.trainer, logger=logger, callbacks=[])
    trainer.fit(model, dm)
    return trainer


@pytest.mark.parametrize("k,every", [(1, 2), (3, 2), (1, 50), (3, 50), (2, 3)],
                         ids=["k1-every2", "k3-every2", "k1-every50", "k3-every50",
                              "k2-every3"])
def test_logged_steps_equal_igm_tpus(tmp_path, monkeypatch, k, every):
    """Two epochs of 3 steps: igm_tpu logs an execution when its first step
    s has s % every < max(2, K), at s, and an epoch that logged nothing at
    its last step; the port logs the same steps."""
    monkeypatch.chdir(tmp_path)
    overrides = ["trainer.max_epochs=2", f"trainer.steps_per_execution={k}",
                 f"trainer.log_every_n_steps={every}"]
    want, got = Recorder(), Recorder()
    _fit("igm_tpu", tmp_path, overrides, want)
    _fit("igm_tpu_torch", tmp_path, overrides, got)
    assert got.steps == want.steps
    assert want.steps                  # every case logs something


def test_profile_writes_a_trace_into_the_loggers_save_dir(tmp_path, monkeypatch):
    """trainer.profile=true: igm_tpu writes a jax.profiler trace into the
    logger's save_dir, the port a torch.profiler Chrome trace."""
    monkeypatch.chdir(tmp_path)
    overrides = ["trainer.max_epochs=1", "trainer.profile=true",
                 "trainer.steps_per_execution=1"]
    jax_dir, port_dir = tmp_path / "jax_tb", tmp_path / "port_tb"
    _fit("igm_tpu", tmp_path, overrides, Recorder(str(jax_dir)))
    assert any(p.is_file() for p in jax_dir.rglob("*"))
    trainer = _fit("igm_tpu_torch", tmp_path, overrides, Recorder(str(port_dir)))
    traces = sorted(port_dir.glob("trace_step*.json"))
    assert [p.name for p in traces] == ["trace_step3.json"]
    assert trainer.profile_path == str(traces[0])
    text = traces[0].read_text()
    assert '"traceEvents"' in text and "aten::" in text


def test_trainer_log_reaches_callback_metrics_and_the_logger():
    from igm_tpu_torch.core.trainer import Trainer
    logger = Recorder()
    trainer = Trainer(logger=logger)
    trainer.global_step = 7
    trainer.log("metrics/fid_random_torch", 12.5)
    assert trainer.callback_metrics["metrics/fid_random_torch"] == 12.5
    assert logger.scalars == [("metrics/fid_random_torch", 12.5, 7)]
