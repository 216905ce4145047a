"""The adversarial zoo through the port's config and entry points on the
CPU: every one of the repo's experiment configs resolves each of its
``_target_``s in the port; the 33 zoo experiments (and speed_gan on
vanilla_gan/cifar10) compose, instantiate with their callbacks and train
through a period of steps at a tiny width; ``python -m
igm_tpu_torch.train`` on wgan/mnist_mlp resumed mid-period equals the
uninterrupted run bit for bit, and the sampling CLI draws from its
checkpoint and from ``--weights``; an infogan/mnist fit logs the traversal
grids at its epoch's end."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.config import compose, instantiate, resolve_target  # noqa: E402

torch.set_num_threads(1)

EXPERIMENTS = sorted(str(p.relative_to(REPO / "configs" / "experiment"))[:-len(".yaml")]
                     for p in (REPO / "configs" / "experiment").rglob("*.yaml"))
ZOO = {"vanilla_gan": "GAN", "lsgan": "GAN", "ggan": "GAN", "wgan": "WGAN",
       "wgan_gp": "WGAN", "infogan": "InfoGAN", "bigan": "BiGAN", "vaegan": "VAEGAN",
       "aae": "AAE", "age": "AGE"}
ZOO_EXPERIMENTS = [e for e in EXPERIMENTS if e.split("/")[0] in ZOO]


def _targets(node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_target_":
                yield path, v
            else:
                yield from _targets(v, f"{path}.{k}" if path else k)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _targets(v, f"{path}[{i}]")


def test_the_repo_has_77_experiments_33_of_the_zoo():
    assert len(EXPERIMENTS) == 77 and len(ZOO_EXPERIMENTS) == 33


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_every_experiment_resolves_its_targets_in_the_port(experiment):
    cfg = compose(REPO / "configs", [f"experiment={experiment}", "print_config=False"])
    # hydra's own settings name its plugins (``hydra.launcher: joblib``)
    targets = {p: v for p, v in _targets(cfg) if not p.startswith("hydra")}
    assert "model" in targets and "datamodule" in targets
    for path, target in targets.items():
        obj = resolve_target(str(target))
        assert obj.__module__.startswith("igm_tpu_torch."), (path, target, obj.__module__)


def _tiny(experiment: str, tmp_path, *extra):
    cfg = compose(REPO / "configs", [f"experiment={experiment}", *extra, "print_config=False"])
    mlp = cfg.networks.encoder._target_.endswith("MLPEncoder")
    widths = (["networks.encoder.hidden_dims=[16]", "networks.decoder.hidden_dims=[16]"]
              if mlp else ["networks.encoder.ndf=4", "networks.decoder.ngf=4"])
    if experiment.startswith("bigan/"):
        widths.append("model.hidden_dim=8")
    return compose(REPO / "configs", [f"experiment={experiment}", *extra, *widths,
                                      "print_config=False", f"datamodule.data_dir={tmp_path}"])


@pytest.mark.parametrize("experiment", ZOO_EXPERIMENTS + ["vanilla_gan/cifar10 model=speed_gan"])
def test_zoo_experiment_instantiates_and_trains_a_period(experiment, tmp_path):
    name, *extra = experiment.split()
    cfg = _tiny(name, tmp_path, *extra)
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    assert type(model).__name__ == ZOO[name.split("/")[0]]
    assert type(model).__module__ == ("igm_tpu_torch.models.speed_gan" if extra else
                                      "igm_tpu_torch." + str(cfg.model._target_)[len("igm_tpu."):]
                                      .rsplit(".", 1)[0])
    for cb in cfg.callbacks.values():
        if isinstance(cb, dict) and "_target_" in cb:
            assert type(instantiate(cb)).__module__.startswith("igm_tpu_torch.")
    assert model.weights_module in model.modules and model.has_sampler()
    model.steps_per_epoch = 2
    state = model.init_state(0)
    n = 4
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (n, model.height, model.width, model.channels),
                         dtype=torch.uint8, generator=gen)
    ran = set()
    for _ in range(model.phase_period):
        state, metrics = model.train_step(state, (imgs, torch.zeros(n, dtype=torch.int32)))
        ran |= {k for k, v in metrics.items() if np.isfinite(float(v))}
    assert ran == set(metrics) and state.step == model.phase_period
    fake = model.sample(2, torch.Generator().manual_seed(1))
    assert fake.shape == (2, model.height, model.width, model.channels)


def _train(tmp_path, monkeypatch, *overrides):
    from igm_tpu_torch.cli import train_main
    monkeypatch.chdir(tmp_path)
    return train_main([*overrides, "trainer.limit_val_batches=1", "datamodule.batch_size=8",
                       "logger=null", "print_config=False",
                       f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"])


WGAN_TINY = ["experiment=wgan/mnist_mlp", "networks.encoder.hidden_dims=[16]",
             "networks.decoder.hidden_dims=[16]"]


def test_cli_resumes_wgan_mid_period_and_samples(tmp_path, monkeypatch):
    """Four steps an epoch against WGAN's period of six: the second epoch's
    first step (4) is mid-period.  A run of one epoch resumed for a second
    ends where a run of two does, bit for bit; then igm-sample from the
    checkpoint and from the generator's weights alone."""
    from PIL import Image
    from igm_tpu_torch.cli import sample_main
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    steps = ["trainer.limit_train_batches=4", "optimized_metric=train_loss/d_loss"]
    runs = {}
    for kind in ("whole", "resumed"):
        root = tmp_path / kind
        root.mkdir()
        ckpt = root / "logs" / "runs" / "wgan_mlp_mnist" / "checkpoints"
        if kind == "resumed":
            _train(root, monkeypatch, *WGAN_TINY, *steps, "trainer.max_epochs=1")
            assert sorted(p.name for p in ckpt.iterdir()) == ["step_4.pt"]
            over = [f"trainer.resume={ckpt}"]
        else:
            over = []
        d_loss = _train(root, monkeypatch, *WGAN_TINY, *steps, "trainer.max_epochs=2", *over)
        assert np.isfinite(d_loss)
        runs[kind] = (ckpt, CheckpointManager(str(ckpt)).restore_raw(8))
    whole, resumed = runs["whole"][1], runs["resumed"][1]
    assert whole["step"] == resumed["step"] == 8
    for k, v in whole["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
    for name in ("g", "d"):
        a, b = whole["opt_states"][name]["state"], resumed["opt_states"][name]["state"]
        assert all(torch.equal(a[i][key], b[i][key]) for i in a for key in a[i]), name
        # G updated on steps 0 and 6, D on the other six
        assert {float(st["step"]) for st in a.values()} == {2.0 if name == "g" else 6.0}
    out = tmp_path / "s.png"
    imgs = sample_main([*WGAN_TINY, "--ckpt", str(runs["resumed"][0]), "--n", "5",
                        "--out", str(out), "--device", "cpu"])
    assert imgs.shape == (5, 28, 28, 1) and bool(torch.isfinite(imgs).all())
    with Image.open(out) as img:
        assert img.size == (2 + 5 * 30, 2 + 30)
    net_g = {k[len("netG."):]: v for k, v in resumed["params"].items() if k.startswith("netG.")}
    torch.save(net_g, tmp_path / "netG.pt")
    again = sample_main([*WGAN_TINY, "--weights", str(tmp_path / "netG.pt"), "--n", "5",
                         "--out", str(out), "--device", "cpu"])
    assert torch.equal(again, imgs)


def test_cli_infogan_logs_its_traversal_grids(tmp_path, monkeypatch):
    from igm_tpu_torch.core.logging import NoOpLogger
    logged = {}
    monkeypatch.setattr(NoOpLogger, "log_image",
                        lambda self, tag, img, step: logged.setdefault(tag, (img.shape, step)))
    loss = _train(tmp_path, monkeypatch, "experiment=infogan/mnist", "networks.encoder.ndf=4",
                  "networks.decoder.ngf=4", "model.encode_dim=16", "trainer.max_epochs=1",
                  "trainer.limit_train_batches=2", "optimized_metric=train_loss/g_loss")
    assert np.isfinite(loss)
    assert {"visual/traverse over discrete values", "visual/traverse over first continuous values",
            "visual/traverse over second continuous values", "images/sample"} <= set(logged)
    assert logged["visual/traverse over discrete values"] == ((2 + 8 * 30, 2 + 10 * 30, 3), 0)


def test_cli_fits_wgan_gp_through_the_flop_counter(tmp_path, monkeypatch):
    """The trainer counts the first chunk's FLOPs under FlopCounterMode,
    whose module tracker refuses the gradient penalty's
    torch.autograd.grad with respect to a leaf input; the trainer's counter
    tracks no module, and counts the penalty's products too."""
    from igm_tpu_torch.core.trainer import step_flop_counter
    loss = _train(tmp_path, monkeypatch, "experiment=wgan_gp/mnist_mlp",
                  "networks.encoder.hidden_dims=[16]", "networks.decoder.hidden_dims=[16]",
                  "trainer.max_epochs=1", "trainer.limit_train_batches=2",
                  "optimized_metric=train_loss/d_loss")
    assert np.isfinite(loss)
    cfg = _tiny("wgan_gp/mnist_mlp", tmp_path)
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    state = model.init_state(0)
    imgs = torch.zeros((4, 28, 28, 1), dtype=torch.uint8)
    with step_flop_counter() as counter:
        model.train_step(state, (imgs, torch.zeros(4, dtype=torch.int32)))    # D: the penalty
    flops = counter.get_total_flops()
    with step_flop_counter() as counter:
        model.train_step(state, (imgs, torch.zeros(4, dtype=torch.int32)))    # D again
    assert flops == counter.get_total_flops() > 0
