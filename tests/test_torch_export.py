"""The port's sampler export (igm_tpu_torch/tools/export.py) on the CPU: an
exported artifact's --run output is, bit for bit, the batch
``python -m igm_tpu_torch.cli`` draws with the same weights, sampler,
steps, n and seed; the artifact carries every module state the sampler
reads (the EMA shadow, latent DDPM's first stage and calibrated latent
scale) as plain types and tensors; a sampler the model lacks exits loudly,
as ``tests/test_export.py`` asks of ``igm_tpu``'s tool."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.cli import sample_main  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.tools import export as ex  # noqa: E402

torch.set_num_threads(1)

UNET = ["model.hidden_dim=8", "model.dim_mults=[1,2]"]
# experiment, overrides, sampler and steps as the export and the CLI take them
CASES = {
    "ddpm_dpm": (["experiment=ddpm/cifar10", *UNET, "model.timesteps=6"], ["dpm", "3"]),
    "consistency_one_step": (["experiment=consistency/mnist", *UNET, "model.n_grid=8"],
                             ["multistep", "1"]),
    "edm_heun": (["experiment=edm/mnist", *UNET, "model.sample_steps=3"], ["heun", None]),
    "vae_default": (["experiment=vae/mnist_mlp", "networks.encoder.hidden_dims=[16]",
                     "networks.decoder.hidden_dims=[16]"], [None, None]),
}
FIRST_STAGE_TINY = ["datamodule.width=16", "datamodule.height=16", "model.latent_dim=8",
                    "model.num_embeddings=16", "+networks.encoder.res_h_dim=8",
                    "+networks.decoder.h_dim=8", "+networks.decoder.res_h_dim=8"]
N = 3


def _model(overrides, tmp_path):
    cfg = compose(REPO / "configs", [*overrides, f"datamodule.data_dir={tmp_path / 'data'}",
                                     "print_config=False"])
    return instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")


def _weights(overrides, tmp_path, seed: int = 7) -> Path:
    """The network's weights from a random init at ``seed``, as --weights takes them."""
    model = _model(overrides, tmp_path)
    model.init_params(seed)
    path = tmp_path / "w.pt"
    torch.save(model.modules[model.weights_module].state_dict(), path)
    return path


def _sampler_args(sampler, steps):
    return [*(["--sampler", sampler] if sampler else []), *(["--steps", steps] if steps else [])]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_equals_the_sampling_cli_bit_for_bit(case, tmp_path, capsys):
    overrides, (sampler, steps) = CASES[case]
    weights = _weights(overrides, tmp_path)
    art = tmp_path / "sampler.pt"
    ex.main([*overrides, "--weights", str(weights), "--n", str(N), *_sampler_args(sampler, steps),
             "--out", str(art), "--device", "cpu"])
    meta = json.loads(Path(f"{art}.json").read_text())
    assert meta["experiment"] == overrides[0].split("=")[1] and meta["n"] == N
    assert meta["sampler"] == (sampler or "default") and meta["step"] == 0

    grid = tmp_path / "run.png"
    got = ex.run(str(art), seed=3, out=str(grid), device="cpu")
    assert "ran " in capsys.readouterr().out and grid.stat().st_size > 100
    want = sample_main([*overrides, "--weights", str(weights), "--n", str(N), "--seed", "3",
                        *_sampler_args(sampler, steps), "--device", "cpu",
                        "--out", str(tmp_path / "cli.png")])
    assert list(got.shape) == meta["out_shape"][0]
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert not torch.equal(ex.run(str(art), seed=4, device="cpu"), got)


def test_score_sde_pc_equals_pc_sample(tmp_path):
    """--sampler pc (no --sampler pc in the CLI): the artifact's batch is the
    model's pc_sample from the same generator, clipped as every named
    sampler is."""
    overrides = ["experiment=score_sde/mnist", *UNET]
    weights = _weights(overrides, tmp_path)
    art = tmp_path / "sde.pt"
    meta = ex.export(overrides, str(art), n=N, sampler="pc", steps=3, weights=str(weights),
                     device="cpu")
    assert meta["sampler"] == "pc" and meta["steps"] == 3
    got = ex.run(str(art), seed=5, device="cpu")
    model = _model(overrides, tmp_path)
    model.modules["denoise"].load_state_dict(torch.load(weights, weights_only=True))
    want = torch.clamp(model.pc_sample(N, steps=3, generator=torch.Generator().manual_seed(5)),
                       -1.0, 1.0)
    assert torch.equal(got, want)


def test_latent_ddpm_artifact_carries_its_calibrated_scale_and_ema(tmp_path):
    """--ckpt: the artifact holds the first stage, the calibrated latent scale
    and the EMA shadow, and samples as the CLI does from that checkpoint (which
    samples from the shadow)."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    overrides = ["experiment=latent_ddpm/mnist", "model.hidden_dim=8", "model.timesteps=6",
                 "+model.ema_decay=0.999", *FIRST_STAGE_TINY]
    model = _model(overrides, tmp_path)
    model.steps_per_epoch = 1
    state = model.init_state(0)
    imgs = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 1), dtype=np.uint8)
    model.on_fit_start(state, (imgs,))                  # latent_scale=auto
    scale = float(model.scale)
    assert scale != 1.0
    with torch.no_grad():                               # the shadow apart from the weights
        for p in model.modules["denoise"].parameters():
            p.add_(0.01)
    state.step = 3
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, state)
    ckpt.wait()

    art = tmp_path / "latent.pt"
    meta = ex.export(overrides, str(art), n=2, sampler="ddim", steps=2,
                     ckpt=str(tmp_path / "ckpt"), device="cpu")
    assert meta["step"] == 3 and meta["out_shape"] == [[2, 16, 16, 1]]
    saved = torch.load(art, weights_only=True)
    assert float(saved["params"]["latent.scale"]) == scale
    ema = state.opt_states["ema"]
    assert saved["ema"].keys() == ema.keys()
    assert all(torch.equal(saved["ema"][k], v) for k, v in ema.items())
    for name in ("encoder", "decoder", "vq"):
        for k, v in model.modules[name].state_dict().items():
            assert torch.equal(saved["params"][f"{name}.{k}"], v), k
    got = ex.run(str(art), seed=1, device="cpu")
    want = sample_main([*overrides, "--ckpt", str(tmp_path / "ckpt"), "--n", "2", "--seed", "1",
                        "--sampler", "ddim", "--steps", "2", "--device", "cpu",
                        "--out", str(tmp_path / "cli.png")])
    assert torch.equal(got, want)


def test_artifact_is_plain_and_stands_alone(tmp_path, monkeypatch):
    """weights_only loading reads it; --run needs no config tree."""
    overrides, (sampler, steps) = CASES["ddpm_dpm"]
    art = tmp_path / "a.pt"
    ex.export(overrides, str(art), n=2, sampler=sampler, steps=int(steps), device="cpu")
    saved = torch.load(art, weights_only=True)
    assert saved["format"] == ex.FORMAT and saved["ema"] is None
    assert set(saved) == {"format", "config", "params", "ema", "n", "sampler", "steps", "step"}
    assert saved["config"]["model"]["_target_"] == "igm_tpu.models.ddpm.DDPM"
    import igm_tpu_torch.cli

    def no_tree():
        raise AssertionError("--run read the config tree")

    monkeypatch.setattr(igm_tpu_torch.cli, "config_dir", no_tree)
    assert ex.run(str(art), seed=0, device="cpu").shape == (2, 32, 32, 3)
    torch.save({"format": "other"}, tmp_path / "b.pt")
    with pytest.raises(ValueError, match="not a sampler artifact"):
        ex.run(str(tmp_path / "b.pt"), device="cpu")


@pytest.mark.parametrize("overrides,args,message", [
    (CASES["vae_default"][0], ["--sampler", "dpm"], "VAE has no dpm_sample"),
    (["experiment=made/mnist", "model.hidden_dim=8"], [], "MADE has no sampler here"),
], ids=["vae_dpm", "made"])
def test_a_sampler_the_model_lacks_fails_loudly(overrides, args, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        ex.main([*overrides, "--n", "2", *args, "--out", str(tmp_path / "x.pt"),
                 "--device", "cpu"])
    assert not (tmp_path / "x.pt").exists()
