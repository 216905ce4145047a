"""The likelihood models through the port's CLIs on the CPU, at a tiny size:
made/mnist, pixelcnn/mnist, pixelcnn/cifar10, realnvp/mnist and
realnvp/cifar10 train with validation (the sample grid), checkpoint and
resume (python -m igm_tpu_torch.train); RealNVP samples through
python -m igm_tpu_torch.cli, from a checkpoint and from --weights (a torch
state_dict and an igm_tpu .npz of the flow); MADE and PixelCNN, which have
no sampler there, exit with a message."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.cli import sample_main, train_main  # noqa: E402

torch.set_num_threads(1)

TINY = {
    "made/mnist": ["model.hidden_dim=16", "model.n_layer=2"],
    "pixelcnn/mnist": ["model.hidden_dim=4"],
    "pixelcnn/cifar10": ["model.hidden_dim=4"],
    "realnvp/mnist": ["model.hidden_dim=8", "model.n_couplings=[1,1,1]",
                      "+model.sample_batch=4"],
    "realnvp/cifar10": ["model.hidden_dim=8", "model.n_couplings=[1,1,1]",
                        "+model.sample_batch=4"],
}
SIZE = ["datamodule.width=8", "datamodule.height=8"]


def _grid(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


@pytest.mark.parametrize("experiment", list(TINY))
def test_train_validate_checkpoint_resume(experiment, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = [f"experiment={experiment}", *SIZE, *TINY[experiment],
              "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.check_val_every_n_epoch=1", "datamodule.batch_size=4", "logger=null",
              "print_config=False", "optimized_metric=val_bpd",
              f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"]
    run = tmp_path / "logs" / "runs" / experiment
    for epochs, ckpts, grids in ((1, ["step_2.pt"], ["0.jpg"]),
                                 (2, ["step_2.pt", "step_4.pt"], ["0.jpg", "1.jpg"])):
        bpd = train_main([*common, f"trainer.max_epochs={epochs}",
                          f"trainer.resume={run / 'checkpoints'}"])
        assert np.isfinite(bpd) and bpd > 0
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ckpts
        assert sorted(p.name for p in (run / "results").iterdir()) == grids
    if experiment.startswith("realnvp"):
        out = tmp_path / "grid.png"
        imgs = sample_main([f"experiment={experiment}", *SIZE, *TINY[experiment], "--ckpt",
                            str(run / "checkpoints"), "--n", "4", "--device", "cpu",
                            "--out", str(out)])
        assert imgs.shape[:3] == (4, 8, 8) and imgs.abs().max() <= 1.0
        assert _grid(out).shape == (2 + 10, 2 + 4 * 10, 3)
    else:
        with pytest.raises(SystemExit, match="sample grids come from validation"):
            sample_main([f"experiment={experiment}", *SIZE, *TINY[experiment], "--n", "2",
                         "--device", "cpu", "--out", str(tmp_path / "none.png")])


def test_realnvp_weights_load_into_the_flow(tmp_path):
    """--weights takes RealNVP's flow: an .npz of igm_tpu's flow leaves
    samples exactly as the same weights converted and saved by torch."""
    import jax

    from igm_tpu.config import compose as jax_compose
    from igm_tpu.config import instantiate as jax_instantiate
    from igm_tpu_torch.interop import flax_to_torch

    args = ["experiment=realnvp/cifar10", *SIZE, *TINY["realnvp/cifar10"]]
    cfg = jax_compose(REPO / "configs", args)
    jm = jax_instantiate(cfg.model, datamodule=cfg.datamodule)
    jm.steps_per_epoch = 1
    params = jax.jit(jm.init_state)(jax.random.PRNGKey(3)).params["flow"]
    flat = {"/".join(k.key for k in path): np.asarray(v) + 0.05
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    torch.save(flax_to_torch(flat), tmp_path / "w.pt")
    for ext in ("npz", "pt"):
        sample_main([*args, "--n", "3", "--device", "cpu", "--weights",
                     str(tmp_path / f"w.{ext}"), "--out", str(tmp_path / f"{ext}.png")])
    sample_main([*args, "--n", "3", "--device", "cpu", "--out", str(tmp_path / "r.png")])
    a, b, c = (_grid(tmp_path / f"{s}.png") for s in ("npz", "pt", "r"))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
