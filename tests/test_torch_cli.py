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
