"""The port's standalone FID (igm_tpu_torch/tools/eval_fid.py) on the CPU:
its JSON line has ``igm_tpu``'s keys (``tools/eval_fid.py``); the real
split's statistics are cached under the CWD by default, keyed by the port's
backend name, and a second run reads them and gives the same distance."""
import ast
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.tools import eval_fid  # noqa: E402

torch.set_num_threads(1)

TINY = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
        "model.timesteps=6"]


def _reference_keys():
    """The keys of the dict ``tools/eval_fid.py`` prints with json.dumps."""
    tree = ast.parse((REPO / "tools" / "eval_fid.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps of a dict in tools/eval_fid.py")


def test_json_line_and_the_stats_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("IGM_INCEPTION_WEIGHTS", raising=False)
    cfg = compose(REPO / "configs", [*TINY, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    model.init_params(3)
    torch.save(model.modules["denoise"].state_dict(), tmp_path / "w.pt")
    args = [*TINY, f"datamodule.data_dir={tmp_path / 'data'}", "--weights", "w.pt", "--n", "8",
            "--batch", "4", "--sampler", "ddim", "--device", "cpu"]
    first = eval_fid.main(args)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == first and set(line) == _reference_keys()
    assert first["backend"] == "random_torch" and first["real_stats"] == "computed"
    assert first["n_real"] == 8 and first["n_fake"] == 8 and first["fid"] > 0
    cached = sorted(p.name for p in (tmp_path / "logs" / "fid_stats").iterdir())
    assert cached == ["random_torch_CIFAR10DataModule_32x32x3_n8.npz"]
    second = eval_fid.main(args)
    assert second == {**first, "real_stats": "cached"}


def test_weights_are_required(tmp_path):
    with pytest.raises(SystemExit):
        eval_fid.main([*TINY, "--device", "cpu"])
