"""igm_tpu_torch stands alone: it imports nothing of JAX or igm_tpu, composes
the shared config tree into port objects, and refuses to fall back to the
CPU unasked."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch import resolve_device  # noqa: E402
from igm_tpu_torch.config import resolve_target  # noqa: E402

torch.set_num_threads(1)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "igm_tpu")


def _port_files():
    return sorted((REPO / "igm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_igm_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_compose_and_instantiate_without_jax_in_a_fresh_process():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(1)
        from igm_tpu_torch.config import compose, instantiate
        from igm_tpu_torch.models.ddpm import DDPM
        import igm_tpu_torch.train, igm_tpu_torch.core.trainer  # noqa: F401
        import igm_tpu_torch.tools.profile_training  # noqa: F401
        cfg = compose({str(REPO / "configs")!r}, ["experiment=ddpm/cifar10"])
        model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
        assert type(model) is DDPM, type(model)
        assert model.hparams.dim_mults == [1, 2, 4]
        assert model.hparams.hidden_dim == 64 and model.timesteps == 1000
        bad = [m for m in sys.modules
               if m.split(".")[0] in {FORBIDDEN!r}]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_targets_resolve_to_the_port():
    from igm_tpu_torch.models.ddpm import DDPM
    assert resolve_target("igm_tpu.models.ddpm.DDPM") is DDPM
    assert resolve_target("src.models.ddpm.DDPM") is DDPM


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from igm_tpu_torch.models.ddpm import DDPM
    dm = {"width": 8, "height": 8, "channels": 3, "transforms": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DDPM(datamodule=dm, hidden_dim=8, dim_mults=(1,), timesteps=4)
    from igm_tpu_torch.cli import sample_main, train_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_main(["experiment=ddpm/cifar10", "--n", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["experiment=ddpm/cifar10"])
