"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program; top-level names are compared
whole, so ``igm_tpu_torch`` is not taken for ``igm_tpu``."""
from __future__ import annotations

import ast
import json
import sys

import pytest

from _tiny import ROOT

REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax", "igm_tpu"}
MODULES = sorted((ROOT / "perfbench").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    refused = set(REFUSED)
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        refused.add("igm_tpu_torch")
    assert not (top_level_imports(path) & refused)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import igm_tpu_torch.cli\nfrom igm_tpu_torch import config\n")
    assert top_level_imports(src) == {"igm_tpu_torch"}
    assert not (top_level_imports(src) & REFUSED)
    src.write_text("import igm_tpu.models\n")
    assert top_level_imports(src) & REFUSED


def _rank_with_jax(device, ctx, out):
    """A rank other than the one that reports has JAX loaded."""
    import types

    import torch.distributed as dist
    if dist.get_rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    from perfbench.generators import train
    train._spawned(device, ctx, out)


def test_a_forbidden_module_on_any_rank_refuses_the_run(tmp_path, capsys):
    import torch
    from igm_tpu_torch.parallel.launch import spawn

    from _tiny import context
    from perfbench.harness import report
    torch.set_num_threads(1)
    out = tmp_path / "result.json"
    spawn(_rank_with_jax, 4, torch.device("cpu"), args=(context("moe_dit.train_dp4"),
                                                        str(out)), timeout=600)
    result = json.loads(out.read_text())
    assert result["forbidden"] == ["jax"]
    assert report.emit(result) != 0
    assert capsys.readouterr().out == ""
