"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, ``perfbench/workloads/<cell>.json``, ``perfbench/configs/<config>.json``,
``perfbench/traffic/<mix>.json`` (a traffic mix's parameters, read by the
general generator it names, ``perfbench/generators/<generator>.py``),
``perfbench/metrics/<metric>.py``, ``perfbench/flops/<config>.py`` and
``perfbench/reference/<config>.py``.

A new cell, configuration, traffic mix or per-layer metric is a new file
and a ``BENCHMARK.json`` entry: nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
HOME = ROOT / "perfbench"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return json.loads((HOME / "workloads" / f"{name}.json").read_text())


def config(name: str) -> dict:
    return json.loads((HOME / "configs" / f"{name}.json").read_text())


def _module_at(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem}".replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(mix: str) -> dict:
    return json.loads((HOME / "traffic" / f"{mix}.json").read_text())


def generator(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.generators.{name}")


def reference(config_name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{config_name}")


def flops(config_name: str) -> ModuleType:
    return _module_at(HOME / "flops" / f"{config_name}.py")


def metric_reader(name: str) -> ModuleType:
    return _module_at(HOME / "metrics" / f"{name}.py")


def sizes(cfg: dict) -> dict:
    """A configuration's model and data sizes in one mapping."""
    return {**cfg["data"], **cfg["model"]}


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those that list it, and those
    that list no cells."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics read in a cell's traced run: those that list
    it, and those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def units(metrics: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics}
