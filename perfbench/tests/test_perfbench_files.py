"""Every file of the benchmark parses and is found by name, and
``BENCHMARK.json`` keeps to its contract's shape."""
from __future__ import annotations

import json
import math
import re

import pytest

from _tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BMK = bench.benchmark()


def test_benchmark_shape():
    assert set(BMK) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert BMK["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BMK["run_seconds"] <= 51
    names = [m["name"] for m in BMK["end_to_end"] + BMK["per_layer"]]
    names += [c["name"] for c in BMK["configs"] + BMK["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BMK["end_to_end"])
    for m in BMK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["name"] for m in BMK["end_to_end"]}
    for m in BMK["per_layer"]:
        assert m["moves"] in layers
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    pairs = [(w["config"], w["traffic"]) for w in BMK["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BMK["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(entry):
    cell = bench.workload(entry["name"])
    for key in ("name", "config", "traffic", "chips", "why"):
        assert cell[key] == entry[key], key
    assert len(entry["why"]) <= 200
    mix = bench.traffic(cell["traffic"])
    assert bench.generator(mix["generator"]).run and len(mix["why"]) <= 200
    assert cell["limits"]
    reported = bench.end_to_end(BMK, cell["name"])
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert bench.per_layer(BMK, cell["name"])


@pytest.mark.parametrize("entry", BMK["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("experiment", "dtype", "model", "data", "assumed"):
        assert key in cfg
    shapes = bench.reference(cfg["name"]).param_shapes(bench.sizes(cfg))
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"]
    assert bench.flops(cfg["name"]).forward_flops(bench.sizes(cfg)) > 0


@pytest.mark.parametrize("entry", BMK["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(entry):
    reader = bench.metric_reader(entry["name"])
    assert callable(reader.read)
