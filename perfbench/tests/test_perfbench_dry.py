"""A dry run of each cell on the CPU at a tiny size, with the program's
plain kernel versions: the whole run (set-up, the checked steps, the
window, the reference) prints the contract's last line, and ``correct``
holds.  Also a new cell and a new per-layer metric, added as files in a
copy of the benchmark, are picked up without an edit of any file there."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from _tiny import ROOT, bench, context, run
from perfbench.harness import report

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def last_line(result: dict, capsys) -> dict:
    assert report.emit(result) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(out)
    assert list(line)[:len(KEYS)] == list(KEYS) and list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    return line


@pytest.mark.parametrize("name,trace", [("unet.train", 0), ("unet.train", 1),
                                        ("moe_dit.train", 1), ("unet.serve", 0), ("unet.serve", 1),
                                        ("moe_dit.train_dp4", 0)])
def test_dry_run_prints_the_last_line(name, trace, capsys):
    torch.set_num_threads(1)
    line = last_line(run(context(name, trace=trace)), capsys)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"      # no device number from a CPU run
    bmk = bench.benchmark()
    if trace == 0:
        want = {m["name"] for m in bench.end_to_end(bmk, name)}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        allowed = {m["name"] for m in bench.per_layer(bmk, name)}
        assert set(line["metrics"]) <= allowed


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    cell = json.loads((copy / "perfbench/workloads/unet.train.json").read_text())
    cell.update(name="unet.train_b256", why="the flagship at batch 256", traffic="train_b256")
    (copy / "perfbench/workloads/unet.train_b256.json").write_text(json.dumps(cell))
    mix = json.loads((copy / "perfbench/traffic/train_b128.json").read_text())
    mix.update(batch_size=256, why="a global batch of 256")
    (copy / "perfbench/traffic/train_b256.json").write_text(json.dumps(mix))
    (copy / "perfbench/metrics/trainer.steps.py").write_text(textwrap.dedent('''
        def read(r):
            return r["attempted"]
    '''))
    bmk = json.loads((copy / "BENCHMARK.json").read_text())
    bmk["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
    bmk["end_to_end"][0]["workloads"].append("unet.train_b256")
    bmk["per_layer"].append({"name": "trainer.steps", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "trainer",
                             "moves": "train_images_per_s",
                             "workloads": ["unet.train_b256"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bmk))
    for p, data in before.items():
        assert p.read_bytes() == data
    probe = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(copy)!r})
        from perfbench.harness import bench
        b = bench.benchmark()
        cell = bench.workload("unet.train_b256")
        mix = bench.traffic(cell["traffic"])
        assert mix["batch_size"] == 256
        names = [m["name"] for m in bench.per_layer(b, "unet.train_b256")]
        assert names == ["trainer.steps"], names
        assert bench.metric_reader("trainer.steps").read({{"attempted": 7}}) == 7
        assert "train_images_per_s" in [m["name"] for m in bench.end_to_end(b, "unet.train_b256")]
        assert bench.generator(mix["generator"]).__file__.startswith({str(copy)!r})
        print("ok")
    ''')
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, timeout=120, cwd=copy)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_without_a_card_the_run_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
                          "unet.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""


def test_only_the_benchmark_files_fail(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths`` the run exits with an error and prints no result."""
    copy = tmp_path / "bare"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "unet.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=copy,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
