"""The port's sweeps (igm_tpu_torch/sweep, the multirun half of
igm_tpu_torch/cli.py) on the CPU.  Against ``igm_tpu.sweep`` and
``igm_tpu/cli.py``, exactly: the override grammar over a table of tokens,
the grid's job order, 30 TPE proposals at one seed with a failed trial, and
a study resumed from a journal.  Then multiruns through ``train_main -m``:
a grid inline (the basic launcher), worker processes (joblib, as
``python -m igm_tpu_torch.train``), a TPE sweep resumed from its
``trials.jsonl``, and a failing job that fails the multirun.  And
``logger=wandb`` without wandb: a loud no-op, as in ``igm_tpu``."""
import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import igm_tpu.cli as ref_cli  # noqa: E402
import igm_tpu.sweep as ref  # noqa: E402
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch import sweep  # noqa: E402

torch.set_num_threads(1)

TOKENS = [
    "model.lr=interval(1e-4,1e-1)", "model.lr=tag(log, interval(1e-4,1e-1))",
    "model.hidden=range(32,256,32)", "model.act=choice(relu,tanh)", "model.lr=1e-3,5e-4",
    "model.lr=1e-3", "experiment=vae/mnist_mlp", "model.dim_mults=[1,2,4]", "+extra.k=v",
    "~dead.key", "+model.extra=1,2", "model.ema=range(0.9,0.95,0.01)", "model.flag=true,False",
    "model.x=choice(1, 2.5, abc)", "model.n=range(1,5)", "model.n=tag(log, range(1,100,10))",
    "model.s=range(0.5,2)", "bare_token", "model.d={a: 1}"]


@pytest.mark.parametrize("token", TOKENS)
def test_parse_override_equals_igm_tpus(token):
    key, dist = sweep.parse_override(token)
    ref_key, ref_dist = ref.parse_override(token)
    assert key == ref_key and (dist is None) == (ref_dist is None)
    if dist is not None:
        assert dataclasses.asdict(dist) == dataclasses.asdict(ref_dist)
        try:
            want = ref_dist.grid()
        except ValueError:
            with pytest.raises(ValueError, match="no finite grid"):
                dist.grid()
        else:
            assert dist.grid() == want
            assert ([sweep.format_value(v) for v in dist.grid()]
                    == [ref.format_value(v) for v in want])


@pytest.mark.parametrize("token", ["model.lr=interval(1)", "model.n=range(1)",
                                   "model.x=tag(log, 3)"])
def test_malformed_sweeps_raise_as_igm_tpus(token):
    with pytest.raises(ValueError) as got:
        sweep.parse_override(token)
    with pytest.raises(ValueError) as want:
        ref.parse_override(token)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("node", [
    {"type": "float", "low": 1e-4, "high": 1e-1, "log": True},
    {"type": "int", "low": 8, "high": 64, "step": 8},
    {"type": "categorical", "choices": [1, "a", 2.5]}])
def test_dist_from_config_equals_igm_tpus(node):
    assert (dataclasses.asdict(sweep.dist_from_config(node))
            == dataclasses.asdict(ref.dist_from_config(node)))


def test_grid_job_order_equals_igm_tpus(monkeypatch):
    overrides = ["experiment=vae/mnist_mlp", "model.lr=1e-3,5e-4", "+model.extra=range(1,4)",
                 "trainer.max_epochs=1", "model.act=choice(relu,tanh)"]
    fixed, swept = cli._partition_sweep(overrides)
    ref_fixed, ref_swept = ref_cli._partition_sweep(overrides)
    assert fixed == ref_fixed
    got, want = [], []
    cli._grid_sweep(fixed, swept,
                    lambda jobs: got.extend(jobs) or [sweep.JobResult(True)] * len(jobs))
    monkeypatch.setattr(ref_cli, "_launch", lambda jobs, *_: want.extend(jobs)
                        or [ref.JobResult(True)] * len(jobs))
    ref_cli._grid_sweep(ref_fixed, ref_swept, None, None)
    assert len(got) == 12
    assert [(j.overrides, j.subdir) for j in got] == [(j.overrides, j.subdir) for j in want]


def _space(pkg, categorical: bool):
    space = {"lr": pkg.Dist(kind="float", low=1e-5, high=1e-1, log=True)}
    if categorical:
        space["act"] = pkg.Dist(kind="categorical", choices=["relu", "tanh", "gelu"])
    else:
        space["hidden"] = pkg.Dist(kind="int", low=32, high=255, step=32)
    return space


def _objective(params):
    value = (np.log10(params["lr"]) + 2.0) ** 2
    if "hidden" in params:
        return value + ((params["hidden"] - 96) / 64.0) ** 2
    return value + (0.0 if params["act"] == "tanh" else 0.5)


def _proposals(pkg, categorical: bool, direction: str, n: int = 30, seed: int = 3):
    study = pkg.Study(_space(pkg, categorical), direction=direction, seed=seed,
                      n_startup_trials=5)
    out = []
    for i in range(n):
        t = study.ask()
        value = None if i == 7 else _objective(t.params)      # trial 7 fails
        study.tell(t, value if direction == "minimize" or value is None else -value)
        out.append((t.number, t.params, t.state, t.value))
    return out, study


@pytest.mark.parametrize("categorical,direction", [(False, "minimize"), (True, "maximize")],
                         ids=["float_int", "float_categorical"])
def test_tpe_proposals_equal_igm_tpus(categorical, direction):
    got, study = _proposals(sweep, categorical, direction)
    want, ref_study = _proposals(ref, categorical, direction)
    assert got == want
    assert got[7][2] == "failed"
    assert study.best_trial.number == ref_study.best_trial.number


def test_a_resumed_study_proposes_what_igm_tpus_does():
    """Five finished trials replayed from a journal (add_observation): the
    next proposals (past the failed trial 7) equal the uninterrupted
    study's and igm_tpu's resumed one's."""
    full, _ = _proposals(sweep, False, "minimize", n=12, seed=7)
    studies = [pkg.Study(_space(pkg, False), seed=7, n_startup_trials=5) for pkg in (sweep, ref)]
    for study in studies:
        for _, params, _, value in full[:5]:
            study.add_observation(params, value)
    for number, params, _, value in full[5:]:
        trials = [study.ask() for study in studies]
        assert [t.number for t in trials] == [number, number]
        assert trials[0].params == trials[1].params == params
        for study, t in zip(studies, trials):
            study.tell(t, value)


def test_tell_coerces_tensors_and_arrays():
    study = sweep.Study(_space(sweep, False), seed=0)
    t = study.ask()
    study.tell(t, torch.tensor(float("nan")))
    assert t.state == "failed"
    t = study.ask()
    study.tell(t, np.float32(1.5))
    assert t.state == "complete" and t.value == 1.5


FAST = ["experiment=vae/mnist_mlp", "networks.encoder.hidden_dims=[16]",
        "networks.decoder.hidden_dims=[16]", "trainer.max_epochs=1",
        "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
        "datamodule.batch_size=16", "trainer.enable_checkpointing=False",
        "trainer.steps_per_execution=1", "print_config=False", "logger=null",
        "--device", "cpu"]
METRIC = "+optimized_metric=val_log/log_p_x_of_z"


def _metric(run_dir: Path) -> float:
    return json.loads((run_dir / "optimized_metric.json").read_text())["optimized_metric"]


def test_grid_multirun_inline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.train_main(["-m", "hydra/launcher=basic", "model.lr=1e-3,5e-4", METRIC, *FAST,
                    "hydra.sweep.dir=sweep"])
    values = [_metric(tmp_path / "sweep" / str(i)) for i in range(2)]
    assert all(np.isfinite(values)) and values[0] != values[1]
    assert (tmp_path / "sweep" / "0" / "results").is_dir()
    assert not (tmp_path / "sweep" / "2").exists()


def test_joblib_workers_through_the_train_module(tmp_path):
    """Two jobs as ``python -m igm_tpu_torch.train`` workers, two at a time,
    from a directory outside the repo."""
    out = subprocess.run(
        [sys.executable, "-m", "igm_tpu_torch.train", "-m", "hydra.launcher.n_jobs=2",
         "model.lr=1e-3,5e-4", METRIC, *FAST, f"hydra.sweep.dir={tmp_path / 'sweep'}"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "--- multirun job 1:" in out.stdout
    values = [_metric(tmp_path / "sweep" / str(i)) for i in range(2)]
    assert all(np.isfinite(values))


def test_a_failing_job_fails_the_multirun(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.train_main(["-m", "model.nonexistent_knob=boom", *FAST, "hydra.sweep.dir=sweep"])
    assert exc.value.code not in (None, 0)
    assert "multirun: 1/1 jobs failed (subdirs 0)" in str(exc.value.code)


def test_optuna_sweep_resumes_from_its_journal(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["-m", "hydra/sweeper=optuna", "hydra/launcher=basic", "hydra.sweeper.seed=0",
            "hydra.sweeper.direction=maximize", METRIC,
            "model.lr=tag(log, interval(1e-4,1e-2))", *FAST, "hydra.sweep.dir=sweep"]
    cli.train_main([*args, "hydra.sweeper.n_trials=2"])
    journal = tmp_path / "sweep" / "trials.jsonl"
    first = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["number"] for r in first] == [0, 1]
    capsys.readouterr()
    cli.train_main([*args, "hydra.sweeper.n_trials=3"])
    out = capsys.readouterr().out
    assert "optuna resume: replayed 2 finished trials" in out
    assert "optuna trial 2:" in out and "optuna trial 1:" not in out
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    assert records[:2] == first and records[2]["number"] == 2
    # igm_tpu's study, fed the same journal, proposes the same third trial
    study = ref.Study({"model.lr": ref.parse_override(args[6])[1]}, direction="maximize",
                      seed=0, n_startup_trials=10)
    for r in first:
        study.add_observation(r["params"], r["value"])
    assert study.ask().params == records[2]["params"]
    best = yaml.safe_load((tmp_path / "sweep" / "optimization_results.yaml").read_text())
    assert best["name"] == "optuna"
    assert best["best_value"] == max(r["value"] for r in records)
    assert all((tmp_path / "sweep" / str(i) / "optimized_metric.json").is_file()
               for i in range(3))


def test_wandb_logger_without_wandb_warns_and_trains(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    fast = [a for a in FAST if a != "logger=null"]
    with caplog.at_level(logging.WARNING, logger="igm_tpu_torch.core.logging"):
        value = cli.train_main(["logger=wandb", "optimized_metric=train_log/elbo", *fast])
    assert np.isfinite(value)
    assert any("logger=wandb configured but wandb is not installed" in r.getMessage()
               for r in caplog.records)
    from igm_tpu_torch.core.logging import WandbLogger
    logger = WandbLogger()
    logger.log_scalars({"a": 1.0}, 0)
    logger.log_image("b", np.zeros((2, 2, 3)), 0)
    logger.finalize()
