"""Multirun job launchers, sequential (basic) and parallel (joblib-style):
the port's counterpart of ``igm_tpu/sweep/launcher.py``.

``configs/config.yaml`` selects the joblib launcher for every multirun,
which runs each job as a worker process of its own:
``python -m igm_tpu_torch.train <job overrides> hydra.run.dir=<sweep>/<job>``
(the caller's argv prefix, which carries its ``--device``), at most
``n_jobs`` at a time.  The parent reads each job's ``optimized_metric`` from
the result file the job writes into its run directory.  ``n_jobs: null``
is one worker (joblib's own default), ``n_jobs <= 0`` one per CPU core.

The basic launcher runs the jobs one after another in the caller's process
(``run_inline``), or as workers when no runner is given.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

RESULT_FILE = "optimized_metric.json"
# the directory that holds the igm_tpu_torch package: a worker imports it
# from there whatever directory the parent runs in
_PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent.parent)


@dataclass
class Job:
    overrides: List[str]
    subdir: str


def read_result(run_dir: Path) -> Optional[float]:
    path = Path(run_dir) / RESULT_FILE
    if not path.exists():
        return None
    try:
        return float(json.loads(path.read_text())["optimized_metric"])
    except (ValueError, KeyError, json.JSONDecodeError):
        return None


def write_result(run_dir: Path, value) -> None:
    try:
        value = float(value)
    except (TypeError, ValueError):
        return
    (Path(run_dir) / RESULT_FILE).write_text(json.dumps({"optimized_metric": value}))


@dataclass
class JobResult:
    ok: bool                       # the job's process or call succeeded
    value: Optional[float] = None  # its optimized_metric, if the run gave one


def _run_subprocess(worker_argv: Sequence[str], job: Job, sweep_dir: Path) -> JobResult:
    run_dir = Path(sweep_dir) / job.subdir
    cmd = [*worker_argv, *job.overrides, f"hydra.run.dir={run_dir}"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        sys.stderr.write(f"[launcher] job {job.subdir} failed "
                         f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}\n")
        return JobResult(ok=False)
    return JobResult(ok=True, value=read_result(run_dir))


def launch(jobs: List[Job], launcher_cfg, sweep_dir: Path, worker_argv: Sequence[str],
           run_inline: Optional[Callable[[Job], Optional[float]]] = None,
           ) -> List[JobResult]:
    """Run ``jobs``; each JobResult carries success and the optimized_metric."""
    kind = str(launcher_cfg.get("_target_", "basic")) if launcher_cfg else "basic"
    if kind == "joblib":
        n_jobs_cfg = launcher_cfg.get("n_jobs")
        if n_jobs_cfg in (None, "null"):
            n_jobs = 1
        else:
            n_jobs = int(n_jobs_cfg)
            if n_jobs <= 0:
                n_jobs = os.cpu_count() or 1
        n_jobs = max(1, min(n_jobs, len(jobs)))
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            futures = [pool.submit(_run_subprocess, worker_argv, j, sweep_dir) for j in jobs]
            return [f.result() for f in futures]
    results: List[JobResult] = []
    for job in jobs:
        if run_inline is not None:
            results.append(JobResult(ok=True, value=run_inline(job)))
        else:
            results.append(_run_subprocess(worker_argv, job, sweep_dir))
    return results
