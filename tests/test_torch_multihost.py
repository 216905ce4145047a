"""The data axis across hosts on the CPU: ``IGM_MULTIHOST=1`` under
``torchrun`` as two loopback nodes of two gloo ranks each (tests/
test_multihost.py's counterpart, which runs ``tools/multihost_dryrun.py``'s
two JAX processes).

One launch of ``igm_tpu_torch.tools.multihost_dryrun`` runs its five
meshes (the data axis; FSDP (2-D); tensor parallelism on the DiT; the
composed (1, 2, 2) mesh, its fsdp axis across the nodes; the pipeline of
four stages, the hop between stages 1 and 2 across them): one train step
each from ``init_state(0)`` on the seeded global batch, every rank's loss
the same bit for bit and within the tool's ``LOSS_RTOL`` of one process
on the whole batch.  Then the training CLI fits an epoch as the same
two nodes (``trainer.devices=-1``) and as ``trainer.devices=4``'s spawn
on the same overrides: the two write the same checkpoint.  Both launches
run single-threaded ranks (``OMP_NUM_THREADS=1``, torchrun's default too).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.parallel import launch  # noqa: E402
from igm_tpu_torch.tools import multihost_dryrun as dryrun  # noqa: E402

torch.set_num_threads(1)

TIMEOUT_S = 300
ENV = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
# tests/_torch_dp.py's tiny flagship: an epoch of two steps of 8 images
FIT = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
       "model.timesteps=16", "datamodule.width=8", "datamodule.height=8",
       "datamodule.batch_size=8", "trainer.max_epochs=1", "trainer.limit_train_batches=2",
       "trainer.limit_val_batches=0", "trainer.steps_per_execution=1", "logger=null",
       "callbacks=null", "print_config=False"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The dryrun's report, and the two CLI fits' run directories and
    results, launched one after another (each launch's single-threaded
    ranks take at most its own processes' share of the host)."""
    out = tmp_path_factory.mktemp("multihost")
    env = {**os.environ, **ENV}
    results = {"dryrun": subprocess.run(
        [sys.executable, "-m", "igm_tpu_torch.tools.multihost_dryrun", "--device", "cpu",
         "--nodes", "2", "--nproc-per-node", "2", "--cases", ",".join(dryrun.CASES),
         "--timeout", str(TIMEOUT_S)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT_S + 60)}
    results["spawn"] = subprocess.run(
        [sys.executable, "-m", "igm_tpu_torch.train", *FIT, "trainer.devices=4",
         f"hydra.run.dir={out / 'spawn'}", f"datamodule.data_dir={out / 'data_spawn'}",
         "--device", "cpu"],
        cwd=out, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    results["nodes"] = dryrun.run_nodes(
        ["-m", "igm_tpu_torch.train", *FIT, "trainer.devices=-1",
         f"hydra.run.dir={out / 'nodes'}", f"datamodule.data_dir={out / 'data_nodes'}",
         "--device", "cpu"], 2, 2, "cpu", TIMEOUT_S, cwd=str(out), env=ENV)
    return results, out


def _report(launches) -> dict:
    proc = launches[0]["dryrun"]
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(dryrun.CASES))
def test_two_nodes_train_step(launches, case):
    """One step on the case's mesh over both nodes' four ranks: every rank
    the same loss bit for bit, within LOSS_RTOL of one process on the
    global batch; a model or stage axis shards the state; no worker
    imported JAX."""
    report = _report(launches)
    assert report["ok"] is True and report["world"] == 4 and report["nodes"] == 2
    assert report["rank_devices"] == ["cpu"] * 4
    row = report["cases"][case]
    assert len(row["losses"]) == 4 and row["ranks_agree"]
    assert len(set(row["losses"])) == 1
    assert row["rel_err"] <= row["tol"] == dryrun.LOSS_RTOL[dryrun._network(row["mesh"])]
    spec = dryrun.CASES[case]
    sharded = spec.get("model", 1) > 1 or spec.get("stage", 1) > 1
    assert all((n > 0) == sharded for n in row["sharded_leaves"]), row["sharded_leaves"]


def test_cli_fit_across_two_nodes_writes_the_spawned_checkpoint(launches):
    """``IGM_MULTIHOST=1 torchrun --nnodes 2 --nproc-per-node 2 -m
    igm_tpu_torch.train ... trainer.devices=-1``: torchrun numbers the ranks
    node by node, the spawn's order, so each rank takes the spawn's rows;
    global rank 0 writes the checkpoint, the same as ``trainer.devices=4``'s
    bit for bit (gloo sums the same ranks in the same order)."""
    (results, out) = launches
    spawn = results["spawn"]
    assert spawn.returncode == 0, spawn.stderr[-2000:]
    assert [n["rc"] for n in results["nodes"]] == [0, 0], results["nodes"][0]["stderr"][-2000:]
    ckpts = sorted(p.name for p in (out / "nodes" / "checkpoints").iterdir())
    assert ckpts == sorted(p.name for p in (out / "spawn" / "checkpoints").iterdir()) \
        == ["step_2.pt"]
    got = torch.load(out / "nodes" / "checkpoints" / "step_2.pt", weights_only=False)
    want = torch.load(out / "spawn" / "checkpoints" / "step_2.pt", weights_only=False)
    assert got["step"] == want["step"] == 2
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for name, value in want["opt_states"].items():
        if "state" in value:
            for i, st in value["state"].items():
                for key, t in st.items():
                    assert torch.equal(got["opt_states"][name]["state"][i][key], t), (name, i)
        else:
            for key, t in value.items():
                assert torch.equal(got["opt_states"][name][key], t), (name, key)


def test_init_from_env_refuses_a_local_rank_without_a_card(monkeypatch):
    """A LOCAL_RANK at or past the visible card count raises a ValueError
    naming CUDA_VISIBLE_DEVICES before any group is joined (NCCL would fail
    later with a duplicate-GPU error)."""
    for key, value in (("RANK", "3"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"),
                       ("CUDA_VISIBLE_DEVICES", "2")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES=2"):
        launch.init_from_env(torch.device("cuda"))
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        launch.init_from_env(torch.device("cuda"))
