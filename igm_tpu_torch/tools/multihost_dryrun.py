"""Two hosts on one: the ``IGM_MULTIHOST=1`` path run by ``torchrun`` as
``--nodes`` nodes on loopback; counterpart of ``tools/multihost_dryrun.py``.

The parent starts one ``torchrun`` agent a node,

    python -m torch.distributed.run --nnodes N --node-rank i --nproc-per-node K
        --master-addr 127.0.0.1 --master-port P -m igm_tpu_torch.tools.multihost_dryrun ...

and each of the ``N * K`` workers joins the group with ``IGM_MULTIHOST=1``
through ``parallel.launch.init_from_env``, as the training CLI does under
torchrun.  For every case (a mesh of ``igm_tpu``'s flags: ``--model-axis``,
``--fsdp-axis``, ``--mesh-mode``, ``--stage-axis``; or ``--cases`` of the
named meshes, several in one launch, which pays the start-up once) each
worker builds the mesh over every rank of both nodes, the model at
``igm_tpu``'s dryrun sizes (its tiny UNet; its tiny float32 DiT for the
tensor and pipeline meshes), and runs one train step from
``init_state(0)`` on its rows of the seeded global batch (``2 * N * K``
images).  The parent meanwhile runs the same step in one process on the
whole batch.

    python -m igm_tpu_torch.tools.multihost_dryrun --device cpu      # 2 nodes x 2 gloo ranks
    python -m igm_tpu_torch.tools.multihost_dryrun --device cpu \
        --cases data,fsdp,tensor,composed,pipeline
    python -m igm_tpu_torch.tools.multihost_dryrun --model-axis 2 --mesh-mode tensor  # 4 cards

The parent prints one JSON line, ``{"ok": ..., "losses": [...], ...}``
(``losses``: each rank's loss of the first case; ``cases`` every case's),
and exits 0 iff ``ok``: every worker finished, every rank reported the same
loss bit for bit (the metrics are averaged over the batch ranks, so a
replica's ranks and the replicas agree), and that loss is within
``LOSS_RTOL`` of one process's.  On the card each node gets its own cards
through ``CUDA_VISIBLE_DEVICES`` (node i the i-th ``K`` of them): on one
host both nodes' ``LOCAL_RANK`` start at 0, and without the split two NCCL
ranks would share ``cuda:0``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# the named meshes (tests/test_multihost.py's five): make_mesh's keywords
CASES = {
    "data": dict(),
    "fsdp": dict(model=2),
    "tensor": dict(model=2, mode="tensor"),
    "composed": dict(model=2, fsdp=2, mode="tensor"),
    "pipeline": dict(stage=4, mode="pipeline"),
}
# the loss against one process on the global batch, relative: chip_smoke.py's
# PARALLEL_TOL metric tolerances of the flagship UNet ("flagship", bfloat16
# on the card) and the float32 DiT ("tensor_dit", "pipeline_dit")
LOSS_RTOL = {"unet": 5e-4, "dit": 1e-6}
PIPE_MICROBATCHES = 2
DATAMODULE = {"width": 16, "height": 16, "channels": 3,
              "transforms": {"convert": True, "normalize": True}}


def _network(spec: dict) -> str:
    """igm_tpu's dryrun model of a mesh: the DiT where the mesh needs a
    transformer (tensor parallelism, the pipeline), else the UNet."""
    return "dit" if spec.get("mode") in ("tensor", "pipeline") else "unet"


def build_model(spec: dict, device):
    """The model of a case at igm_tpu's dryrun sizes (its ``_make_ddpm``
    UNet; its tiny DiT-DDPM, ``depth`` the stages on the pipeline)."""
    from igm_tpu_torch.models.ddpm import DDPM
    if _network(spec) == "unet":
        model = DDPM(datamodule=DATAMODULE, hidden_dim=8, timesteps=4, dim_mults=[1, 2, 4],
                     loss_type="l1", device=device)
    else:
        model = DDPM(datamodule=DATAMODULE, hidden_dim=32, timesteps=4, network="dit",
                     depth=spec.get("stage", 2), heads=2, patch=4, loss_type="l2",
                     compute_dtype="float32", device=device)
    model.steps_per_epoch = 100
    return model


def global_batch(world: int) -> tuple:
    """The seeded global batch: ``2 * world`` uint8 images, zero labels."""
    rng = np.random.default_rng(0)
    n = 2 * world
    shape = (n, DATAMODULE["height"], DATAMODULE["width"], DATAMODULE["channels"])
    return rng.integers(0, 256, shape, np.uint8), np.zeros((n,), np.int32)


def step_loss(model, batch, mesh=None) -> float:
    """One train step from ``init_state(0)``: the loss, on ``mesh`` from
    this rank's rows (None: one process on the whole batch)."""
    import torch
    from igm_tpu_torch.parallel.mesh import shard_batch
    model.set_mesh(mesh)
    state = model.init_state(0)
    if mesh is None:
        local = tuple(torch.from_numpy(a).to(model.device) for a in batch)
    else:
        local = shard_batch(mesh, batch)
    _, metrics = model.train_step_n(state, tuple(b[None] for b in local), graph=False)
    return float(metrics["train_loss/loss"])


# ----------------------------------------------------------------- worker
def worker(args) -> None:
    """One rank: join torchrun's group, run every case, write the losses."""
    import torch
    from igm_tpu_torch.parallel.launch import init_from_env, leave_group
    from igm_tpu_torch.parallel.mesh import make_mesh
    from igm_tpu_torch.utils.platform import resolve_device, set_numerics
    set_numerics()
    device = init_from_env(resolve_device(args.device))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    losses, sharded = {}, {}
    for name, spec in json.loads(args.specs).items():
        mesh = make_mesh(devices=device, **spec)
        model = build_model(spec, device)
        if mesh.mode == "pipeline":
            model.enable_pipeline(mesh, PIPE_MICROBATCHES)
        losses[name] = step_loss(model, global_batch(world), mesh)
        leaves = model.sharding.leaves if model.sharding is not None else []
        sharded[name] = sum(leaf.sharded for leaf in leaves)
    record = {"device": str(device), "losses": losses, "sharded_leaves": sharded,
              "jax": "jax" in sys.modules}
    Path(args.out, f"rank{rank}.json").write_text(json.dumps(record))
    leave_group()


# ----------------------------------------------------------------- parent
def node_envs(nodes: int, nproc_per_node: int, device: str) -> List[Dict[str, str]]:
    """Each node's environment: ``IGM_MULTIHOST=1``; on the card its own
    ``nproc_per_node`` cards (node i the i-th of them, of those this
    process sees)."""
    envs = []
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    for i in range(nodes):
        env = {**os.environ, "IGM_MULTIHOST": "1"}
        if device != "cpu":
            if visible:
                cards = [c.strip() for c in visible.split(",") if c.strip()]
            else:
                import torch
                cards = [str(c) for c in range(torch.cuda.device_count())]
            mine = cards[i * nproc_per_node:(i + 1) * nproc_per_node]
            if len(mine) < nproc_per_node:
                raise SystemExit(f"{nodes} nodes of {nproc_per_node} cards need "
                                 f"{nodes * nproc_per_node}; this host shows {len(cards)}")
            env["CUDA_VISIBLE_DEVICES"] = ",".join(mine)
        envs.append(env)
    return envs


def run_nodes(target: Sequence[str], nodes: int, nproc_per_node: int, device: str,
              timeout: float, cwd: Optional[str] = None,
              env: Optional[Dict[str, str]] = None) -> List[dict]:
    """``torchrun ... <target>`` (``-m module args``) as ``nodes`` agents on
    loopback, each in its own session; returns each node's ``rc``,
    ``stdout`` and ``stderr``.  Past ``timeout`` seconds every agent and
    worker is killed (the rc is then None)."""
    from igm_tpu_torch.parallel.launch import free_port
    port = free_port()
    procs = []
    for i, node_env in enumerate(node_envs(nodes, nproc_per_node, device)):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nodes),
               "--node-rank", str(i), "--nproc-per-node", str(nproc_per_node),
               "--master-addr", "127.0.0.1", "--master-port", str(port), *target]
        procs.append(subprocess.Popen(cmd, cwd=cwd, env={**node_env, **(env or {})},
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, start_new_session=True))
    deadline = time.monotonic() + timeout
    out = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            rc = p.returncode
        except subprocess.TimeoutExpired:
            for q in procs:
                try:
                    os.killpg(q.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            stdout, stderr = p.communicate()
            rc = None
        out.append({"rc": rc, "stdout": stdout, "stderr": stderr})
    return out


def cases_of(args) -> Dict[str, dict]:
    """The cases to run: ``--cases`` by name, else the one mesh of the
    flags."""
    if args.cases:
        names = [c.strip() for c in args.cases.split(",") if c.strip()]
        unknown = [n for n in names if n not in CASES]
        if unknown:
            raise SystemExit(f"--cases: unknown {unknown}; known {sorted(CASES)}")
        return {n: CASES[n] for n in names}
    spec = {}
    if args.stage_axis > 1:
        spec = dict(stage=args.stage_axis, mode="pipeline")
    else:
        if args.model_axis > 1:
            spec["model"] = args.model_axis
        if args.fsdp_axis > 1:
            spec["fsdp"] = args.fsdp_axis
        if args.mesh_mode != "fsdp":
            spec["mode"] = args.mesh_mode
    return {"mesh": spec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.multihost_dryrun")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--nproc-per-node", type=int, default=2)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--fsdp-axis", type=int, default=1)
    ap.add_argument("--mesh-mode", default="fsdp", choices=["fsdp", "tensor"])
    ap.add_argument("--stage-axis", type=int, default=1)
    ap.add_argument("--cases", default=None,
                    help=f"comma-separated meshes run in one launch, of {sorted(CASES)}")
    ap.add_argument("--device", default=None, help="cpu (gloo), or the cards (NCCL)")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--specs", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0

    import torch
    from igm_tpu_torch.utils.platform import resolve_device, set_numerics
    device = resolve_device(args.device)
    set_numerics()
    cases = cases_of(args)
    world = args.nodes * args.nproc_per_node
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="multihost-") as out:
        target = ["-m", "igm_tpu_torch.tools.multihost_dryrun", "--worker",
                  "--specs", json.dumps(cases), "--out", out,
                  "--device", "cpu" if device.type == "cpu" else "cuda"]
        repo = str(Path(__file__).resolve().parents[2])
        pythonpath = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
        launched: list = []
        launcher = threading.Thread(target=lambda: launched.extend(run_nodes(
            target, args.nodes, args.nproc_per_node, device.type, args.timeout,
            env={"PYTHONPATH": pythonpath})))
        launcher.start()
        one = {}               # one process on the whole batch, meanwhile
        for name, spec in cases.items():
            one[name] = step_loss(build_model(spec, device), global_batch(world))
        launcher.join()
        records = []
        for r in range(world):
            path = Path(out, f"rank{r}.json")
            if path.exists():
                records.append(json.loads(path.read_text()))
    errors = [f"node {i} rc={n['rc']}: {n['stderr'].strip()[-800:]}"
              for i, n in enumerate(launched) if n["rc"] != 0]
    if len(records) != world and not errors:
        errors.append(f"{len(records)} of {world} ranks reported")
    report, ok = {}, not errors and len(records) == world
    for name, spec in cases.items():
        losses = [rec["losses"].get(name) for rec in records]
        tol = LOSS_RTOL[_network(spec)]
        same = bool(losses) and all(v == losses[0] for v in losses)
        finite = same and losses[0] is not None and bool(np.isfinite(losses[0]))
        err = abs(losses[0] - one[name]) / max(abs(one[name]), 1e-12) if finite else None
        report[name] = {"mesh": spec, "losses": losses, "one_process": one[name],
                        "rel_err": err, "tol": tol, "ranks_agree": same,
                        "sharded_leaves": [rec["sharded_leaves"].get(name) for rec in records]}
        ok = ok and finite and err <= tol
    ok = ok and not any(rec["jax"] for rec in records)
    first = next(iter(cases))
    print(json.dumps({"ok": ok, "losses": report[first]["losses"], "cases": report,
                      "errors": errors, "nodes": args.nodes,
                      "nproc_per_node": args.nproc_per_node, "world": world,
                      "device": device.type,
                      "rank_devices": [rec["device"] for rec in records],
                      "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
