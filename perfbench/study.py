"""The readings that a cell's limits are set from, on the chip at the
cell's own sizes (the benchmark's runs never call this):

    # the program's numbers over many seeds, one process (short windows)
    python3 perfbench/study.py program --workload unet.train --seconds 0.5 --seeds 1 2 ...

    # the control and the faults, read in the reference put in the
    # program's place
    python3 perfbench/study.py control --workload unet.train --seeds 1 2 3

    # the serving cell's latency at several offered rates (the knee)
    python3 perfbench/study.py sweep --workload unet.serve --seeds 1 --seconds 10 --rates 16 20 24

    # where a train cell's host time goes (one process, after set-up)
    python3 perfbench/study.py host --workload unet.train --seeds 1 --seconds 5

``control`` reads, against the float32 reference on the same inputs: the
reference computed in fp8 (e4m3 operands, e5m2 gradients, per-tensor
scales: the step below the configuration's bfloat16); for a training
cell the loss and the update taken over half the batch, and on more than
one chip over one rank's rows alone (the gradient exchange left out).  A
state left unchanged reads 1 on the gradient and the change by their
definition and needs no run.  For a serving cell the control is the
fp8 sampler on the checked requests' seeds.  One JSON line a reading.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ctx(workload: str, seed: int, seconds: float, device: str) -> dict:
    from perfbench.harness import bench
    from perfbench.harness.weights import boot_clock
    cell = bench.workload(workload)
    return {"cell": cell, "config": bench.config(cell["config"]),
            "mix": bench.traffic(cell["traffic"]), "seed": seed,
            "seconds": seconds, "trace": 0, "device": device, "started": boot_clock()}


def _values(compared: dict) -> dict:
    return {k: v["value"] for k, v in compared.items()}


def program(args) -> None:
    from perfbench.harness import bench
    for seed in args.seeds:
        ctx = _ctx(args.workload, seed, args.seconds, "cuda")
        limits = {k: float("inf") for k in ("loss_gap", "grad_gap", "update_gap",
                                            "rms_gap", "pixel_gap")}
        ctx["cell"]["limits"] = limits
        result = bench.generator(ctx["mix"]["generator"]).run(ctx)
        values = {k: v for k, v in _values(result["compared"]).items() if v != float("inf")}
        print(json.dumps({"reading": "program", "seed": seed, **values,
                          "attempted": result["attempted"], "failed": result["failed"]}),
              flush=True)


def control(args) -> None:
    import torch
    from perfbench.generators import serve, train
    for seed in args.seeds:
        ctx = _ctx(args.workload, seed, 0.0, "cuda")
        cell = ctx["cell"]
        device = torch.device("cuda")
        if ctx["mix"]["generator"] == "serve":
            params = ctx["mix"]
            for req in serve.request_seeds(int(params["checked_requests"]), seed):
                want = serve.reference_images(ctx, req, device).cpu().numpy()
                got = serve.reference_images(ctx, req, device, "fp8").cpu().numpy()
                print(json.dumps({"reading": "control", "seed": seed, "request": req,
                                  **serve.gaps(got, want)}), flush=True)
            continue
        batch = int(ctx["mix"]["batch_size"])
        limits = {k: float("inf") for k in ("loss_gap", "grad_gap", "update_gap")}
        ref = train.follow(ctx, device, batch)
        faults = {"control": dict(precision="fp8"),
                  "half_batch": dict(rows=slice(0, batch // 2))}
        if int(cell["chips"]) > 1:
            faults["no_exchange"] = dict(rows=slice(0, batch // int(cell["chips"])))
        for name, kw in faults.items():
            got = train.follow(ctx, device, batch, **kw)
            print(json.dumps({"reading": name, "seed": seed,
                              **_values(train.compare([got], ref, limits))}), flush=True)


def sweep(args) -> None:
    """The serving cell at each of ``--rates`` (one window each, this
    process): the latency quantiles, the mean latency of the first and the
    last quarter of the requests (a backlog that grows shows as the
    second far above the first) and the completed requests a second."""
    import numpy as np
    from perfbench.harness import bench
    for rate in args.rates:
        ctx = _ctx(args.workload, args.seeds[0], args.seconds, "cuda")
        ctx["mix"]["rate_per_s"] = rate
        ctx["mix"]["checked_requests"] = 1
        ctx["cell"]["limits"] = {"rms_gap": float("inf")}
        result = bench.generator("serve").run(ctx)
        due, lat = ctx["latencies"]
        done = due + lat
        q = len(lat) // 4
        print(json.dumps({"reading": "sweep", "rate": rate, "requests": len(lat),
                          "failed": result["failed"],
                          "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                          "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                          "first_quarter_ms": 1e3 * float(lat[:q].mean()),
                          "last_quarter_ms": 1e3 * float(lat[-q:].mean()),
                          "completed_per_s": len(lat) / float(done.max())}), flush=True)


def host(args) -> None:
    """Where a train cell's host time goes, one phase of ``--seconds`` each:
    the window's loop (the prefetch thread's time to stage a batch beside
    it); the first chunk replayed over and over with no fetch; each such
    call waited for (the device's time a step).  A second thread that
    sleeps 0.5 ms at a time records how late it wakes: a call that blocks
    while it holds the interpreter lock makes it wake late by as long."""
    import threading
    import time

    import numpy as np
    import torch
    from igm_tpu_torch.core.trainer import Trainer
    from igm_tpu_torch.data import loader

    from perfbench.generators import train
    from perfbench.harness import bench
    from perfbench.harness.weights import sub_seeds, train_images

    ctx = _ctx(args.workload, args.seeds[0], args.seconds, "cuda")
    device = torch.device("cuda")
    model, state, mesh, _ = train.build(ctx, device)
    sizes, params, seeds = bench.sizes(ctx["config"]), ctx["mix"], sub_seeds(ctx["seed"])
    n = int(params["train_images"])
    arrays = (train_images(n, (sizes["height"], sizes["width"], sizes["channels"]),
                           seeds["data"]), np.zeros(n, np.int32))
    batch = int(params["batch_size"])
    model.steps_per_epoch = n // batch
    trainer = Trainer(devices=1, steps_per_execution="auto", enable_checkpointing=False)
    trainer.mesh = mesh
    k = trainer._auto_steps_per_execution(model, state, arrays, batch, n // batch, 1, None)
    loop = train.Loop(model, state, arrays, batch, 1, None, k, seeds["order"], 50, None)

    staged = []
    stage = loader.DevicePrefetcher._stage

    def timed_stage(self, b):
        t = time.perf_counter()
        out = stage(self, b)
        staged.append(time.perf_counter() - t)
        return out

    loader.DevicePrefetcher._stage = timed_stage
    late, running = [], [True]

    def sleeper():
        while running[0]:
            t = time.perf_counter()
            time.sleep(0.0005)
            late.append(time.perf_counter() - t - 0.0005)

    for _ in range(20):
        loop.step()
    train.sync(device)
    chunk = loop._next_chunk()
    threading.Thread(target=sleeper, daemon=True).start()

    def phase(name, step):
        staged.clear()
        late.clear()
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            t = time.perf_counter()
            step()
            calls.append(time.perf_counter() - t)
        train.sync(device)
        wall = time.perf_counter() - t0
        print(json.dumps({"reading": "host", "phase": name, "k": k, "calls": len(calls),
                          "ms_a_step": 1e3 * wall / (len(calls) * k),
                          "call_ms": 1e3 * float(np.mean(calls)),
                          "stage_ms": 1e3 * float(np.mean(staged)) if staged else None,
                          "wake_late_ms_mean": 1e3 * float(np.mean(late)),
                          "wake_late_ms_p95": 1e3 * float(np.percentile(late, 95))}),
              flush=True)

    def same_chunk():
        loop.state, _ = model.train_step_n(loop.state, chunk)

    def waited():
        same_chunk()
        train.sync(device)

    phase("loop", loop.step)
    phase("same_chunk", same_chunk)
    phase("waited", waited)
    running[0] = False


def main(argv=None) -> None:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(prog="perfbench/study.py")
    ap.add_argument("what", choices=("program", "control", "sweep", "host"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    args = ap.parse_args(argv)
    {"program": program, "control": control, "sweep": sweep, "host": host}[args.what](args)


if __name__ == "__main__":
    main()
