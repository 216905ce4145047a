"""Serving traffic: independent users drawing image batches from the
port's sampler service over loopback HTTP, an open loop.

The service runs in a process of its own, the only one on the card while
it lives (``python -m perfbench.generators.serve --server``): it makes the
benchmark's weights on the card, exports the configuration's sampler with
them (``tools/export.py`` ``export``: the mix's sampler, steps and batch;
the artifact under ``TMPDIR``), serves it (``tools/serve.py`` ``serve``:
the artifact loaded on the card, one warm-up request that captures the
network's graphs) on an ephemeral port and says so on its standard
output.  On commands on its standard input it starts and stops a
profiler, and reports its ``/stats``, its peak memory and the modules it
loaded before it exits.

This process is the client.  One request through HTTP warms the client's
path; then the window sends ``POST /sample`` requests, each with its own
seed, at arrival times drawn from ``--seed``: a Poisson process at the
mix's rate, given its count over the window (the same for every seed),
the rate above what the service sustains, so its backlog grows all
through the window.  A request is timed from when it was due to
when its npy response is read and parsed.  The end-to-end number is the
images of the requests answered within the window over the window's
length; the latency's quantiles over every request due in the window are
read in a traced run.  One that errors or has not completed within
``grace_s`` after the window counts as failed, and as infinitely slow in
the quantiles.  A traced run then profiles the service for
``trace_seconds`` of the same arrivals, after the window, and stops the
profiler when they have all been answered.

Once the service has exited, the plain reference redraws the checked
requests (a sample drawn from the seed) on the card and compares.

A traffic mix's parameters (``perfbench/traffic/<mix>.json``): ``n``
(the serving batch), ``sampler``, ``steps``, ``rate_per_s``,
``checked_requests``, ``grace_s``, ``trace_seconds``."""
from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench.harness import bench
from perfbench.harness.weights import boot_clock, make_weights, sub_seeds

ROOT = Path(__file__).resolve().parents[2]
MAX_OPEN = 512      # the client's requests in flight at once, above any backlog a run builds


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Seconds from the window's start at which each request is due: a
    Poisson process at ``rate`` over the window, given its count of
    round(rate x seconds) arrivals, so that every seed offers the same
    load; given its count, a Poisson process's arrival times are
    independent and uniform over the window, drawn here from ``seed``."""
    count = max(1, int(round(rate * seconds)))
    return np.sort(np.random.default_rng(seed).uniform(0.0, seconds, count))


def request_seeds(count: int, seed: int) -> List[int]:
    return [int(s) for s in np.random.default_rng(seed).integers(0, 2 ** 62, count)]


def _post(port: int, seed: int, due: float, keep: bool):
    body = json.dumps({"seed": seed, "format": "npy"}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sample", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status}")
        imgs = np.load(io.BytesIO(r.read()))
    done = time.perf_counter()
    return done - due, (imgs if keep else None)


# --------------------------------------------------------------- the server
class Server:
    """The service's process: started with the run's context, it answers
    one JSON line a command."""

    command = (sys.executable, "-m", "perfbench.generators.serve", "--server")

    def __init__(self, ctx: dict):
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        spec = {k: ctx[k] for k in ("cell", "config", "mix", "seed", "device")}
        spec["overrides"] = ctx.get("overrides", [])
        self.proc = subprocess.Popen(list(self.command), stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
                                     env=env)
        self.proc.stdin.write(json.dumps(spec) + "\n")
        self.proc.stdin.flush()
        self.port = int(self._reply()["port"])

    def _reply(self) -> dict:
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the service exited ({self.proc.wait()})")
            if line.startswith("{"):
                return json.loads(line)

    def ask(self, command: str) -> dict:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()
        return self._reply()

    def close(self) -> dict:
        out = self.ask("stop")
        self.proc.stdin.close()
        self.proc.wait(timeout=120)
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def server_main() -> None:
    """The service's process (``--server``): the spec on the first line of
    standard input, then ``trace_start``, ``trace_stop`` and ``stop``."""
    import threading

    import torch
    from igm_tpu_torch.tools.export import export
    from igm_tpu_torch.tools.serve import serve

    from perfbench.harness.device import GROUPS, summarize
    from perfbench.harness.report import forbidden_modules

    spec = json.loads(sys.stdin.readline())
    cfg, mix = spec["config"], spec["mix"]
    device = torch.device(spec["device"])
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-serve-"))
    try:
        ref = bench.reference(cfg["name"])
        weights = make_weights(ref.param_shapes(bench.sizes(cfg)),
                               sub_seeds(spec["seed"])["weights"], device)
        torch.save({k: v.cpu() for k, v in weights.items()}, tmp / "weights.pt")
        del weights
        export([*cfg["experiment"], *spec["overrides"]], str(tmp / "sampler.pt"),
               n=int(mix["n"]), sampler=mix["sampler"], steps=int(mix["steps"]),
               weights=str(tmp / "weights.pt"), device=str(device))
        httpd = serve(str(tmp / "sampler.pt"), "127.0.0.1", 0, str(device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    print(json.dumps({"port": httpd.server_address[1]}), flush=True)
    prof, t0 = None, 0.0
    for command in sys.stdin:
        command = command.strip()
        if command == "clear":
            httpd.service.latencies_ms.clear()
            out = {}
        elif command == "trace_start":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            t0 = time.perf_counter()
            out = {}
        elif command == "trace_stop":
            torch.cuda.synchronize(device)
            window = time.perf_counter() - t0
            prof.stop()
            out = {"summary": summarize(prof, window, GROUPS)}
            prof = None
        elif command == "stop":
            out = {"stats": httpd.service.stats(),
                   "peak": torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0,
                   "forbidden": forbidden_modules()}
        else:
            out = {"error": f"unknown command {command!r}"}
        print(json.dumps(out), flush=True)
        if command == "stop":
            break
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


# --------------------------------------------------------------- the client
def _send(port: int, due_at, req_seeds, t0: float, keep, pool) -> list:
    futures = []
    for i, (a, s) in enumerate(zip(due_at, req_seeds)):
        due = t0 + float(a)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(_post, port, s, due, i in keep))
    return futures


def run(ctx: dict) -> dict:
    mix = ctx["mix"]
    seeds = sub_seeds(ctx["seed"])
    seconds = float(ctx["seconds"])
    due_at = arrivals(float(mix["rate_per_s"]), seconds, seeds["arrivals"])
    req_seeds = request_seeds(len(due_at), seeds["requests"])
    checked = sorted(np.random.default_rng(seeds["sample"]).choice(
        len(due_at), min(int(mix["checked_requests"]), len(due_at)), replace=False).tolist())
    server = Server(ctx)
    try:
        port = server.port
        _post(port, seeds["spare"], time.perf_counter(), False)   # the client's path warm
        server.ask("clear")
        pool = ThreadPoolExecutor(max_workers=MAX_OPEN)
        setup_s = boot_clock() - ctx["started"]
        t0 = time.perf_counter() + 0.05
        futures = _send(port, due_at, req_seeds, t0, set(checked), pool)
        deadline = t0 + seconds + float(mix["grace_s"])
        latencies, kept, failed, last_done = [], {}, 0, t0
        for i, f in enumerate(futures):
            try:
                lat, imgs = f.result(timeout=max(deadline - time.perf_counter(), 0.0))
            except Exception as exc:            # an error or a late response: failed
                print(f"request {i}: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
                failed += 1
                latencies.append(float("inf"))
                continue
            latencies.append(lat)
            last_done = max(last_done, t0 + float(due_at[i]) + lat)
            if imgs is not None:
                kept[i] = imgs
        window_s = last_done - t0
        summary = None
        if ctx["trace"] and ctx["device"] != "cpu":
            server.ask("trace_start")
            extra = arrivals(float(mix["rate_per_s"]), float(mix["trace_seconds"]),
                             seeds["spare"])
            t1 = time.perf_counter() + 0.05
            for f in _send(port, extra, request_seeds(len(extra), seeds["spare"]), t1, set(),
                           pool):
                f.result(timeout=600)
            summary = server.ask("trace_stop")["summary"]
        pool.shutdown(wait=False, cancel_futures=True)
        closing = server.close()
    finally:
        server.kill()

    lat = np.asarray(latencies)
    ctx["latencies"] = (due_at, lat)       # for perfbench/study.py's sweep
    answered = int(np.sum(due_at + lat <= seconds))
    import torch
    device = torch.device(ctx["device"])
    compared = compare(ctx, {i: req_seeds[i] for i in checked}, kept, device,
                       ctx["cell"]["limits"])
    from perfbench.reference.common import dpm_timesteps
    forwards = len(dpm_timesteps(int(mix["steps"])))
    sizes = bench.sizes(ctx["config"])
    flops = bench.flops(ctx["config"]["name"]).forward_flops(sizes)
    from perfbench.harness.report import result as assemble
    result = assemble(ctx, dict(
        attempted=len(lat), failed=failed, setup_s=setup_s,
        e2e={"serve_images_per_s": int(mix["n"]) * answered / seconds},
        layer={"service_p50_ms": closing["stats"].get("p50_ms"),
               "p50_ms": 1e3 * float(np.percentile(lat, 50)),
               "p95_ms": 1e3 * float(np.percentile(lat, 95))},
        flops_per_card=flops * forwards * int(mix["n"]) * (len(lat) - failed),
        window_s=window_s, peak=closing["peak"], summaries=[summary] if summary else [],
        world=1, device=device, compared=compared, sizes=sizes,
        kernel_batch=int(mix["n"])))
    result["forbidden"] = sorted(set(result["forbidden"]) | set(closing["forbidden"]))
    return result


# ------------------------------------------------------------ the reference
def reference_images(ctx: dict, req_seed: int, device, precision: str = "float32"):
    """The plain reference's batch for a request's seed: x_T drawn as the
    service draws it (``torch.Generator(device).manual_seed(seed)``, one
    N(0, I) batch), then the configuration's sampler in float32."""
    import torch

    from perfbench.reference.common import PRECISIONS, dpm_sample, full_float32

    cfg, mix = ctx["config"], ctx["mix"]
    sizes = bench.sizes(cfg)
    ref = bench.reference(cfg["name"])
    full_float32()
    weights = make_weights(ref.param_shapes(sizes), sub_seeds(ctx["seed"])["weights"], device)
    forward, q = ref.make_forward(sizes), PRECISIONS[precision]
    gen = torch.Generator(device=device).manual_seed(int(req_seed))
    x_t = torch.randn((int(mix["n"]), sizes["height"], sizes["width"], sizes["channels"]),
                      generator=gen, device=device)
    return dpm_sample(lambda x, t: forward(weights, x, t.float(), q)[0], x_t,
                      int(mix["steps"]))


def gaps(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """A response against the reference: the widest pixel gap, and the
    root-mean-square gap over the reference's root-mean-square."""
    diff = got.astype(np.float64) - want.astype(np.float64)
    return {"pixel_gap": float(np.abs(diff).max()),
            "rms_gap": float(np.sqrt((diff ** 2).mean()) / max(np.sqrt((want ** 2).mean()),
                                                               1e-30))}


def compare(ctx: dict, checked: Dict[int, int], kept: Dict[int, np.ndarray], device,
            limits: Dict[str, float]) -> dict:
    """The worst gap over the checked responses; a checked request that
    never came reads as infinite."""
    from perfbench.harness.report import checks
    worst: Dict[str, float] = {}
    for i, req_seed in checked.items():
        if i not in kept:
            return checks({}, limits)
        want = reference_images(ctx, req_seed, device).cpu().numpy()
        for k, v in gaps(kept[i], want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return checks(worst, limits)


if __name__ == "__main__" and "--server" in sys.argv:
    server_main()
