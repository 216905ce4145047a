"""Training traffic: the port's trainer loop on a seeded CIFAR-shaped train
set, as ``core/trainer.py`` ``fit`` runs it with validation, checkpoints
and logging off.

Set-up builds the model from the configuration's experiment (the
program's config composer and model code), hands it the benchmark's
weights, makes the uint8 train set on the host, resolves
``steps_per_execution=auto`` as the trainer does (``Trainer.
_auto_steps_per_execution``: the step timed, then the state restored),
and drives the state through its first steps with the window's own feed
and call (``data.loader.epoch_batches`` over one permutation an epoch,
``chunk_batches`` at K, a ``DevicePrefetcher`` an epoch, ``model.
train_step_n``, graphed on the card).  Those steps are the ones the
reference follows.  The window then goes on with the same objects:
chunks fetched, executions dispatched, the metrics read one execution
late at the trainer's logging steps, the device synchronised at each
epoch's end.  With ``chips`` > 1 the ranks are the trainer's
(``parallel.launch.spawn``, one NCCL rank a card, the global batch split
between them); rank 0 reports.

A traffic mix's parameters (``perfbench/traffic/<mix>.json``):
``batch_size`` (the global batch), ``train_images``, ``checked_steps``,
``trace_seconds`` (the profiled sub-window's length)."""
from __future__ import annotations

import contextlib
import gc
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench.harness import bench, report
from perfbench.harness.weights import make_weights, sub_seeds, train_images

STOP_EVERY = 8          # steps between the ranks' agreement on the window's end
SPAWN_TIMEOUT_S = 1500  # the ranks of one run, set-up and reference included


def run(ctx: dict) -> dict:
    """One run of a training cell -> the result (``report.line``'s
    keywords)."""
    world = int(ctx["cell"]["chips"])
    if world == 1:
        return rank_main(ctx["device"], ctx)
    import torch
    from igm_tpu_torch.parallel.launch import spawn
    out = Path(tempfile.mkdtemp(prefix="perfbench-")) / "result.json"
    spawn(_spawned, world, torch.device(ctx["device"]), args=(ctx, str(out)),
          timeout=SPAWN_TIMEOUT_S)
    result = json.loads(out.read_text())
    out.unlink()
    out.parent.rmdir()
    return result


def _spawned(device, ctx: dict, out: str) -> None:
    result = rank_main(device, ctx)
    if result is not None:
        Path(out).write_text(json.dumps(result))


# --------------------------------------------------------------- the model
def build(ctx: dict, device):
    """The program's model for the configuration on ``device`` with the
    benchmark's weights, its mesh bound and its state made -> (model,
    state, mesh, composed config)."""
    import torch
    from igm_tpu_torch.cli import config_dir
    from igm_tpu_torch.config import compose, instantiate
    from igm_tpu_torch.parallel.mesh import make_mesh
    from igm_tpu_torch.utils.platform import set_numerics

    cfg = ctx["config"]
    set_numerics()
    composed = compose(config_dir(), [*cfg["experiment"], *ctx.get("overrides", []),
                                      "print_config=False"])
    check_sizes(cfg, composed)
    model = instantiate(composed.model, datamodule=composed.datamodule, device=device)
    mesh = make_mesh(-1, devices=model.device)
    model.set_mesh(mesh)
    seeds = sub_seeds(ctx["seed"])
    state = model.init_state(seeds["spare"] % (2 ** 31))
    load_weights(model, state, make_weights(
        bench.reference(cfg["name"]).param_shapes(bench.sizes(cfg)), seeds["weights"],
        model.device))
    state.generator.manual_seed(seeds["draws"])
    return model, state, mesh, composed


def check_sizes(cfg: dict, composed) -> None:
    """The composed experiment states the configuration's sizes."""
    for key, want in cfg["model"].items():
        if key in composed.model:
            got = composed.model[key]
            got = list(got) if isinstance(want, list) else got
            if got != want:
                raise ValueError(f"{cfg['name']}: model.{key} composes to {got!r}, the "
                                 f"configuration states {want!r}")


def load_weights(model, state, weights: Dict[str, "torch.Tensor"]) -> None:
    """The benchmark's weights into the denoiser (its parameters in place)
    and its EMA shadow."""
    import torch
    net = model.modules[model.weights_module]
    net.load_state_dict(weights, strict=True)
    ema = state.opt_states.get("ema")
    if ema:
        with torch.no_grad():
            for k, v in ema.items():
                v.copy_(weights[k])


# ---------------------------------------------------------------- the loop
class Loop:
    """The trainer's epoch loop, one execution at a time."""

    def __init__(self, model, state, arrays, batch: int, divisor: int, rows, k: int,
                 order_seed: int, log_every: int, spans: Optional[Dict[str, List[float]]]):
        self.model, self.state, self.arrays = model, state, arrays
        self.batch, self.divisor, self.rows, self.k = batch, divisor, rows, k
        self.rng = np.random.default_rng(order_seed)
        self.log_every = log_every
        self.spans = spans
        self.it = None
        self.pending = None
        self.global_step = 0

    def _mark(self, name: str):
        if self.spans is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"perfbench.{name}")

    def _read(self) -> None:
        if self.pending is not None:
            with self._mark("metrics"):
                {k: float(v) for k, v in self.pending.items()}
            self.pending = None

    def _next_chunk(self):
        from igm_tpu_torch.data.loader import DevicePrefetcher, chunk_batches, epoch_batches
        while True:
            if self.it is None:
                batches = epoch_batches(self.arrays, self.batch, rng=self.rng, shuffle=True,
                                        divisor=self.divisor, rows=self.rows)
                self.it = iter(DevicePrefetcher(chunk_batches(batches, self.k),
                                                self.model.device))
            try:
                return next(self.it)
            except StopIteration:       # the epoch's end, as the trainer ends it
                self.it = None
                self._read()
                sync(self.model.device)

    def step(self) -> dict:
        t0 = time.perf_counter()
        with self._mark("fetch"):
            chunk = self._next_chunk()
        t1 = time.perf_counter()
        with self._mark("dispatch"):
            self.state, metrics = self.model.train_step_n(self.state, chunk)
        t2 = time.perf_counter()
        self._read()
        k = len(chunk[0])
        if self.global_step % self.log_every < max(2, k):
            self.pending = metrics
        self.global_step += k
        if self.spans is not None:
            self.spans["data_wait"].append((t1 - t0) / k)
            self.spans["dispatch"].append((t2 - t1) / k)
        return metrics


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _moe_hooks(net, acc):
    """Forward hooks on the Switch-MoE blocks (the traced run only): each
    call adds the share of its expert slots (E times the global capacity,
    computed on every rank) that its kept tokens fill, from the program's
    routed fractions and capacity, into ``acc`` on the device (a capture
    records the adds, so a replay makes them too)."""
    import torch

    def hook(module, inputs, output):
        n = inputs[0].shape[0] * inputs[0].shape[1]
        world = module.mesh.world if module.mesh is not None else 1
        cap = module.capacity(n * world)
        kept = torch.clamp(output[2] * float(n * world), max=float(cap)).sum() / world
        acc[0].add_(kept / float(module.experts * cap))
        acc[1].add_(1.0)

    for m in net.modules():
        if hasattr(m, "capacity") and hasattr(m, "router"):
            m.register_forward_hook(hook)


# ---------------------------------------------------------------- one rank
def rank_main(device, ctx: dict) -> Optional[dict]:
    import torch
    import torch.distributed as dist
    from igm_tpu_torch.core.trainer import Trainer
    from igm_tpu_torch.data.loader import global_batch

    from perfbench.harness.weights import boot_clock

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    host = dist.new_group(backend="gloo") if grouped else None
    cell, cfg = ctx["cell"], ctx["config"]
    params = ctx["mix"]
    seeds = sub_seeds(ctx["seed"])
    trace = bool(ctx["trace"])
    sizes = bench.sizes(cfg)

    model, state, mesh, composed = build(ctx, device)
    device = model.device
    cuda = device.type == "cuda"
    arrays = (train_images(int(params["train_images"]),
                           (sizes["height"], sizes["width"], sizes["channels"]), seeds["data"]),
              np.zeros(int(params["train_images"]), np.int32))
    batch = int(params["batch_size"])
    n_train = len(arrays[0])
    blocks = model.batch_blocks
    divisor = mesh.ranks * blocks if mesh.grouped else 1
    global_bs = global_batch(n_train, batch, divisor)
    rows = mesh.local_rows(global_bs, blocks) if mesh.grouped else None
    steps_per_epoch = n_train // global_bs
    model.steps_per_epoch = steps_per_epoch

    occupancy = None
    if trace and cuda:
        occupancy = torch.zeros(2, device=device)
        _moe_hooks(model.modules[model.weights_module], occupancy)

    trainer = Trainer(devices=world, steps_per_execution="auto", enable_checkpointing=False)
    trainer.mesh = mesh
    k = trainer._auto_steps_per_execution(model, state, arrays, global_bs, steps_per_epoch,
                                          divisor, rows)
    spans = {"data_wait": [], "dispatch": []} if trace else None
    loop = Loop(model, state, arrays, global_bs, divisor, rows, k, seeds["order"],
                int(composed.trainer.get("log_every_n_steps", 50)), None)

    # the first steps, which the reference follows
    opt = state.opt_states["opt"]
    net = model.modules[model.weights_module]
    named = list(net.named_parameters())
    w0 = {n: p.detach().clone() for n, p in named}
    b1 = float(composed.model.b1)
    losses, g1 = [], None
    checked = int(params.get("checked_steps", 3))
    while loop.global_step < checked:
        metrics = loop.step()
        losses.append(metrics["train_loss/loss"])
        if g1 is None:      # the first moment after one update: (1 - b1) g
            g1 = {n: opt.state[p]["exp_avg"].float() / (1.0 - b1)
                  if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                  for n, p in named}
    program = {"losses": [float(x) for x in losses],
               "grad": _norms(g1),
               "change": _norms({n: p.detach() - w0[n] for n, p in named})}
    del g1, w0

    # the window
    sync(device)
    setup_s = boot_clock() - ctx["started"]
    loop.spans = spans
    if occupancy is not None:
        occupancy.zero_()
    first_step = loop.global_step
    t0 = time.perf_counter()
    stop = torch.zeros(1)
    calls = 0
    while True:
        loop.step()
        calls += 1
        if host is None:
            if time.perf_counter() - t0 >= ctx["seconds"]:
                break
        elif calls % STOP_EVERY == 0:
            stop.fill_(float(rank == 0 and time.perf_counter() - t0 >= ctx["seconds"]))
            dist.all_reduce(stop, op=dist.ReduceOp.MAX, group=host)
            if stop.item():
                break
    sync(device)
    window_s = time.perf_counter() - t0
    steps = loop.global_step - first_step
    images = steps * global_bs

    layer: dict = {}
    summary = None
    if trace:
        layer["spans"] = {k_: float(np.mean(v)) for k_, v in spans.items()}
        if occupancy is not None:
            layer["slot_occupancy"] = float(occupancy[0] / occupancy[1]) \
                if float(occupancy[1]) else None
        loop.spans = None
        if cuda:
            summary = _profiled(loop, window_s / max(steps, 1),
                                float(params.get("trace_seconds", 1.0)), host)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # every rank's readings, then the program freed before the reference
    mine = {"program": program, "peak": peak, "summary": summary,
            "forbidden": report.forbidden_modules()}
    everyone = [mine]
    if host is not None:
        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=host)
    del loop, state, model, trainer, net, named, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        dist.barrier(group=host)
        return None

    reference = follow(ctx, device, global_bs)
    compared = compare([e["program"] for e in everyone], reference, cell["limits"])
    if host is not None:
        dist.barrier(group=host)

    flops = bench.flops(cfg["name"]).train_flops(sizes)
    result = report.result(ctx, dict(
        attempted=steps, failed=0, setup_s=setup_s,
        e2e={"train_images_per_s": images / window_s},
        layer=layer, flops_per_card=flops * images / world, window_s=window_s,
        peak=max(e["peak"] for e in everyone),
        summaries=[e["summary"] for e in everyone if e["summary"] is not None],
        world=world, device=device, compared=compared, sizes=sizes,
        kernel_batch=global_bs // world))
    result["forbidden"] = sorted({n for e in everyone for n in e["forbidden"]}
                                 | set(result["forbidden"]))
    return result


def _norms(tensors) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def _profiled(loop: Loop, t_step: float, seconds: float, host):
    """A profiled sub-window of steady steps after the window (as many on
    every rank): its trace summary, with its step count."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness.device import KERNEL_GROUPS, summarize

    steps = torch.tensor([float(min(max(math.ceil(seconds / max(t_step, 1e-6)), 4), 400))])
    if host is not None:
        dist.all_reduce(steps, op=dist.ReduceOp.MAX, group=host)
    steps = int(steps.item())
    device = loop.model.device
    loop.spans = {"data_wait": [], "dispatch": []}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    sync(device)
    prof.start()
    t0 = time.perf_counter()
    for _ in range(steps):
        loop.step()
    sync(device)
    window = time.perf_counter() - t0
    prof.stop()
    loop.spans = None
    kind = "dit" if loop.model.hparams.get("network") == "dit" else "unet"
    summary = summarize(prof, window, KERNEL_GROUPS[kind])
    summary["steps"] = steps
    return summary


# ------------------------------------------------------------ the reference
def follow(ctx: dict, device, global_bs: int, precision: str = "float32",
           rows=None) -> dict:
    """The plain reference over the first steps from the same inputs: the
    weights and draws remade from the seed, the batches from the same
    permutation of the same train set."""
    import torch

    from perfbench.reference.common import full_float32, leaf_norms, train_steps

    cfg, params = ctx["config"], ctx["mix"]
    sizes = bench.sizes(cfg)
    seeds = sub_seeds(ctx["seed"])
    ref = bench.reference(cfg["name"])
    full_float32()
    weights = make_weights(ref.param_shapes(sizes), seeds["weights"], device)
    data = train_images(int(params["train_images"]),
                        (sizes["height"], sizes["width"], sizes["channels"]), seeds["data"])
    order = np.random.default_rng(seeds["order"]).permutation(len(data))
    steps = int(params.get("checked_steps", 3))
    batches = [torch.from_numpy(data[order[s * global_bs:(s + 1) * global_bs]])
               for s in range(steps)]
    gen = torch.Generator(device=device).manual_seed(seeds["draws"])
    model = sizes
    out = train_steps(ref.make_forward(sizes), weights, batches, gen, lr=float(model["lr"]),
                      b1=float(model["b1"]), b2=float(model["b2"]),
                      aux_weight=float(model.get("moe_aux_weight", 0.0)),
                      precision=precision, steps=steps, rows=rows)
    return {"losses": out["losses"], "grad": leaf_norms(out["grad1"]),
            "change": leaf_norms({k: out["params"][k] - weights[k] for k in weights})}


def compare(programs: List[dict], reference: dict, limits: Dict[str, float]) -> dict:
    """The numbers that decide ``correct``, the worst over the ranks: each
    step's loss against the reference's (relative gap), the first
    gradient's and the three steps' parameter change's worst leaf norm
    gap (against the larger of the leaf's and the median leaf's reference
    norm; leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change)."""
    from perfbench.reference.common import moving_leaves, worst_leaf_gap
    from perfbench.harness.report import checks

    moving = moving_leaves(reference["grad"])
    loss = grad = change = 0.0
    for prog in programs:
        loss = max([loss] + [abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(prog["losses"], reference["losses"])])
        grad = max(grad, worst_leaf_gap(prog["grad"], reference["grad"])[0])
        change = max(change, worst_leaf_gap(prog["change"], reference["change"], moving)[0])
    return checks({"loss_gap": loss, "grad_gap": grad, "update_gap": change}, limits)
