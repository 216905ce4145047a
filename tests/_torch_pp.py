"""The port's pipeline parallelism (a ``(data, stage)`` mesh) and the
collectives of sequence parallelism, in spawned ranks, recording what
``tests/test_torch_pipeline.py`` compares: the pipelined DiT's output and
gradients, pipelined DDPM train steps (``_torch_mp.run``'s records), a
one-process checkpoint restored on a pipeline mesh, the model group's
collectives in one tensor-parallel step with and without the sequence
split, ``sample_sharded`` on the pipeline mesh, and the training CLI on
it.

Spawned ranks import this module: it imports no JAX and nothing of
``igm_tpu`` (each rank reports whether ``jax`` got into ``sys.modules``).
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import _torch_dp as dp  # noqa: E402
import _torch_mp as mp  # noqa: E402
from igm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS, make_mesh  # noqa: E402

# tests/test_pipeline.py's DiT: 64 wide, 4 deep, 2 heads, patch 4 on 16x16
DEPTH, DIM, HEADS, PATCH, IMG = 4, 64, 2, 4, 16
# its DDPM (tests/test_pipeline.py's _ddpm) in the stacked layout
PIPE_DIT = ["experiment=ddpm/cifar10_dit", f"model.hidden_dim={DIM}", f"model.depth={DEPTH}",
            f"model.heads={HEADS}", f"model.patch={PATCH}", "model.timesteps=8",
            "model.loss_type=l2", "model.compute_dtype=float32", f"datamodule.width={IMG}",
            f"datamodule.height={IMG}", "model.ema_decay=0", "+model.block_mode=scan"]
# with an EMA shadow, which a stage keeps of its blocks alone
PIPE_DIT_EMA = [*PIPE_DIT, "model.ema_decay=0.9"]
# the DiT-level cases: name, (data, stage), microbatches, remat, batch.
# "m3" asks for 3 microbatches of 4 rows: the sequential stack
DIT_CASES = [(f"dit_{d}x{s}_m{m}", (d, s), m, False, 8) for d, s in ((1, 4), (2, 2))
             for m in (1, 2, 4)]
DIT_CASES += [("dit_1x4_m2_remat", (1, 4), 2, True, 4), ("dit_2x2_m3", (2, 2), 3, False, 8)]
SAMPLE_N = 8
# the DDPM train steps: name -> (overrides, global batch, steps, mesh keywords)
STEP_CASES = {
    "ddpm_1x4_m2": (PIPE_DIT_EMA, 8, 2, dict(stage=4, microbatches=2)),
    "ddpm_2x2_m4": (PIPE_DIT_EMA, 8, 2, dict(data=2, stage=2, microbatches=4)),
    "ddpm_1x4_m2_remat": ([*PIPE_DIT_EMA, "model.remat=true"], 8, 2,
                          dict(stage=4, microbatches=2)),
}


def dit_inputs(b: int, seed: int = 0):
    """tests/test_pipeline.py's inputs: x (b, 16, 16, 3) and t, seeded."""
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(b, IMG, IMG, 3).astype(np.float32))
    t = torch.from_numpy(r.randint(0, 10, size=(b,)).astype(np.float32))
    return x, t


def seeded_dit(**kw):
    """The scan DiT from generator seed 1, every parameter moved by 0.05
    N(0, 1) off adaLN-Zero (whose zero gates would hide the blocks)."""
    from igm_tpu_torch.networks.dit import DiT
    net = DiT(dim=DIM, depth=DEPTH, heads=HEADS, patch=PATCH, channels=3, block_mode="scan",
              **kw)
    gen = torch.Generator().manual_seed(1)
    for module in net.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return net


def dit_loss_grads(net, x, t):
    """The output, and the gradients of mean(out ** 2) in ``parameters()``
    order (zeros where the loss does not reach a parameter)."""
    out = net(x, t)
    params = list(net.parameters())
    grads = torch.autograd.grad(out.square().mean(), params, allow_unused=True)
    return out.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _dit_case(device, d: int, s: int, micro: int, remat: bool, batch: int) -> dict:
    """The pipelined DiT on this rank's rows: the global output and the
    gradients summed over ``stage`` and averaged over ``data``, as the
    optimizer reduces them."""
    from igm_tpu_torch.parallel.pipeline import make_pipeline_mesh
    mesh = make_pipeline_mesh(s, d, devices=device)
    net = seeded_dit(pipe_mesh=mesh, pipe_microbatches=micro, remat=remat)
    x, t = dit_inputs(batch)
    rows = slice(mesh.rank * batch // d, (mesh.rank + 1) * batch // d)
    out, grads = dit_loss_grads(net, x[rows], t[rows])
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group_of(DATA_AXIS, STAGE_AXIS))
    parts = [torch.empty_like(out) for _ in range(d)]
    dist.all_gather(parts, out.contiguous(), group=mesh.group)
    return {"out": torch.cat(parts), "grads": flat / d, "jax": "jax" in sys.modules}


_COLLECTIVES = {"all_reduce": "all_reduce", "all_gather_into_tensor": "all_gather",
                "all_gather": "all_gather", "reduce_scatter_tensor": "reduce_scatter"}


def count_collectives(model, state, batch, group) -> list:
    """One eager train step of ``model`` on ``batch`` (this rank's rows),
    recording every collective over ``group``: (kind, elements)."""
    seen, saved = [], {}
    for fn, kind in _COLLECTIVES.items():
        saved[fn] = getattr(dist, fn)

        def counted(*args, _fn=saved[fn], _kind=kind, **kwargs):
            if kwargs.get("group") is group:
                t = args[0] if args else kwargs.get("tensor")
                numel = sum(p.numel() for p in t) if isinstance(t, list) else t.numel()
                seen.append((_kind, int(numel)))
            return _fn(*args, **kwargs)
        setattr(dist, fn, counted)
    try:
        model.train_step_n(state, tuple(b[None] for b in batch), graph=False)
    finally:
        for fn, original in saved.items():
            setattr(dist, fn, original)
    return seen


def _signature(device, out: Path, rank: int) -> None:
    """The tiny DiT's step on the (2, 2) tensor mesh, with and without the
    sequence split: the model group's collectives."""
    overrides, n, _, _ = mp.CASES["tensor_dit"]
    batch = dp.make_batch(dp.build(overrides), n, 3)
    record = {}
    for name, kw in (("tensor", {}), ("sequence", dict(sequence=True))):
        mesh = make_mesh(2, devices=device, model=2, mode="tensor")
        model = mp.build_on(overrides, device, mesh, kw)
        model.set_mesh(mesh)
        state = model.init_state(0)
        local = mp.shard_batch(mesh, batch)
        record[name] = count_collectives(model, state, local, mesh.group_of(MODEL_AXIS))
    record["tokens"] = (n // 2) * (16 // 4) ** 2 * 32       # a rank's rows x tokens x width
    torch.save(record, out / f"signature.rank{rank}.pt")


def _resume_on_pipeline(device, out: Path, ckpt: Path, rank: int) -> None:
    """A one-process checkpoint (rank 0 writes it) restored on the (1, 4)
    pipeline mesh, the whole state gathered back and saved."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    from igm_tpu_torch.parallel.mesh import barrier
    overrides, n, _, _ = STEP_CASES["ddpm_1x4_m2"]
    batch = dp.make_batch(dp.build(overrides), n, 7)
    mesh = make_mesh(devices=device, stage=4)
    manager = CheckpointManager(str(ckpt))
    if rank == 0:
        one = dp.build(overrides, device)
        state = one.init_state(0)
        state, _ = one.train_step_n(state, tuple(torch.from_numpy(a)[None] for a in batch),
                                    graph=False)
        manager.save(state.step, state)
        manager.wait()
    barrier(mesh)
    model = mp.build_on(overrides, device, mesh, dict(microbatches=2))
    model.set_mesh(mesh)
    restored = manager.restore(model.init_state(0))
    bytes_ = mp.state_bytes(restored)
    whole = restored.full_state_dict()
    torch.save({"params": {k: v.cpu() for k, v in whole["params"].items()},
                "opt_states": whole["opt_states"], "step": restored.step, "bytes": bytes_},
               out / f"resume_on_pipeline.rank{rank}.pt")


def _sample_on_pipeline(device, out: Path, rank: int, n: int) -> None:
    """DDIM over ``n`` images from generator seed 0 through
    ``sample_sharded`` on the (2, 2) pipeline mesh, from the split state of
    ``init_state(0)`` (each rank gathers the stages' blocks first)."""
    from igm_tpu_torch.parallel.mesh import sample_sharded
    kw = dict(data=2, stage=2, microbatches=2)
    mesh = mp.mesh_of(device, **kw)
    model = mp.build_on(PIPE_DIT, device, mesh, kw)
    model.set_mesh(mesh)
    state = model.init_state(0)
    gen = torch.Generator(device=device).manual_seed(0)
    imgs = sample_sharded(model, mesh, state, gen, n, sampler="ddim_sample")
    torch.save({"imgs": imgs.cpu(), "bytes": mp.state_bytes(state), "jax": "jax" in sys.modules},
               out / f"sample_pipeline.rank{rank}.pt")


def rank_main(device, jobs, fits, out_dir: str, later: str) -> None:
    """One of four spawned ranks: the DiT-level cases; each train-step job
    ``(name, overrides, batch, steps, mesh keywords, weights, draws)`` on
    its mesh (``_torch_mp.run``); the collective signature; a one-process
    checkpoint restored on the pipeline mesh; each of ``fits`` (CLI
    overrides) through the training CLI's rank entry; then the jobs the
    parent writes to the file ``later`` meanwhile.  Records are saved as
    ``<out_dir>/<name>.rank<r>.pt``."""
    from igm_tpu_torch import cli
    from igm_tpu_torch.parallel.launch import TIMEOUT_S
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = Path(out_dir)
    for name, (d, s), micro, remat, batch in DIT_CASES:
        torch.save(_dit_case(device, d, s, micro, remat, batch), out / f"{name}.rank{rank}.pt")

    def run_jobs(jobs):
        for name, overrides, batch, steps, mesh_kw, weights, draws in jobs:
            mesh = mp.mesh_of(device, **mesh_kw)
            record = mp.run(mp.build_on(overrides, device, mesh, mesh_kw), batch, steps, mesh,
                            weights, draws)
            torch.save(record, out / f"{name}.rank{rank}.pt")

    run_jobs(jobs)
    _sample_on_pipeline(device, out, rank, SAMPLE_N)
    _signature(device, out, rank)
    _resume_on_pipeline(device, out, out / "one_process_ckpt", rank)
    for overrides in fits:
        cli._rank_run(device, overrides)
    deadline = time.monotonic() + TIMEOUT_S
    while not Path(later).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{later} never came")
        time.sleep(0.05)
    run_jobs(torch.load(later, weights_only=False))


def eight_rank_main(device, out_dir: str, batch, weights) -> None:
    """One of eight ranks of the (2, 4) pipeline mesh: two DDPM steps of
    the pipelined DiT from ``weights``, the record saved as
    ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    kw = dict(data=2, stage=4, microbatches=2)
    mesh = mp.mesh_of(device, **kw)
    record = mp.run(mp.build_on(PIPE_DIT, device, mesh, kw), batch, 2, mesh, weights)
    torch.save(record, Path(out_dir) / f"rank{dist.get_rank()}.pt")
