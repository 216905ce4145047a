"""The port's train steps run in one process or as one rank of a data-axis
mesh, recording what the data-parallel parity tests compare: each step's
metrics (averaged over the ranks by ``train_step_n``), each update's
gradients after the reduction over the ranks (``OptimizerSet.reduce_grads``),
the modules' parameters and buffers after the steps, and the steps'
collectives as the tracing registry counted them and as
``torch.distributed`` was called.

Spawned ranks import this module: it imports no JAX and nothing of
``igm_tpu`` (each rank reports whether ``jax`` got into ``sys.modules``).
"""
import contextlib
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.core import trace  # noqa: E402
from igm_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: E402

# the bytes of a collective's whole buffer on the rank, by the call's
# arguments: an all-reduce's or a broadcast's tensor, an all-gather's
# output, a reduce-scatter's input
ISSUED = {"all_reduce": lambda t, *a, **k: _nbytes(t),
          "broadcast": lambda t, *a, **k: _nbytes(t),
          "all_gather": lambda parts, t, *a, **k: sum(_nbytes(p) for p in parts),
          "all_gather_into_tensor": lambda out, t, *a, **k: _nbytes(out),
          "reduce_scatter_tensor": lambda out, t, *a, **k: _nbytes(t)}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def issued_collectives():
    """The ``torch.distributed`` collectives called inside the block, as
    ``[calls, bytes]``."""
    import torch.distributed as dist
    seen = [0, 0]
    saved = {name: getattr(dist, name) for name in ISSUED}

    def wrap(name):
        def call(*args, **kwargs):
            seen[0] += 1
            seen[1] += ISSUED[name](*args, **kwargs)
            return saved[name](*args, **kwargs)
        return call

    for name in ISSUED:
        setattr(dist, name, wrap(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)

CONV64 = ["networks.encoder.ndf=4", "networks.decoder.ngf=4"]
# satellite (i): experiment overrides at tiny widths, global batch, steps
# (two steps, or one a branch of a model whose step alternates)
CASES = {
    "ddpm": (["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
              "model.timesteps=16", "datamodule.width=8", "datamodule.height=8"], 8, 2),
    "vae": (["experiment=vae/celeba", *CONV64], 8, 2),
    "factor_vae": (["experiment=factor_vae/dsprites", *CONV64], 8, 2),
    "vqvae_ema": (["experiment=vqvae/mnist_ema", "datamodule.width=16", "datamodule.height=16",
                   "model.latent_dim=8", "model.num_embeddings=16",
                   "+networks.encoder.res_h_dim=8", "+networks.decoder.h_dim=8",
                   "+networks.decoder.res_h_dim=8"], 8, 2),
    "age": (["experiment=age/celeba", *CONV64, "model.latent_dim=8"], 8, 2),
    "wgan_gp": (["experiment=wgan_gp/celeba", *CONV64, "model.n_critic=1"], 8, 2),
    "infogan": (["experiment=infogan/mnist", *CONV64, "model.encode_dim=16",
                 "model.noise_dim=8"], 8, 2),
    "tar_dropout": (["experiment=tar/mnist", "datamodule.width=6", "datamodule.height=6",
                     "model.d_model=16", "model.nhead=2", "model.num_layers=1",
                     "model.flash_attention=dropout"], 8, 2),
}


def build(overrides, device="cpu"):
    cfg = compose(REPO / "configs", [*overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    model.steps_per_epoch = 100
    return model


def make_batch(model, n: int, seed: int):
    """uint8 images and int32 labels of a global batch, from ``seed``."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, model.height, model.width, model.channels), np.uint8)
    return imgs, rng.integers(0, 10, n).astype(np.int32)


def run(model, batch, steps: int, mesh=None, weights=None, draws=None) -> dict:
    """``steps`` train steps from ``init_state(0)`` (then ``weights``, a
    state_dict, loaded) on ``batch`` (this rank's rows of it on a mesh).
    ``draws``: the train step's keyword draws over the global batch, each
    rank given its rows.  Returns the record the tests compare: the metrics
    of each step; each update's optimizer, parameter names, learning rate
    and reduced gradients; the state_dict after."""
    model.set_mesh(mesh)
    state = model.init_state(0)
    if weights is not None:
        model.modules.load_state_dict(weights, strict=True)
    names = {id(p): k for k, p in model.modules.named_parameters()}
    opts = model.optimizers
    updates, reduced = [], []
    reduce, apply = opts.reduce_grads, opts._apply

    def recorded_reduce(gs, *args):
        out = reduce(gs, *args)
        reduced.append([g.detach().clone().cpu() for g in out])
        return out

    def recorded_apply(opt_name, opt, params, grads, *args, **kwargs):
        apply(opt_name, opt, params, grads, *args, **kwargs)
        lr = max(float(g["lr"]) for g in opt.param_groups)
        updates.append((opt_name, [names[id(p)] for p in params], lr, reduced.pop()))

    opts.reduce_grads, opts._apply = recorded_reduce, recorded_apply
    blocks = model.batch_blocks
    if mesh is None:
        local = tuple(torch.from_numpy(a).to(model.device) for a in batch)
    else:
        local = shard_batch(mesh, batch, blocks)
    if draws:
        kw = {k: (torch.from_numpy(v) if mesh is None
                  else shard_batch(mesh, [v], blocks)[0]).to(model.device)
              for k, v in draws.items()}
        model.train_step = functools.partial(type(model).train_step, model, **kw)
    metrics = []
    counted = trace.work_counts()
    with issued_collectives() as issued:
        for _ in range(steps):
            state, m = model.train_step_n(state, tuple(b[None] for b in local), graph=False)
            metrics.append({k: float(v) for k, v in m.items()})
    after = trace.work_counts()
    moved = {k: after.get(k, 0) - counted.get(k, 0)
             for k in ("mesh.collectives", "mesh.collective_bytes")}
    return {"metrics": metrics, "updates": updates, "step": state.step,
            "state": {k: v.detach().cpu().clone() for k, v in model.modules.state_dict().items()},
            "jax": "jax" in sys.modules,
            "collectives": {"counted": moved["mesh.collectives"],
                            "counted_bytes": moved["mesh.collective_bytes"],
                            "issued": issued[0], "issued_bytes": issued[1]}}


def rank_main(device, jobs, samples, fits, out_dir: str, later: str) -> None:
    """One spawned rank: each job ``(name, overrides, batch, steps,
    weights, draws)`` run on this rank's mesh, its record saved as
    ``<out_dir>/<name>.rank<r>.pt``; each sample job ``(name, overrides,
    n, sampler, keywords)``: ``model.<sampler>`` over ``n`` images from
    generator seed 0 through ``sample_sharded``, saved the same way; each
    of ``fits`` (CLI overrides) through the training CLI's rank entry;
    then the jobs the parent writes to the file ``later`` meanwhile."""
    from igm_tpu_torch import cli
    from igm_tpu_torch.parallel.launch import TIMEOUT_S
    from igm_tpu_torch.parallel.mesh import sample_sharded
    torch.set_num_threads(1)
    mesh = make_mesh(devices=device)
    out = Path(out_dir)

    def run_jobs(jobs):
        for name, overrides, batch, steps, weights, draws in jobs:
            record = run(build(overrides, device), batch, steps, mesh, weights, draws)
            torch.save(record, out / f"{name}.rank{mesh.rank}.pt")

    run_jobs(jobs)
    for name, overrides, n, sampler, kwargs in samples:
        model = build(overrides, device)
        gen = torch.Generator(device=device).manual_seed(0)
        imgs = sample_sharded(model, mesh, None, gen, n, sampler=sampler, **kwargs)
        torch.save({"imgs": imgs.cpu(), "jax": "jax" in sys.modules},
                   out / f"{name}.rank{mesh.rank}.pt")
    for overrides in fits:
        cli._rank_run(device, overrides)
    deadline = time.monotonic() + TIMEOUT_S
    while not Path(later).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{later} never came")
        time.sleep(0.05)
    run_jobs(torch.load(later, weights_only=False))
