"""Command lines: counterparts of ``igm_tpu/cli.py`` ``train_main`` (one
run, or a multirun: a grid or a TPE sweep) and ``sample_main``.

    python -m igm_tpu_torch.train experiment=ddpm/cifar10 [overrides] \\
        [--device cpu]

composes the config, changes into the run directory ``hydra.run.dir``
(``logs/runs/<exp_name>``, where checkpoints, ``results/*.jpg`` and the
TensorBoard files go) and trains (``igm_tpu_torch.train.train``); with
``optimized_metric`` configured it writes the run's value into
``optimized_metric.json`` there.

    python -m igm_tpu_torch.train experiment=ddpm/cifar10 trainer.devices=N [--device cpu]

trains data-parallel on N ranks (``trainer.devices=-1``: every visible
card), spawned here (``parallel.launch``): NCCL one card a rank, or gloo
processes with ``--device cpu``; ``datamodule.batch_size`` is the global
batch.  ``IGM_MULTIHOST=1`` under ``torchrun`` joins the group ``torchrun``
launched instead of spawning one.  Rank 0 writes the run directory's
checkpoints, logs and ``optimized_metric.json``.

    python -m igm_tpu_torch.train -m experiment=vae/mnist_mlp model.lr=1e-3,5e-4
    python -m igm_tpu_torch.train -m hydra/sweeper=optuna hydra.sweeper.n_trials=20 \\
        +optimized_metric=val_log/log_p_x_of_z experiment=vae/mnist_mlp \\
        'model.lr=tag(log, interval(1e-4,1e-2))'

runs a multirun (``igm_tpu/cli.py:78-207``): the sweep overrides
(``igm_tpu_torch.sweep.parse_override``) expand into jobs, the cartesian
grid in order (the basic sweeper) or the TPE study's trials
(``hydra/sweeper=optuna``: ``trials.jsonl`` in ``hydra.sweep.dir`` is
replayed on a rerun, which goes on where the last stopped, and
``optimization_results.yaml`` holds the best); job ``i`` runs in
``<hydra.sweep.dir>/<i>``.  The launcher (``configs/config.yaml``: joblib)
runs each job as ``python -m igm_tpu_torch.train`` in a worker process,
with this call's ``--device``; ``hydra/launcher=basic`` runs them one after
another in this process, releasing each job's CUDA graphs and memory pool
before the next.  A job that fails fails the multirun (non-zero exit), and a
multirun whose jobs ask for more than one device is refused.

    python -m igm_tpu_torch.cli experiment=ddpm/cifar10 [--ckpt DIR | --weights w.pt] \\
        [--n 64] [--seed 0] [--out samples.png] [--sampler ddim|dpm|heun|multistep] \\
        [--steps 50] \\
        [--label 3] [--inpaint left|right|top|bottom|center [--resample 1]] \\
        [--device cpu]

Composes the config, instantiates the port's model on the card (or on the
device ``--device`` names), loads the weights, runs the model's sampler
(DDPM: ancestral, or ``--sampler ddim|dpm``; EDM: Heun over the Karras
grid, also as ``--sampler heun``; flow matching: the ODE; score-SDE:
``model.sampler``, the predictor-corrector chain or the probability-flow
ODE; consistency: multistep, also as ``--sampler multistep``; progressive
distillation: the student's DDIM on its own grid, or ``--sampler ddim``
at ``student_steps``; ``experiment=vqvae/*``: decoded random codes;
``experiment=tar/*``: the KV-cached decode; ``experiment=realnvp/*``: one
inverse pass of the flow; the VAEs and the adversarial zoo: the decoder or
generator on N(0, I) latents of ``latent_dim``), and writes a grid image.  MADE and PixelCNN have
no sampler here (``igm_tpu``'s CLI fails on them with a KeyError from
``BaseModel.sample``): the port exits with a message; their sample grids come
from validation.  A
``--sampler`` the model lacks (``heun`` on a DDPM, ``multistep`` on
anything but a consistency model) exits with a message.  ``--label``
draws every sample from one class (class-conditional models).  ``--inpaint``
erases a region of the first n validation images of the datamodule
(synthetic when its files are absent) and fills it with RePaint, with
``--resample`` passes per step; the grid shows the masked inputs, then the
results.  ``--ckpt`` restores the
whole train state from the newest of the port's checkpoints in DIR: every
module (for latent DDPM the denoiser, the first stage, the codebook and the
latent scale) and the EMA shadow the samplers use; given an ``.npz`` that
``tools/igm_tpu_ckpt_to_npz.py`` converted from an ``igm_tpu`` checkpoint,
the same from it (no optimizer state).  ``--weights`` takes the
model's network alone (the denoiser; TAR's ``net``; RealNVP's ``flow``; the
zoo's generator, ``netG`` or ``decoder``): a
``torch.save``d state_dict or an ``.npz`` of that network's ``igm_tpu`` param leaves keyed by
their ``/``-joined path (converted through ``igm_tpu_torch.interop``; flow
matching's network is its ``velocity``).  Without either the weights are a seeded random
init, and the CLI says so.

The config tree is found via (first hit wins): ``$IGM_CONFIG_DIR``, then
``./configs`` relative to the CWD, then the repo checkout next to this
package.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch


def config_dir() -> Path:
    cands = [os.environ.get("IGM_CONFIG_DIR"),
             Path.cwd() / "configs",
             Path(__file__).resolve().parent.parent / "configs"]
    for cand in cands:
        if cand and Path(cand).is_dir():
            return Path(cand)
    raise SystemExit("no configs/ tree found: set IGM_CONFIG_DIR or run "
                     "from a directory containing configs/")


def load_weights(module: torch.nn.Module, path: str) -> None:
    """Load a torch state_dict file, or an ``.npz`` of Flax param leaves."""
    if path.endswith(".npz"):
        from .interop import flax_to_torch
        with np.load(path) as npz:
            state = flax_to_torch({k: npz[k] for k in npz.files})
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state, strict=True)


def load_model(cfg, device: torch.device, ckpt: str | None = None,
               weights: str | None = None, seed: int = 0):
    """The config's model on ``device`` with its weights, as the sampling
    CLI loads them: ``ckpt`` restores every module and the EMA shadow from
    the newest of the port's checkpoints in that directory, or from a
    converted ``igm_tpu`` checkpoint (an ``.npz``); ``weights``
    loads the network alone (:func:`load_weights`); with neither, a random
    init from ``seed``."""
    from .config import instantiate

    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    if ckpt:
        from .core.checkpoint import load_converted, read_checkpoint
        state = model.init_state(0)
        saved = read_checkpoint(ckpt)
        if saved.get("converted"):
            load_converted(state, saved)
        else:
            # the training generator's state stays behind: the checkpoint may
            # come from another device, and sampling draws from its own
            state.load_state_dict({**saved, "generator": state.generator.get_state()})
    elif weights:
        load_weights(model.modules[model.weights_module], weights)
    else:
        model.init_params(seed)
        print(f"no --ckpt or --weights: random init from seed {seed}")
    return model


def sampler_call(model, sampler: str | None = None, steps: int | None = None):
    """``(draw, steps)``: ``draw(n, generator, **kwargs)`` gives the images
    the CLI draws with ``--sampler sampler --steps steps`` (sampler None: the
    model's own sampler, and steps None), the named sampler's output clipped
    to [-1, 1], at ``steps`` or the config's ``<sampler>_steps`` or
    ``sample_steps``.  A sampler the model lacks exits with a message."""
    if sampler is None:
        if not model.has_sampler():
            raise SystemExit(f"{type(model).__name__} has no sampler here: its sample grids "
                             "come from validation (python -m igm_tpu_torch.train)")
        return model.sample, None
    method = getattr(model, f"{sampler}_sample", None)
    if method is None:
        raise SystemExit(f"--sampler {sampler}: {type(model).__name__} has no "
                         f"{sampler}_sample")
    steps = steps or int(model.hparams.get(f"{sampler}_steps")
                         or model.hparams.get("sample_steps"))

    def draw(n: int, generator: torch.Generator, **kwargs) -> torch.Tensor:
        return torch.clamp(method(n, steps=steps, generator=generator, **kwargs), -1.0, 1.0)

    return draw, steps


def train_main(argv=None):
    """One training run (returns the ``optimized_metric`` when configured),
    or with ``-m`` a multirun."""
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.train")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides (experiment=...); with -m also sweeps")
    parser.add_argument("-m", "--multirun", action="store_true",
                        help="a grid over comma lists, or hydra/sweeper=optuna")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_intermixed_args(argv)

    from .config import compose
    from .utils.platform import resolve_device, set_numerics

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
    device = resolve_device(args.device)
    set_numerics()
    if args.multirun:
        return _multirun(args.overrides, args.device, device)
    if os.environ.get("IGM_MULTIHOST") == "1":       # one rank of a torchrun launch
        from .parallel.launch import init_from_env, leave_group
        device = init_from_env(device)
        result = _single_run(args.overrides, device)
        leave_group()
        return result
    world = _world_size(compose(config_dir(), args.overrides), device)
    if world > 1:
        from .parallel.launch import spawn
        spawn(_rank_run, world, device, (args.overrides,))
        return None
    return _single_run(args.overrides, device)


def _world_size(cfg, device: torch.device) -> int:
    """The ranks the config's ``trainer.devices`` asks for on ``device``."""
    from .config import select
    from .parallel.launch import world_size
    return world_size(select(cfg, "trainer.devices", 1), device)


def _rank_run(device: torch.device, overrides) -> None:
    """One spawned rank of ``trainer.devices=N``: its logging and numerics
    (a fresh interpreter), then the run."""
    from .utils.platform import set_numerics
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
    set_numerics()
    _single_run(overrides, device)


def _single_run(overrides, device: torch.device, multirun_subdir=None):
    from .config import compose, select, to_plain
    from .sweep import write_result
    from .train import train

    cfg = compose(config_dir(), overrides)
    if cfg.get("print_config") and _rank() == 0:
        import yaml
        print(yaml.safe_dump(to_plain(cfg), default_flow_style=False, sort_keys=False))
    if multirun_subdir is None:
        run_dir = select(cfg, "hydra.run.dir", None)
    else:
        sweep_dir = select(cfg, "hydra.sweep.dir", None)
        run_dir = sweep_dir and os.path.join(str(sweep_dir), multirun_subdir)
    chdir = bool(select(cfg, "hydra.job.chdir", True)) and run_dir
    cwd = os.getcwd()
    try:
        if chdir:
            os.makedirs(run_dir, exist_ok=True)
            os.chdir(run_dir)
        result = train(cfg, device)
        if result is not None and _rank() == 0:
            print(f"optimized_metric: {result}")
            # the run directory: the CWD when changed into, else as named
            # (relative to the launch directory)
            out_dir = Path(os.getcwd()) if chdir or not run_dir else Path(run_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            write_result(out_dir, result)
        return result
    finally:
        os.chdir(cwd)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _partition_sweep(overrides):
    """CLI tokens -> fixed overrides and (key, Dist) sweep dimensions."""
    from .sweep import parse_override

    fixed, swept = [], []
    for ov in overrides:
        key, dist = parse_override(ov)
        if dist is None:
            fixed.append(ov)
        else:
            swept.append((key, dist))
    return fixed, swept


def _multirun(overrides, device_arg, device: torch.device) -> None:
    from .config import compose, select
    from .sweep import launch

    fixed, swept = _partition_sweep(overrides)
    cfg = compose(config_dir(), fixed)
    if _world_size(cfg, device) > 1 or any(k == "trainer.devices" for k, _ in swept):
        raise SystemExit("a multirun job trains on one device: drop trainer.devices (or "
                         "set it to 1) for -m")
    sweeper = select(cfg, "hydra.sweeper", None) or {"_target_": "basic"}
    launcher = select(cfg, "hydra.launcher", None) or {"_target_": "basic"}
    sweep_dir = Path(str(select(cfg, "hydra.sweep.dir", "logs/multiruns")))
    worker_argv = [sys.executable, "-m", "igm_tpu_torch.train",
                   *(["--device", device_arg] if device_arg else [])]

    def run_inline(job):
        try:
            return _single_run(job.overrides, device, multirun_subdir=job.subdir)
        finally:
            # a finished job's CUDA graphs sit in reference cycles with its
            # model: free them and their pools before the next job captures
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    def run_jobs(jobs):
        return launch(jobs, launcher, sweep_dir, worker_argv, run_inline=run_inline)

    if str(sweeper.get("_target_")) == "optuna":
        _optuna_sweep(fixed, swept, sweeper, sweep_dir, run_jobs)
    else:
        _grid_sweep(fixed, swept, run_jobs)


def _grid_sweep(fixed, swept, run_jobs) -> None:
    from .sweep import Job, format_value

    grids = [[f"{k}={format_value(v)}" for v in d.grid()] for k, d in swept]
    jobs = [Job(overrides=fixed + list(combo), subdir=str(i))
            for i, combo in enumerate(itertools.product(*grids))]
    for i, job in enumerate(jobs):
        print(f"--- multirun job {i}: {job.overrides}")
    results = run_jobs(jobs)
    failed = [j.subdir for j, r in zip(jobs, results) if not r.ok]
    if failed:
        raise SystemExit(f"multirun: {len(failed)}/{len(jobs)} jobs failed "
                         f"(subdirs {', '.join(failed)})")


def _optuna_sweep(fixed, swept, sweeper, sweep_dir: Path, run_jobs) -> None:
    import yaml

    from .sweep import Job, Study, dist_from_config, format_value

    space = dict(swept)
    for key, node in dict(sweeper.get("search_space") or {}).items():
        space.setdefault(key, dist_from_config(node))
    if not space:
        raise SystemExit("hydra/sweeper=optuna needs at least one sweep "
                         "dimension, e.g. 'model.lr=interval(1e-4,1e-2)'")
    study = Study(space, direction=str(sweeper.get("direction", "minimize")),
                  sampler=str(sweeper.get("sampler", "tpe")),
                  seed=sweeper.get("seed"),
                  n_startup_trials=int(sweeper.get("n_startup_trials", 10)))
    n_trials = int(sweeper.get("n_trials", 20))
    n_jobs = max(1, int(sweeper.get("n_jobs", 1)))

    # resume: replay the journal of finished trials, so that a sweep cut
    # short goes on where it stopped when the same command runs again
    journal = sweep_dir / "trials.jsonl"
    done = 0
    if journal.exists():
        for line in journal.read_text().splitlines():
            rec = json.loads(line)
            study.add_observation(rec["params"], rec.get("value"))
            done += 1
        if done:
            print(f"--- optuna resume: replayed {done} finished trials from {journal}")

    while done < n_trials:
        batch = [study.ask() for _ in range(min(n_jobs, n_trials - done))]
        jobs = [Job(overrides=fixed + [f"{k}={format_value(v)}" for k, v in t.params.items()],
                    subdir=str(t.number))
                for t in batch]
        for t, job in zip(batch, jobs):
            print(f"--- optuna trial {t.number}: {job.overrides}")
        results = run_jobs(jobs)
        os.makedirs(sweep_dir, exist_ok=True)
        with open(journal, "a") as fh:
            for t, r in zip(batch, results):
                study.tell(t, r.value if r.ok else None)
                print(f"--- optuna trial {t.number} value: {r.value if r.ok else 'FAILED'}")
                fh.write(json.dumps({"number": t.number, "params": t.params,
                                     "value": t.value}) + "\n")
        done += len(batch)
    try:
        best = study.best_trial
    except RuntimeError:
        raise SystemExit(
            "optuna sweep: no trial returned an objective - set "
            "`+optimized_metric=<logged metric>` (e.g. val_log/log_p_x_of_z) so "
            "train() returns a value to optimize") from None
    print(f"Best value: {best.value} (trial {best.number})")
    print(f"Best params: {best.params}")
    results = {"name": "optuna", "best_value": best.value, "best_params": dict(best.params)}
    os.makedirs(sweep_dir, exist_ok=True)
    (sweep_dir / "optimization_results.yaml").write_text(
        yaml.safe_dump(results, sort_keys=False))


def sample_main(argv=None) -> torch.Tensor:
    """Writes the grid; returns the images it shows (model space, on the
    model's device)."""
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.cli")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides (experiment=...)")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", default=None,
                         help="a directory of the port's checkpoints (restore "
                              "every module from the newest), or a converted igm_tpu "
                              "checkpoint (.npz)")
    weights.add_argument("--weights", default=None,
                         help="the network's weights (the denoiser; TAR's net; RealNVP's "
                              "flow; the zoo's generator): a torch state_dict file, or an "
                              ".npz of igm_tpu param leaves by '/'-joined path")
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--out", default="samples.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", type=int, default=None,
                        help="class label (conditional models, e.g. ddpm/cond_mnist): "
                             "draw all n samples from this class")
    parser.add_argument("--inpaint", default=None,
                        choices=["left", "right", "top", "bottom", "center"],
                        help="diffusion models: erase this region of n validation "
                             "images and inpaint it (RePaint); the grid shows the "
                             "masked inputs, then the results")
    parser.add_argument("--resample", type=int, default=1,
                        help="RePaint resampling passes per step (U)")
    parser.add_argument("--sampler", default=None,
                        choices=["ddim", "dpm", "heun", "multistep"],
                        help="a sampler instead of the model's default (ddim, dpm: the "
                             "DDPM family; heun: EDM; multistep: consistency)")
    parser.add_argument("--steps", type=int, default=None,
                        help="fast-sampler step count (default: config)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_intermixed_args(argv)

    from .callbacks.visualization import get_grid_images, save_image_grid
    from .config import compose, instantiate
    from .utils.platform import resolve_device, set_numerics

    device = resolve_device(args.device)
    set_numerics()
    cfg = compose(config_dir(), [*args.overrides, "print_config=False"])
    model = load_model(cfg, device, args.ckpt, args.weights, args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    kwargs = {}
    if args.label is not None:
        import inspect
        target = getattr(model, "inpaint" if args.inpaint else "sample", None)
        if target is None or "y" not in inspect.signature(target).parameters:
            raise SystemExit(f"--label: {type(model).__name__} is not class-conditional")
        kwargs["y"] = torch.full((args.n,), args.label, dtype=torch.long, device=device)

    if args.inpaint:
        if not hasattr(model, "inpaint"):
            raise SystemExit(f"--inpaint: {type(model).__name__} has no inpaint sampler "
                             "(diffusion models only)")
        dm = instantiate(cfg.datamodule)
        dm.prepare_data()
        dm.setup()
        x0 = model.preprocess(torch.from_numpy(dm.val_arrays()[0][:args.n]))
        h, w = x0.shape[1], x0.shape[2]
        mask = torch.ones((1, h, w, 1), device=x0.device)       # 1 = known, 0 = hole
        region = {"left": np.s_[:, :, : w // 2], "right": np.s_[:, :, w // 2:],
                  "top": np.s_[:, : h // 2], "bottom": np.s_[:, h // 2:],
                  "center": np.s_[:, h // 4: 3 * h // 4, w // 4: 3 * w // 4]}
        mask[region[args.inpaint]] = 0.0
        painted = model.inpaint(x0, mask, resample=args.resample, generator=generator,
                                **kwargs)
        imgs = torch.cat([mask * x0, painted])       # holes render mid-gray in [-1, 1]
        n_show = 2 * args.n
    else:
        draw, _ = sampler_call(model, args.sampler, args.steps)
        imgs = draw(args.n, generator, **kwargs)
        n_show = args.n
    grid = get_grid_images(imgs.float().cpu().numpy(), model, nimgs=n_show)
    save_image_grid(grid, args.out)
    print(f"wrote {args.out} ({n_show} images)")
    return imgs


if __name__ == "__main__":
    sample_main()
