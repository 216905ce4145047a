"""Command lines: counterparts of ``igm_tpu/cli.py`` ``train_main`` (one
run; multirun and sweeps wait) and ``sample_main``.

    python -m igm_tpu_torch.train experiment=ddpm/cifar10 [overrides] \\
        [--device cpu]

composes the config, changes into the run directory ``hydra.run.dir``
(``logs/runs/<exp_name>``, where checkpoints, ``results/*.jpg`` and the
TensorBoard files go) and trains (``igm_tpu_torch.train.train``).

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
latent scale) and the EMA shadow the samplers use.  ``--weights`` takes the
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
import logging
import os
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


def train_main(argv=None):
    """One training run; returns the ``optimized_metric`` when configured."""
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.train")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides (experiment=...)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_intermixed_args(argv)
    if any(o in ("-m", "--multirun") for o in args.overrides):
        raise SystemExit("multirun and sweeps are not ported yet: one run per call")

    from .config import compose, select, to_plain
    from .train import train
    from .utils.platform import resolve_device, set_numerics

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
    device = resolve_device(args.device)
    set_numerics()
    cfg = compose(config_dir(), args.overrides)
    if cfg.get("print_config"):
        import yaml
        print(yaml.safe_dump(to_plain(cfg), default_flow_style=False, sort_keys=False))
    run_dir = select(cfg, "hydra.run.dir", None)
    chdir = bool(select(cfg, "hydra.job.chdir", True)) and run_dir
    cwd = os.getcwd()
    try:
        if chdir:
            os.makedirs(run_dir, exist_ok=True)
            os.chdir(run_dir)
        result = train(cfg, device)
    finally:
        os.chdir(cwd)
    if result is not None:
        print(f"optimized_metric: {result}")
    return result


def sample_main(argv=None) -> torch.Tensor:
    """Writes the grid; returns the images it shows (model space, on the
    model's device)."""
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.cli")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides (experiment=...)")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", default=None,
                         help="a directory of the port's checkpoints: restore "
                              "every module from the newest")
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
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    if args.ckpt:
        from .core.checkpoint import CheckpointManager
        state = model.init_state(0)
        saved = CheckpointManager(args.ckpt).restore_raw()
        # the training generator's state stays behind: the checkpoint may
        # come from another device, and sampling draws from its own
        state.load_state_dict({**saved, "generator": state.generator.get_state()})
    elif args.weights:
        load_weights(model.modules[model.weights_module], args.weights)
    else:
        model.init_params(args.seed)
        print(f"no --ckpt or --weights: random init from seed {args.seed}")
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
    elif args.sampler:
        method = getattr(model, f"{args.sampler}_sample", None)
        if method is None:
            raise SystemExit(f"--sampler {args.sampler}: {type(model).__name__} has no "
                             f"{args.sampler}_sample")
        steps = args.steps or int(model.hparams.get(f"{args.sampler}_steps")
                                  or model.hparams.get("sample_steps"))
        imgs = torch.clamp(method(args.n, steps=steps, generator=generator, **kwargs),
                           -1.0, 1.0)
        n_show = args.n
    else:
        if not model.has_sampler():
            raise SystemExit(f"{type(model).__name__} has no sampler here: its sample grids "
                             "come from validation (python -m igm_tpu_torch.train)")
        imgs = model.sample(args.n, generator, **kwargs)
        n_show = args.n
    grid = get_grid_images(imgs.float().cpu().numpy(), model, nimgs=n_show)
    save_image_grid(grid, args.out)
    print(f"wrote {args.out} ({n_show} images)")
    return imgs


if __name__ == "__main__":
    sample_main()
