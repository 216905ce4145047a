"""Command lines: counterparts of ``igm_tpu/cli.py`` ``train_main`` (one
run; multirun and sweeps wait) and ``sample_main``.

    python -m igm_tpu_torch.train experiment=ddpm/cifar10 [overrides] \\
        [--device cpu]

composes the config, changes into the run directory ``hydra.run.dir``
(``logs/runs/<exp_name>``, where checkpoints, ``results/*.jpg`` and the
TensorBoard files go) and trains (``igm_tpu_torch.train.train``).

    python -m igm_tpu_torch.cli experiment=ddpm/cifar10 --weights w.pt \\
        [--n 64] [--seed 0] [--out samples.png] [--sampler ddim] [--steps 50] \\
        [--device cpu]

Composes the config, instantiates the port's model on the card (or on the
device ``--device`` names), loads the weights, runs the ancestral sampler
(or ``--sampler ddim``), and writes a grid image.  ``--weights`` takes a
``torch.save``d state_dict of the denoiser or an ``.npz`` of ``igm_tpu``
denoiser param leaves keyed by their ``/``-joined path (converted through
``igm_tpu_torch.interop``).  Without ``--weights`` the weights are a seeded
random init, and the CLI says so.

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
    args = parser.parse_args(argv)
    if any(o in ("-m", "--multirun") for o in args.overrides):
        raise SystemExit("multirun and sweeps are not ported yet: one run per call")

    from .config import compose, select, to_plain
    from .train import train
    from .utils.platform import resolve_device

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def sample_main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.cli")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides (experiment=...)")
    parser.add_argument("--weights", default=None,
                        help="denoiser weights: a torch state_dict file, or an "
                             ".npz of igm_tpu param leaves by '/'-joined path")
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--out", default="samples.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sampler", default=None, choices=["ddim"],
                        help="fast sampler instead of the ancestral chain")
    parser.add_argument("--steps", type=int, default=None,
                        help="fast-sampler step count (default: config)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from .callbacks.visualization import get_grid_images, save_image_grid
    from .config import compose, instantiate
    from .utils.platform import resolve_device

    device = resolve_device(args.device)
    # float32 matmuls and convs in full float32, never TF32; the bfloat16
    # compute path does not read these flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = compose(config_dir(), [*args.overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    if args.weights:
        load_weights(model.modules["denoise"], args.weights)
    else:
        model.init_params(args.seed)
        print(f"no --weights: random init from seed {args.seed}")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.sampler == "ddim":
        steps = args.steps or int(model.hparams.ddim_steps)
        imgs = torch.clamp(model.ddim_sample(args.n, steps=steps,
                                             generator=generator), -1.0, 1.0)
    else:
        imgs = model.sample(args.n, generator)
    grid = get_grid_images(imgs.float().cpu().numpy(), model, nimgs=args.n)
    save_image_grid(grid, args.out)
    print(f"wrote {args.out} ({args.n} images)")


if __name__ == "__main__":
    sample_main()
