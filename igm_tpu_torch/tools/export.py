"""Export a sampler as a serving artifact, or run one: the port's counterpart
of ``tools/export.py``.

    # export (the weights as python -m igm_tpu_torch.cli loads them)
    python -m igm_tpu_torch.tools.export experiment=vae/mnist_mlp \\
        [--ckpt DIR | --weights w.pt|w.npz] [--n 64] [--out sampler.pt] [--device cpu]

    # diffusion serving with a fast sampler (20 network calls, not 1000)
    python -m igm_tpu_torch.tools.export experiment=ddpm/cifar10 --weights w.npz \\
        --sampler dpm --steps 20 --out ddpm.pt

    # run the artifact (no config tree, no data files)
    python -m igm_tpu_torch.tools.export --run ddpm.pt --seed 3 [--out grid.png]

``--sampler`` picks ``default`` (the model's own sampler) or
``<sampler>_sample`` (ddim, dpm: the DDPM family; heun: EDM; multistep:
consistency, ``--steps 1`` one network call; pc, ode: score-SDE), at
``--steps`` or the config's step count, exactly as ``python -m
igm_tpu_torch.cli --sampler`` resolves it (``cli.sampler_call``); a sampler
the model lacks, and MADE's and PixelCNN's missing default, exit with the
CLI's message.  Without ``--ckpt`` or ``--weights`` the export holds a
random init from ``--seed``, and says so.

The artifact ``<out>`` is one ``torch.save``d dict of plain types and
tensors (``torch.load(..., weights_only=True)`` reads it): the format tag,
the composed ``model`` and ``datamodule`` configs, every module's state
(for latent DDPM the first stage, the codebook and the calibrated latent
scale among them), the EMA shadow when the model keeps one, ``n``,
``sampler``, ``steps`` and the trained ``step``.  ``<out>.json`` holds
``model``, ``experiment``, ``n``, ``sampler``, ``steps``, ``out_shape``
(from one draw at export) and ``step``.  Loading rebuilds the model from
the stored config with the port's model code and loads the state: a hand
kernel is a launch through ``ctypes``, which no serialized program carries,
so there is no traced program (``igm_tpu``'s is a StableHLO module) and no
``--platforms``.  ``--run`` draws one batch from ``torch.Generator(device)
.manual_seed(seed)``: the images ``python -m igm_tpu_torch.cli`` draws with
the same weights, sampler, steps, n and seed on that device, bit for bit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable

import torch

FORMAT = "igm_tpu_torch.sampler/1"


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def export(overrides, out: str, n: int = 64, sampler: str = "default",
           steps: int | None = None, ckpt: str | None = None,
           weights: str | None = None, seed: int = 0, device=None) -> dict:
    """Write the artifact of ``overrides``' model and its ``.json``; returns
    the metadata."""
    from ..cli import config_dir, load_model, sampler_call
    from ..config import compose, to_plain
    from ..utils.platform import resolve_device, set_numerics

    device = resolve_device(device)
    set_numerics()
    cfg = compose(config_dir(), [*overrides, "print_config=False"])
    model = load_model(cfg, device, ckpt, weights, seed)
    if not (ckpt or weights):
        print("WARNING: no --ckpt or --weights given - exporting UNTRAINED init params",
              file=sys.stderr)
    draw, steps = sampler_call(model, None if sampler == "default" else sampler, steps)
    step = int(model.state.step) if model.state is not None else 0
    ema = model.ema_shadow()
    artifact = {
        "format": FORMAT,
        "config": {"model": to_plain(cfg.model), "datamodule": to_plain(cfg.datamodule)},
        "params": _host(model.modules.state_dict()),
        "ema": None if ema is None else _host(ema),
        "n": int(n), "sampler": sampler, "steps": steps, "step": step,
    }
    # one eager draw gives the output's shape (and shows the sampler runs)
    model.use_graphs = False
    imgs = draw(int(n), torch.Generator(device=device).manual_seed(seed))
    out = Path(out)
    torch.save(artifact, out)
    meta = {
        "model": str(cfg.model.get("_target_", "?")),
        "experiment": next((o.split("=", 1)[1] for o in overrides
                            if o.startswith("experiment=")), None),
        "n": int(n), "sampler": sampler, "steps": steps,
        "out_shape": [list(imgs.shape)], "step": step,
    }
    Path(str(out) + ".json").write_text(json.dumps(meta, indent=1))
    print(f"wrote {out} ({out.stat().st_size / 1e6:.2f} MB, sampler={sampler}, n={n}, "
          f"trained step {step})")
    return meta


def load_sampler(path: str, device=None) -> tuple[Callable[[int], torch.Tensor], object, dict]:
    """``(draw, model, artifact)`` of the artifact at ``path`` on ``device``
    (default: the card): ``draw(seed)`` is one batch of its sampler from
    ``torch.Generator(device).manual_seed(seed)``."""
    from ..cli import sampler_call
    from ..config import instantiate, to_node
    from ..core.state import TrainState
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    artifact = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(artifact, dict) or artifact.get("format") != FORMAT:
        raise ValueError(f"{path} is not a sampler artifact of this package ({FORMAT})")
    cfg = to_node(artifact["config"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device=device)
    model.modules.load_state_dict(artifact["params"], strict=True)
    ema = artifact["ema"]
    # what the samplers read of a train state: the EMA shadow
    model.state = TrainState(
        modules=model.modules,
        opt_states={} if ema is None else {"ema": {k: v.to(device) for k, v in ema.items()}},
        generator=torch.Generator(device=device), step=int(artifact["step"]))
    sampler = artifact["sampler"]
    call, _ = sampler_call(model, None if sampler == "default" else sampler,
                           artifact["steps"])
    n = int(artifact["n"])

    def draw(seed: int) -> torch.Tensor:
        return call(n, torch.Generator(device=device).manual_seed(int(seed)))

    return draw, model, artifact


def run(path: str, seed: int = 0, out: str | None = None, device=None) -> torch.Tensor:
    """One batch of the artifact's sampler at ``seed`` (and its grid to
    ``out``); returns the images on the device."""
    from ..callbacks.visualization import get_grid_images, save_image_grid
    from ..utils.platform import set_numerics

    set_numerics()
    draw, model, _ = load_sampler(path, device)
    imgs = draw(seed)
    host = imgs.float().cpu().numpy()
    print(f"ran {path}: output {host.shape} {host.dtype} "
          f"range [{host.min():.3f}, {host.max():.3f}]")
    if out:
        save_image_grid(get_grid_images(host, model, nimgs=len(host)), out)
        print(f"wrote {out}")
    return imgs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.export")
    parser.add_argument("overrides", nargs="*", help="config overrides (experiment=...)")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", default=None,
                         help="a directory of the port's checkpoints: every module and "
                              "the EMA shadow from the newest")
    weights.add_argument("--weights", default=None,
                         help="the network's weights, as python -m igm_tpu_torch.cli "
                              "takes them: a torch state_dict file, or an .npz of "
                              "igm_tpu param leaves by '/'-joined path")
    parser.add_argument("--n", type=int, default=64, help="serving batch")
    parser.add_argument("--sampler", default="default",
                        choices=["default", "ddim", "dpm", "heun", "multistep", "pc", "ode"],
                        help="the model's own sampler, or ddim/dpm (DDPM family), heun "
                             "(EDM), multistep (consistency; --steps 1 = one network "
                             "call), pc/ode (score-SDE)")
    parser.add_argument("--steps", type=int, default=None,
                        help="fast-sampler step count (default: config)")
    parser.add_argument("--out", default=None,
                        help="the artifact (default sampler.pt); with --run, a grid PNG")
    parser.add_argument("--run", default=None, help="an artifact to run instead")
    parser.add_argument("--seed", type=int, default=0,
                        help="--run: the request's seed; export: the random init's")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_intermixed_args(argv)
    if args.run:
        run(args.run, args.seed, args.out, args.device)
    else:
        export(args.overrides, args.out or "sampler.pt", args.n, args.sampler, args.steps,
               args.ckpt, args.weights, args.seed, args.device)


if __name__ == "__main__":
    main()
