"""Standalone FID of a model's samples against its validation split: the
port's counterpart of ``tools/eval_fid.py``.

    python -m igm_tpu_torch.tools.eval_fid experiment=ddpm/cifar10 \\
        (--ckpt logs/runs/ddpm/cifar10/checkpoints | --weights w.pt|w.npz) \\
        [--n 5000] [--batch 64] [--sampler ancestral|ddim|default] [--seed 0] \\
        [--stats-dir logs/fid_stats] [--device cpu]

Prints one JSON line {"fid", "backend", "real_stats", "n_real", "n_fake"}.
The weights load as ``python -m igm_tpu_torch.cli`` loads them
(``cli.load_model``).  Features come from ``callbacks/fid.py`` on the
model's device: InceptionV3 when ``IGM_INCEPTION_WEIGHTS`` names its
weights, else the port's random conv net (``random_torch``: ranks models,
but its distances are neither Inception's nor ``igm_tpu``'s random net's).
Fakes are drawn ``--batch`` at a time (``ddim``: DDIM at its default steps,
where the model has it; otherwise the model's own sampler) from one
``torch.Generator(device).manual_seed(seed)``, until ``--n``.

The real split's statistics are cached in ``--stats-dir`` (default
``logs/fid_stats`` under the current directory; '' turns the cache off),
keyed by the backend's name, the datamodule, the image geometry and the
image count, so a cache of ``igm_tpu``'s (backend ``random``) never feeds
the port.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.eval_fid")
    parser.add_argument("overrides", nargs="*", help="config overrides (experiment=...)")
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--ckpt", default=None,
                         help="a directory of the port's checkpoints")
    weights.add_argument("--weights", default=None,
                         help="the network's weights, as python -m igm_tpu_torch.cli "
                              "takes them")
    parser.add_argument("--n", type=int, default=5000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--sampler", default="ancestral",
                        choices=["ancestral", "ddim", "default"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stats-dir", default="logs/fid_stats",
                        help="disk cache of the real split's feature statistics "
                             "('' turns it off)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_intermixed_args(argv)

    from ..callbacks.evaluation import to_uint8
    from ..callbacks.fid import FeatureStats, frechet_distance, get_feature_backend
    from ..cli import config_dir, load_model
    from ..config import compose, instantiate
    from ..utils.platform import resolve_device, set_numerics

    device = resolve_device(args.device)
    set_numerics()
    cfg = compose(config_dir(), [*args.overrides, "print_config=False"])
    datamodule = instantiate(cfg.datamodule)
    datamodule.prepare_data()
    datamodule.setup()
    model = load_model(cfg, device, args.ckpt, args.weights, args.seed)

    fe, dim, backend = get_feature_backend(device=device)
    real_stats, fake_stats = FeatureStats(dim), FeatureStats(dim)

    imgs, _ = datamodule.val_arrays()
    n_real = min(args.n, len(imgs))
    real_src = "computed"
    cache_path = None
    if args.stats_dir:
        h, w, c = imgs.shape[1:4]
        key = f"{backend}_{type(datamodule).__name__}_{h}x{w}x{c}_n{n_real}"
        cache_path = Path(args.stats_dir) / f"{key}.npz"
    if cache_path is not None and cache_path.exists():
        with np.load(cache_path) as z:
            real_mu, real_sigma, real_n = z["mu"], z["sigma"], int(z["n"])
        real_src = "cached"
    else:
        for i in range(0, n_real, args.batch):
            real_stats.update(fe(imgs[i:i + args.batch]))
        real_mu, real_sigma = real_stats.finalize()
        real_n = real_stats.n
        if cache_path is not None:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache_path, mu=real_mu, sigma=real_sigma, n=real_n)

    if args.sampler == "ddim" and hasattr(model, "ddim_sample"):
        def sample(g):
            return model.ddim_sample(args.batch, generator=g)
    else:
        def sample(g):
            return model.sample(args.batch, g)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    done = 0
    while done < args.n:
        fake_stats.update(fe(to_uint8(sample(generator), model.input_normalize, device)))
        done += args.batch

    fid = frechet_distance(real_mu, real_sigma, *fake_stats.finalize())
    result = {"fid": round(fid, 4), "backend": backend, "real_stats": real_src,
              "n_real": real_n, "n_fake": fake_stats.n}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
