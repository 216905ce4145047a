"""Score a class-conditional generator: does asking for class y give y?
The port's counterpart of ``tools/score_conditional.py``.

    python -m igm_tpu_torch.tools.score_conditional experiment=ddpm/cond_mnist \\
        (--ckpt DIR|x.npz | --weights w.pt) [--per-class 16] [--guidance 2.0] \\
        [--seed 0] [--out scores.json] [--cache-dir data] [--device cpu]

Draws ``per_class`` images of every class with the model's guidance-aware
sampler (the DDPM family: the ancestral chain, ``p_sample_loop``, whose
guidance doubles the batch inside each forward; flow matching: the ODE,
``ode_sample``; a latent model decodes its latents first), classifies them
with the offline digit classifier (``utils/digit_score.py``) and prints one
JSON line: ``experiment``, ``guidance``, ``per_class_n``,
``conditional_accuracy`` (the classifier's argmax equals the label asked
for), ``per_class_accuracy``, ``mean_confidence`` and the checkpoint's
``step``.  ``--ckpt`` and ``--weights`` load the model as the sampling CLI
does (``cli.load_model``); ``--guidance`` overrides the config's
``guidance_scale``.  The labels are ``repeat(arange(n_classes), k)``; the
draws come from a ``torch.Generator`` seeded with ``--seed`` on the
model's device, not from ``igm_tpu``'s JAX keys.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch


def conditional_scores(probs: np.ndarray, labels: np.ndarray,
                       n_classes: int) -> Dict[str, object]:
    """The classifier's p(y|x) of images drawn for ``labels``:
    conditional accuracy, accuracy per class, mean confidence."""
    pred = probs.argmax(-1)
    want = np.asarray(labels)
    return {
        "conditional_accuracy": float((pred == want).mean()),
        "per_class_accuracy": {int(c): float((pred[want == c] == c).mean())
                               for c in range(n_classes)},
        "mean_confidence": float(probs.max(-1).mean()),
    }


@torch.no_grad()
def draw(model, labels: torch.Tensor, guidance: float,
         generator: torch.Generator) -> torch.Tensor:
    """One image a label from the model's guidance-aware sampler, decoded
    where the sampler works in a latent space, clipped to [-1, 1]."""
    n = labels.shape[0]
    if hasattr(model, "p_sample_loop"):        # the DDPM family (ancestral)
        imgs = model.p_sample_loop(model._sample_shape(n), generator, y=labels,
                                   guidance=guidance)
    elif hasattr(model, "ode_sample"):         # flow matching (the ODE)
        imgs = model.ode_sample(n, y=labels, guidance=guidance, generator=generator)
    else:
        raise SystemExit(f"{type(model).__name__} has no guidance-aware "
                         "sampler (p_sample_loop / ode_sample)")
    if hasattr(model, "decode") and tuple(imgs.shape[1:3]) != (model.height, model.width):
        imgs = model.decode(imgs)
    return torch.clamp(imgs, -1.0, 1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.score_conditional")
    ap.add_argument("overrides", nargs="*")
    weights = ap.add_mutually_exclusive_group(required=True)
    weights.add_argument("--ckpt", default=None,
                         help="a directory of the port's checkpoints, or a converted "
                              "igm_tpu checkpoint (.npz)")
    weights.add_argument("--weights", default=None,
                         help="the network's weights, as the sampling CLI takes them")
    ap.add_argument("--per-class", type=int, default=16)
    ap.add_argument("--guidance", type=float, default=None,
                    help="override the config's guidance_scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--cache-dir", default="data", help="the digit classifier's cache")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_intermixed_args(argv)

    from ..cli import config_dir, load_model
    from ..config import compose
    from ..utils import digit_score
    from ..utils.platform import resolve_device, set_numerics

    device = resolve_device(args.device)
    set_numerics()
    cfg = compose(config_dir(), [*args.overrides, "print_config=False"])
    model = load_model(cfg, device, args.ckpt, args.weights, args.seed)
    if not getattr(model, "num_classes", 0):
        raise SystemExit(f"{type(model).__name__} is not class-conditional")
    n_cls, k = int(model.num_classes), int(args.per_class)
    labels = torch.arange(n_cls, device=device).repeat_interleave(k)
    guidance = (float(args.guidance) if args.guidance is not None
                else float(model.hparams.guidance_scale))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    imgs = draw(model, labels, guidance, generator).float().cpu().numpy()

    clf = digit_score.load_or_train(args.cache_dir, model.height, model.width, device)
    scores = {
        "experiment": next((o.split("=", 1)[1] for o in args.overrides
                            if o.startswith("experiment=")), None),
        "guidance": guidance,
        "per_class_n": k,
        **conditional_scores(digit_score.class_probs(clf, imgs), labels.cpu().numpy(),
                             n_cls),
        "step": int(model.state.step) if model.state is not None else 0,
    }
    line = json.dumps(scores)
    print(line)
    if args.out:
        Path(args.out).write_text(line)
    return scores


if __name__ == "__main__":
    main()
