#!/usr/bin/env python
"""Convert an igm_tpu (orbax) checkpoint into one .npz the PyTorch port reads.

    python tools/igm_tpu_ckpt_to_npz.py logs/runs/ddpm/mnist/checkpoints out.npz [--step N]

Runs beside igm_tpu and orbax: restores checkpoint ``step`` (default the
newest) without a template (``CheckpointManager.restore_raw``) and writes

- ``format``: the tag ``igm_tpu-checkpoint-npz/1``;
- ``step``: the train step;
- ``params/<module>/<path>``: every parameter leaf;
- ``mutables/<module>/<path>``: every mutable collection leaf (BatchNorm
  statistics, the EMA codebook, the latent scale);
- ``ema/<path>``: the EMA shadow of the denoiser (``opt_states["ema"]``),
  where the run kept one;

keys ``/``-joined, values numpy arrays.  The optimizer states and the PRNG
key are left out: the port samples from the file and splices it
(``--ckpt``, ``model.first_stage_ckpt``, ``model.teacher_ckpt``), and a run
cannot be resumed from it.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FORMAT = "igm_tpu-checkpoint-npz/1"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def convert(ckpt_dir: str, out: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Write checkpoint ``step`` of ``ckpt_dir`` to ``out``; returns the arrays."""
    from igm_tpu.core.checkpoint import CheckpointManager

    manager = CheckpointManager(str(ckpt_dir))
    try:
        raw = manager.restore_raw(step)
    finally:
        manager.close()
    arrays: Dict[str, np.ndarray] = {"format": np.asarray(FORMAT),
                                     "step": np.asarray(int(np.asarray(raw["step"])))}
    _flatten(raw.get("params", {}), "params", arrays)
    _flatten(raw.get("mutables", {}), "mutables", arrays)
    ema = (raw.get("opt_states") or {}).get("ema")
    if ema:
        _flatten(ema, "ema", arrays)
    np.savez(out, **arrays)
    return arrays


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir", help="igm_tpu's checkpoint directory (orbax)")
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--step", type=int, default=None, help="default: the newest")
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        raise SystemExit("the output must be an .npz (the port tells converted files "
                         "by that suffix)")

    from igm_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    arrays = convert(args.ckpt_dir, args.out, args.step)
    print(f"wrote {args.out}: step {int(arrays['step'])}, "
          f"{sum(k.startswith('params/') for k in arrays)} params, "
          f"{sum(k.startswith('mutables/') for k in arrays)} mutables, "
          f"{sum(k.startswith('ema/') for k in arrays)} EMA leaves")


if __name__ == "__main__":
    main()
