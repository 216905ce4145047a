"""Score archived sample grids with the offline digit scorer: the port's
counterpart of ``tools/score_gallery.py``.

    python -m igm_tpu_torch.tools.score_gallery [--runs-dir benchmarks/real_runs] \\
        [--size 28] [--out-dir logs/digit_scores] [--cache-dir data] [--device cpu]

For every ``<runs-dir>/<family>/samples*.jpg`` grid it cuts the tiles back
out (``make_grid``'s layout, padding 2), scores them with the digit
classifier (``utils/digit_score.py``: mean confidence, coverage, digit
Inception score) and writes ``<out-dir>/<family>/digit_scores.json``: a
score per grid under ``grids`` when a family has several, and the newest
grid's scores at the top level.  It prints the table.  Only grids of the
``--size`` geometry are scored (the classifier is a digit classifier); the
others are skipped.

The runs directory is only read: where ``igm_tpu``'s tool writes
``digit_scores.json`` into each family's directory, this one writes under
``--out-dir`` (default ``logs/digit_scores`` under the current directory).
The classifier's weights are trained on first use and cached in
``--cache-dir`` (``digit_classifier_torch_<h>x<w>.npz``).
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
PAD = 2


def untile(path: str, h: int, w: int, pad: int = PAD) -> np.ndarray:
    """The (N, h, w, 1) tiles of a grid image, in [-1, 1], row by row."""
    from PIL import Image

    g = np.asarray(Image.open(path).convert("L")).astype("float32")
    g = g / 127.5 - 1.0
    rows = (g.shape[0] - pad) // (h + pad)
    cols = (g.shape[1] - pad) // (w + pad)
    tiles = []
    for r in range(rows):
        for c in range(cols):
            y, x = pad + r * (h + pad), pad + c * (w + pad)
            tiles.append(g[y:y + h, x:x + w])
    return np.stack(tiles)[..., None]


def score_runs(runs_dir: Path, params, size: int) -> dict:
    """{family: scores} for every family directory of ``runs_dir`` whose
    grids have the ``size`` geometry."""
    from PIL import Image

    from ..utils.digit_score import score_samples

    table = {}
    for fam_dir in sorted(Path(runs_dir).iterdir()):
        grids = sorted(glob.glob(str(fam_dir / "samples*.jpg")))
        if not grids:
            continue
        gw, gh = Image.open(grids[-1]).size
        if (gw - PAD) % (size + PAD) or (gh - PAD) % (size + PAD):
            continue  # another geometry: another --size run
        per_grid = {}
        for g in grids:
            s = score_samples(params, untile(g, size, size))
            s["grid"] = Path(g).name
            per_grid[Path(g).name] = s
        out = dict(per_grid[Path(grids[-1]).name])
        if len(per_grid) > 1:
            out["grids"] = per_grid
        table[fam_dir.name] = out
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.score_gallery")
    ap.add_argument("--runs-dir", default=str(REPO / "benchmarks" / "real_runs"))
    ap.add_argument("--size", type=int, default=28)
    ap.add_argument("--out-dir", default="logs/digit_scores",
                    help="where <family>/digit_scores.json go (the runs are only read)")
    ap.add_argument("--cache-dir", default="data",
                    help="the classifier's weight cache")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..utils.digit_score import load_or_train
    from ..utils.platform import resolve_device, set_numerics

    device = resolve_device(args.device)
    set_numerics()
    params = load_or_train(args.cache_dir, args.size, args.size, device)
    table = score_runs(Path(args.runs_dir), params, args.size)
    for family, out in table.items():
        path = Path(args.out_dir) / family / "digit_scores.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    print(json.dumps(table, indent=1))
    return table


if __name__ == "__main__":
    main()
