"""Times the kernels of two checkouts of this repository on one card, in
turns: the base, this tree, this tree, the base (a b b a).

    python -m igm_tpu_torch.tools.ab_kernels --base logs/parent \
        --phase parity_gn:bfloat16 --phase parity_la_bwd:bfloat16 [--batch 64]

``--base`` is another checkout (e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory).  Each run is a subprocess started in
its checkout's root that calls a parity phase of that checkout's
``chip_smoke.py`` (``--phase name:dtype``): ``phase(dtype)`` at the phase's
own batch, or ``phase(dtype, batch=B)`` with ``--batch B``, which this
tree's ``parity_gn``, ``parity_la`` and ``parity_la_bwd`` take (with the
seeds ``chip_smoke.py`` gives them there; a checkout whose phase takes no
batch fails).  So a run imports that checkout's ``igm_tpu_torch`` and
builds its kernels into that checkout's ``_build/``.  Prints the card's
name and power limit, then one JSON line per run and phase: the phase's
rows (shape, kernel_ms, plain_ms, bound_ms, max_abs_err) and its total
kernel time over the calls of one UNet pass (``kernel_ms`` times
``calls_per_forward``, summed).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = """
import json, sys, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kwargs = {"batch": int(sys.argv[1])} if sys.argv[1] else {}
for spec in sys.argv[2:]:
    name, dtype = spec.split(":")
    rows = getattr(c, name)(getattr(torch, dtype), **kwargs)
    print("AB " + json.dumps({"phase": spec, "rows": rows}), flush=True)
"""


def run(tree: Path, batch: int | None, phases: list[str]) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(batch or ""), *phases], cwd=tree,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return [json.loads(line[3:]) for line in proc.stdout.splitlines()
            if line.startswith("AB ")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other checkout's root")
    ap.add_argument("--phase", action="append", required=True,
                    help="a parity phase of chip_smoke.py and its dtype, e.g. parity_gn:bfloat16")
    ap.add_argument("--batch", type=int, default=None,
                    help="the phases' batch (default: their own, 256)")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    base = args.base.resolve()
    for i, (label, tree) in enumerate((("base", base), ("this", REPO), ("this", REPO),
                                       ("base", base))):
        for result in run(tree, args.batch, args.phase):
            rows = result["rows"]
            print(json.dumps({
                "run": i, "tree": label, "phase": result["phase"],
                "batch": rows[0]["shape"][0],
                "kernel_ms": sum(r["kernel_ms"] * r["calls_per_forward"] for r in rows),
                "rows": [{k: r.get(k) for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                                                "max_abs_err")} for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
