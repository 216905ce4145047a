"""Run one cell of the benchmark of ``igm_tpu_torch`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's workload file (``perfbench/workloads/<cell>.json``) names its
configuration (``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<mix>.json``, the parameters of the generator it
names, ``perfbench/generators/<generator>.py``) and the chips it needs.  The run sets
up, measures for ``--seconds``, checks what the timed path produced
against the configuration's plain reference (``perfbench/reference/``),
and prints the numbers compared beside their limits on standard error and
one JSON line on standard output: ``--trace 0`` the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (each read by
``perfbench/metrics/<metric>.py``) and the device's busy time in a
profiled part of the window.  Without enough CUDA cards it prints no
result and exits with 2.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "perfbench" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args: argparse.Namespace, device: str, started: float) -> dict:
    """What a traffic kind's ``run`` takes: the cell, its configuration,
    the run's arguments, the device and the process's start on the boot
    clock."""
    from perfbench.harness import bench
    cell = bench.workload(args.workload)
    return {"cell": cell, "config": bench.config(cell["config"]),
            "mix": bench.traffic(cell["traffic"]), "seed": args.seed,
            "seconds": args.seconds, "trace": args.trace, "device": device,
            "started": started}


def main(argv=None) -> int:
    _caches()
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.weights import boot_clock, process_age_s
    started = boot_clock() - process_age_s()
    args = parse(argv)
    from perfbench.harness import bench, report
    cell = bench.workload(args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    ctx = context(args, "cuda", started)
    result = bench.generator(ctx["mix"]["generator"]).run(ctx)
    return report.emit(result)


if __name__ == "__main__":
    sys.exit(main())
