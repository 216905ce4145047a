"""Tiny CPU versions of the benchmark's cells for the tests: the program's
plain kernel versions on the CPU, the configurations' widths cut so a run
takes seconds."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import bench  # noqa: E402
from perfbench.harness.weights import boot_clock  # noqa: E402

SIZES = {
    "ddpm_cifar10_unet": ({"hidden_dim": 8, "dim_mults": [1, 2]}, {"width": 16, "height": 16}),
    "ddpm_cifar10_dit_moe8": ({"hidden_dim": 32, "depth": 2, "heads": 2, "moe_experts": 4},
                              {"width": 8, "height": 8}),
}
PARAMS = {"train": {"batch_size": 8, "train_images": 64},
          "serve": {"n": 2, "steps": 3, "rate_per_s": 16.0, "checked_requests": 2,
                    "trace_seconds": 0.5}}


def tiny_config(cfg: dict) -> tuple:
    """A configuration cut to the tiny sizes, and the experiment overrides
    that give the program the same."""
    cfg = copy.deepcopy(cfg)
    model, data = SIZES[cfg["name"]]
    cfg["model"].update(model)
    cfg["data"].update(data)
    overrides = [f"model.{k}={json.dumps(v).replace(' ', '')}" for k, v in model.items()
                 if k != "moe_experts"]
    overrides += [f"datamodule.width={data['width']}", f"datamodule.height={data['height']}"]
    cfg["experiment"] = [f"+model.moe_experts={model['moe_experts']}"
                         if e.startswith("+model.moe_experts") else e for e in cfg["experiment"]]
    return cfg, overrides


def context(name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5, trace: int = 0,
            cell: dict | None = None) -> dict:
    cell = copy.deepcopy(cell or bench.workload(name))
    cfg, overrides = tiny_config(bench.config(cell["config"]))
    mix = bench.traffic(cell["traffic"])
    mix.update(PARAMS[mix["generator"]])
    return {"cell": cell, "config": cfg, "mix": mix, "seed": seed, "seconds": seconds,
            "trace": trace, "device": "cpu", "started": boot_clock(), "overrides": overrides}


def run(ctx: dict) -> dict:
    return bench.generator(ctx["mix"]["generator"]).run(ctx)
