"""A run's result and its last lines: the numbers compared beside their
limits on standard error, then one JSON object on standard output."""
from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List, Optional

#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package, compared whole (``igm_tpu_torch`` is not
#: ``igm_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "igm_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number with its limit; a missing number reads as
    infinite."""
    return {k: {"value": float(values.get(k, float("inf"))), "limit": float(limits[k])}
            for k in limits}


def passed(compared: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
         device: dict, compared: Dict[str, dict], breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return json.dumps(out)


def emit(result: dict) -> int:
    """Print ``result`` (``line``'s keywords) unless a forbidden module is
    loaded in this process, or was in the rank that ran the window
    (``result["forbidden"]``); returns the exit code."""
    result = dict(result)
    found = sorted(set(forbidden_modules()) | set(result.pop("forbidden", [])))
    if found:
        print(f"refused: {', '.join(found)} loaded in the process", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(line(**result), flush=True)
    return 0


def result(ctx: dict, r: dict) -> dict:
    """A run's result (``line``'s keywords) from a generator's readings
    ``r``: the end-to-end metrics (``--trace 0``) or the per-layer ones,
    each read by its metric's reader (``--trace 1``), the device, and the
    numbers compared."""
    import numpy as np
    import torch

    from perfbench.harness import bench
    from perfbench.harness.device import breakdown

    bmk = bench.benchmark()
    cell = ctx["cell"]
    cuda = torch.device(r["device"]).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(r["device"]) if cuda else "cpu",
              "count": r["world"], "memory_peak_bytes": int(r["peak"])}
    metrics = {}
    extra = None
    if not ctx["trace"]:
        units = bench.units(bench.end_to_end(bmk, cell["name"]))
        values = {"setup_s": r["setup_s"], **r["e2e"]}
        metrics = {k: (values[k], units[k]) for k in units if k in values}
    else:
        summaries = r["summaries"]
        if summaries:
            device["busy_s"] = float(np.mean([s["busy_s"] for s in summaries]))
            device["window_s"] = float(np.mean([s["window_s"] for s in summaries]))
            extra = breakdown(summaries[0])
        read = {**r, "summary": summaries[0] if summaries else None,
                "summaries": summaries, "config": ctx["config"], "cell": cell}
        for m in bench.per_layer(bmk, cell["name"]):
            value = bench.metric_reader(m["name"]).read(read)
            if value is not None:
                metrics[m["name"]] = (float(value), m["unit"])
    return dict(correct=passed(r["compared"]), attempted=r["attempted"],
                failed=r["failed"], metrics=metrics, device=device,
                compared=r["compared"], breakdown=extra, forbidden=forbidden_modules())
