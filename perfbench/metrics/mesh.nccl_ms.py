"""Milliseconds a step of NCCL kernels on rank 0's card in the profiled
steps: the gradient all-reduce and the routing counts' all-gather inside
the graph.  Nothing on one card."""


def read(r: dict):
    s = r.get("summary")
    if s is None or r["world"] < 2:
        return None
    nccl = sum(v for k, v in s["kernels"].items() if "nccl" in k.lower())
    return 1e3 * nccl / s["steps"] if nccl > 0 else None
