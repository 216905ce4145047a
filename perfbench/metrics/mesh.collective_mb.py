"""Megabytes a step of collectives on rank 0: the program's work counter
``mesh.collective_bytes`` (``igm_tpu_torch/core/trace.py``;
``parallel/mesh.py``: each collective's whole buffer on the rank, an
all-reduce's tensor, an all-gather's output; a replayed graph counts what
it captured) over the counter ``train.steps``, in units of 1e6 bytes.

The registry covers the process's life, set-up included: the window's steps (about
1,700 on ``unet.train``, 500 on ``moe_dit.train``, 350 on ``moe_dit.train_dp4``) dominate it;
the set-up adds fewer than 10 steps and the profiled steps after the window 7-36.  On
four cards, rank 0's process.  None where the program has no such registry or record."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    counts = trace.counters()
    moved, steps = counts.get("mesh.collective_bytes"), counts.get("train.steps")
    return moved / steps / 1e6 if moved and steps else None
