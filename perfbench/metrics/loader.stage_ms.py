"""Milliseconds the prefetch worker takes to stage one chunk: the program's
span ``loader.stage`` (``igm_tpu_torch/core/trace.py``; ``data/loader.py``:
the tensors, the pin and the enqueued copy to the card), its total over its
count.

The registry covers the process's life, set-up included: the window's steps (about
1,700 on ``unet.train``, 500 on ``moe_dit.train``, 350 on ``moe_dit.train_dp4``) dominate it;
the set-up adds fewer than 10 steps and the profiled steps after the window 7-36.  On
four cards, rank 0's process.  None where the program has no such registry or record."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    s = trace.spans().get("loader.stage")
    return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None
