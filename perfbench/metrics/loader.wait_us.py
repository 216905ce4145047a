"""Microseconds a step the training loop waits on the prefetcher's queue:
the program's span ``loader.wait`` (``igm_tpu_torch/core/trace.py``;
``data/loader.py``), its total over the counter ``train.steps``.  The
inside of ``trainer.data_wait_us``, without the epoch's end.

The registry covers the process's life, set-up included: the window's steps (about
1,700 on ``unet.train``, 500 on ``moe_dit.train``, 350 on ``moe_dit.train_dp4``) dominate it;
the set-up adds fewer than 10 steps and the profiled steps after the window 7-36.  On
four cards, rank 0's process.  None where the program has no such registry or record."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    s = trace.spans().get("loader.wait")
    steps = trace.counters().get("train.steps")
    return 1e6 * s["total_s"] / steps if s and steps else None
