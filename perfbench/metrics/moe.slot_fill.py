"""Per cent of the expert slots a rank computes (E times the capacity of the
global batch) that its kept tokens fill: the program's device counter
``moe.tokens`` (``igm_tpu_torch/core/trace.py``; ``networks/moe.py``:
routed, kept, slots, added inside the step's graph by every Switch-MoE
block), kept over slots.  The inside of ``moe.slot_occupancy``.

The registry covers the process's life, set-up included: the window's steps (about
1,700 on ``unet.train``, 500 on ``moe_dit.train``, 350 on ``moe_dit.train_dp4``) dominate it;
the set-up adds fewer than 10 steps and the profiled steps after the window 7-36.  On
four cards, rank 0's process.  None where the program has no such registry or record."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    tokens = trace.counters().get("moe.tokens")
    return 100.0 * tokens[1] / tokens[2] if tokens and tokens[2] else None
