"""Microseconds a step of the host's own work in a dispatch: the program's
span ``train.step_n`` (``igm_tpu_torch/core/trace.py``; ``models/base.py``:
the learning-rate slots' fills, the copies into and out of the graph, the
launch) less its launches (``graphs.launch``) and its captures
(``graphs.capture``: the set-up's warm-ups and captures), over the counter
``train.steps``.

The registry covers the process's life, set-up included: the window's steps (about
1,700 on ``unet.train``, 500 on ``moe_dit.train``, 350 on ``moe_dit.train_dp4``) dominate it;
the set-up adds fewer than 10 steps and the profiled steps after the window 7-36.  On
four cards, rank 0's process.  None where the program has no such registry or record."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    spans = trace.spans()
    steps = trace.counters().get("train.steps")
    if "train.step_n" not in spans or "graphs.launch" not in spans or not steps:
        return None
    host = spans["train.step_n"]["total_s"] - spans["graphs.launch"]["total_s"]
    host -= spans.get("graphs.capture", {}).get("total_s", 0.0)
    return 1e6 * host / steps
