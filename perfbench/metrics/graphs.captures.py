"""CUDA graphs captured: the program's counter ``graphs.captures``
(``igm_tpu_torch/core/trace.py``; ``core/graphs.py`` ``StepGraph``),
each a warm-up and a capture in the set-up (``auto``'s probe, the first
chunk).  None where the program has no such counter.  On four cards, rank
0's process."""


def read(r: dict):
    try:
        from igm_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.counters().get("graphs.captures")
