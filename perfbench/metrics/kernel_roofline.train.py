"""The hand kernels' share of their roofline in a train step: the sum of
the bounds of the GroupNorm+Mish and linear-attention launches, forward
and backward, at their shapes (the larger of bytes over 3.35 TB/s and
operations over the peak, ``perfbench/harness/device.py``), over the sum
of their device times in the profiled steps (rank 0's card)."""
from perfbench.harness.device import roofline_share


def read(r: dict):
    s = r.get("summary")
    if s is None:
        return None
    return roofline_share(s, r["sizes"], r["kernel_batch"], ("gn", "gn_bwd", "la", "la_bwd"))
