"""The forward hand kernels' share of their roofline while serving: the
GroupNorm+Mish and linear-attention launches' bounds at the serving batch
over their device times in the profiled part of the window."""
from perfbench.harness.device import roofline_share


def read(r: dict):
    s = r.get("summary")
    if s is None:
        return None
    return roofline_share(s, r["sizes"], r["kernel_batch"], ("gn", "la"))
