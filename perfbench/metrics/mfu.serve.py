"""Model FLOPs utilisation of serving: the configuration's forward FLOPs of
every network call of the requests served (steps x batch a request), over
the time from the window's start to the last response and the card's
dense bf16 peak."""
from perfbench.harness.device import mfu


def read(r: dict):
    return mfu(r)
