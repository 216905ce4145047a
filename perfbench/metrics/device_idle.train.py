"""The card's idle share in the profiled steps after the window: the wall
time in which no kernel or copy ran, over the sub-window's wall time,
averaged over the cards."""
from perfbench.harness.device import idle


def read(r: dict):
    return idle(r)
