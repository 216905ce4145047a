"""The card's idle share in the profiled part of the serving window (the
arrivals keep coming; the device waits for requests and for the host)."""
from perfbench.harness.device import idle


def read(r: dict):
    return idle(r)
