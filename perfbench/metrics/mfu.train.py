"""Model FLOPs utilisation of a train step: the configuration's training
FLOPs (three forward passes an image) of the images a card trained in the
window, over the window's time and the card's dense bf16 peak."""
from perfbench.harness.device import mfu


def read(r: dict):
    return mfu(r)
