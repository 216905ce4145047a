"""Device selection and numerics for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device.

    With no request and no card this raises; the port never carries on on
    the CPU unless asked to.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def set_numerics() -> None:
    """What the entry points run with on the card: float32 products and
    convolutions in full float32 (no TF32), and cuDNN's deterministic
    algorithms.  Some of cuDNN's weight-gradient algorithms add in an order
    that changes from run to run (the flagship UNet's last 1x1 conv at
    batch 256, the VQ-VAE decoder's convs); with them no two runs of a
    train step, eager or graphed, agree bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
