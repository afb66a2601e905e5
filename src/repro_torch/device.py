"""Where an entry point runs."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """The device an entry point was asked to run on.  Asking for the card
    where there is none raises: nothing continues on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev
