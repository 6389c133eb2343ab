"""Device resolution shared by the port's entry points: they run on the card
unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for a name; asking for CUDA without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA GPU is "
                           "available (pass device='cpu' to run on the CPU)")
    return device
