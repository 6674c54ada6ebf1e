"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never fall back to it."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device without a usable card
    raises instead of building or running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "fal_net_torch runs on the GPU unless the caller asks for the CPU "
            "(device='cpu', or --device cpu on the command line)"
        )
    return device
