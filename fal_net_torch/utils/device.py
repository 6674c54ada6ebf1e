"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never fall back to it.  A model's conv weights are
held in the storage its fp32 convs compute in there (:func:`place`)."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn


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


def place(module: nn.Module, device: Union[str, torch.device]) -> nn.Module:
    """``module`` moved to ``device`` in place (``nn.Module.to``), its 4-D
    weights in channels-last storage on the card, where cuDNN's NHWC
    kernels read them with no transposes, and NCHW elsewhere
    (models/layers.py)."""
    device = torch.device(device)
    return module.to(device, memory_format=torch.channels_last if device.type == "cuda" else torch.contiguous_format)
