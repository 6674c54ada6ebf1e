"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never fall back to it.  A model's conv weights are
held in the storage its fp32 convs compute in there (:func:`place`), and
the constants of a forward are made on the device once
(:func:`device_constant`)."""

from __future__ import annotations

import functools
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


def device_constant(make):
    """``make(*key)``, a tensor, cached by its hashable arguments (the device
    among them) and read-only: the serving path and the trainer pass the
    same bounds and constants with every batch, so there is no host copy
    (and no wait) a call, and a CUDA graph's capture, which takes no copy
    from pageable host memory, finds them on the device.  Made outside
    inference mode, since later calls may run outside it, and outside any
    tracing mode, so that a trace (``torch.export``) finds a real tensor,
    which it lifts as a constant, and never leaves a fake one in the
    cache."""

    @functools.lru_cache(maxsize=64)
    @functools.wraps(make)
    def cached(*key):
        from torch.utils._python_dispatch import _disable_current_modes

        with torch.inference_mode(False), _disable_current_modes():
            return make(*key)

    return cached
