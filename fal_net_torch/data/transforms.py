"""Image normalization of the serving path (counterpart of the serving part
of fal_net_tpu/data/transforms.py): /255, minus the channel mean, std 1."""

from __future__ import annotations

import numpy as np
import torch

RGB_MEAN = np.asarray([0.411, 0.432, 0.45], np.float32)


def normalize(image: np.ndarray) -> np.ndarray:
    """0..255 HWC -> normalized float32 HWC, on the host."""
    return (np.asarray(image, np.float32) / 255.0) - RGB_MEAN


def normalize_device(image: torch.Tensor) -> torch.Tensor:
    """uint8 NCHW tensor -> normalized float32 NCHW on the tensor's device:
    the same recipe as :func:`normalize`, so a raw uint8 upload (4x fewer
    host-to-device bytes) gives the same input."""
    mean = torch.as_tensor(RGB_MEAN, device=image.device).view(1, -1, 1, 1)
    return image.to(torch.float32) / 255.0 - mean
