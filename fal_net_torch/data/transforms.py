"""Image normalization and the stereo co-transforms of training
(counterpart of fal_net_tpu/data/transforms.py, reference
data_transforms.py).

The co-transforms run on the host in loader threads, on numpy arrays in the
0..255 domain, with randomness from an explicit ``numpy.random.Generator``:
the same draws in the same order as fal_net_tpu's, so the same seed gives
the same crops and gains in both packages.

Pipeline order used by the trainers (Train_Stage1_K.py:116-133):
  RandomResizeCrop -> RandomHorizontalFlip -> RandomGamma(0.8,1.2)
  -> RandomBrightness(0.5,2.0) -> RandomCBrightness(0.8,1.2)
  then normalize: /255, minus mean (0.411, 0.432, 0.45), std 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from fal_net_torch.utils.device import device_constant

RGB_MEAN = np.asarray([0.411, 0.432, 0.45], np.float32)

Arrays = List[np.ndarray]


def normalize(image: np.ndarray) -> np.ndarray:
    """0..255 HWC -> normalized float32 HWC, on the host."""
    return (np.asarray(image, np.float32) / 255.0) - RGB_MEAN


def denormalize(image: np.ndarray) -> np.ndarray:
    """The inverse of :func:`normalize`: float32 in 0..255, clipped."""
    return np.clip((np.asarray(image, np.float32) + RGB_MEAN) * 255.0, 0, 255)


@device_constant
def _device_mean(device) -> torch.Tensor:
    """:data:`RGB_MEAN` as (1, 3, 1, 1) on ``device``, made once per device."""
    return torch.as_tensor(RGB_MEAN, device=device).view(1, -1, 1, 1)


def normalize_device(image: torch.Tensor) -> torch.Tensor:
    """uint8 NCHW tensor -> normalized float32 NCHW on the tensor's device:
    the same recipe as :func:`normalize`, so a raw uint8 upload (4x fewer
    host-to-device bytes) gives the same input."""
    return image.to(torch.float32) / 255.0 - _device_mean(image.device)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, inputs: Arrays, targets: Optional[Arrays], rng: np.random.Generator):
        for t in self.transforms:
            inputs, targets = t(inputs, targets, rng)
        return inputs, targets


class RandomResizeCrop:
    """Bicubic resize by a random factor, then random crop to ``size``.

    The lower bound of the factor guarantees the resized image strictly
    contains the crop (the reference's ``(th+1)/h`` "+1 to ensure",
    data_transforms.py:63).
    """

    def __init__(self, size: Tuple[int, int], down: float = 0.75, up: float = 1.5):
        self.size = size
        self.down = down
        self.up = up

    def __call__(self, inputs, targets, rng):
        h, w = inputs[0].shape[:2]
        th, tw = self.size
        min_factor = max((th + 1) / h, (tw + 1) / w, self.down)
        factor = rng.uniform(min_factor, self.up)

        def _resize(a):
            img = Image.fromarray(a.astype(np.uint8) if a.dtype != np.uint8 else a)
            img = img.resize((int(w * factor), int(h * factor)), resample=Image.BICUBIC)
            return np.asarray(img)

        inputs = [_resize(a) for a in inputs]
        if targets is not None:
            targets = [_resize(a) for a in targets]

        h2, w2 = inputs[0].shape[:2]
        x1 = int(rng.integers(0, w2 - tw + 1))
        y1 = int(rng.integers(0, h2 - th + 1))
        crop = lambda a: a[y1 : y1 + th, x1 : x1 + tw]
        inputs = [crop(a) for a in inputs]
        if targets is not None:
            targets = [crop(a) for a in targets]
        return inputs, targets


class RandomHorizontalFlip:
    """Stereo-consistent flip: swap L<->R AND mirror both (and both targets)."""

    def __call__(self, inputs, targets, rng):
        if rng.random() < 0.5:
            inputs = [np.ascontiguousarray(np.fliplr(inputs[1])),
                      np.ascontiguousarray(np.fliplr(inputs[0]))]
            if targets is not None:
                targets = [np.ascontiguousarray(np.fliplr(targets[1])),
                           np.ascontiguousarray(np.fliplr(targets[0]))]
        return inputs, targets


class RandomGamma:
    def __init__(self, low: float = 0.8, high: float = 1.2):
        self.low, self.high = low, high

    def __call__(self, inputs, targets, rng):
        if rng.random() < 0.5:
            g = rng.uniform(self.low, self.high)
            inputs = [255.0 * (np.asarray(a, np.float32) / 255.0) ** g for a in inputs]
        return inputs, targets


class RandomBrightness:
    def __init__(self, low: float = 0.5, high: float = 2.0):
        self.low, self.high = low, high

    def __call__(self, inputs, targets, rng):
        if rng.random() < 0.5:
            f = rng.uniform(self.low, self.high)
            inputs = [np.minimum(np.asarray(a, np.float32) * f, 255.0) for a in inputs]
        return inputs, targets


class RandomChannelBrightness:
    """Per-channel gain, drawn independently per view AND per channel, as the
    reference RandomCBrightness does (data_transforms.py:148-155)."""

    def __init__(self, low: float = 0.8, high: float = 1.2):
        self.low, self.high = low, high

    def __call__(self, inputs, targets, rng):
        if rng.random() < 0.5:
            out = []
            for a in inputs:
                a = np.asarray(a, np.float32).copy()
                for c in range(3):
                    a[..., c] *= rng.uniform(self.low, self.high)
                out.append(np.minimum(a, 255.0))
            inputs = out
        return inputs, targets


def default_train_transform(crop_size: Tuple[int, int] = (192, 640)) -> Compose:
    return Compose([
        RandomResizeCrop(crop_size, down=0.75, up=1.5),
        RandomHorizontalFlip(),
        RandomGamma(0.8, 1.2),
        RandomBrightness(0.5, 2.0),
        RandomChannelBrightness(0.8, 1.2),
    ])
