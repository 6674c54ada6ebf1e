"""Visualization for feature export (counterpart of
fal_net_tpu/utils/viz.py::local_normalization), HWC numpy."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

from fal_net_torch.data.transforms import RGB_MEAN


def local_normalization(img: np.ndarray, win: int = 3) -> np.ndarray:
    """Window-local contrast normalization of a normalized HWC image
    (Test_KITTI.py:303-317): de-normalize, then (x - m) / (s + 1e-7), m the
    zero-padded win x win box mean (avg_pool2d with count_include_pad) and
    s = sqrt(box_mean((x - m)^2))."""
    x = np.asarray(img, np.float32) + RGB_MEAN

    def box_mean(a):
        return np.stack(
            [uniform_filter(a[..., c], size=win, mode="constant", cval=0.0) for c in range(a.shape[-1])],
            axis=-1,
        )

    m = box_mean(x)
    s = np.sqrt(box_mean((x - m) ** 2))
    return (x - m) / (s + 1e-7)
