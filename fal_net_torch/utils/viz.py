"""Visualization for logging and feature export (counterpart of
fal_net_tpu/utils/viz.py, reference myUtils.py:16-56), HWC numpy."""

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


def disp2rgb(disp_hw1: np.ndarray, max_value=None) -> np.ndarray:
    """Disparity (H, W, 1) -> grayscale RGB (H, W, 3) divided by
    ``max_value`` (default: the largest |disparity|), clipped to [0, 1]."""
    disp = np.asarray(disp_hw1, np.float32)[..., 0]
    denom = max_value if max_value is not None else np.abs(disp).max() or 1.0
    g = np.clip(disp / denom, 0, 1)
    return np.stack([g, g, g], axis=-1)


def flow2rgb(flow_hw2: np.ndarray, max_value=None) -> np.ndarray:
    """Flow (H, W, 2) -> RGB by the reference's two-channel recipe; pixels
    with zero flow (invalid) are white."""
    flow = np.asarray(flow_hw2, np.float32).copy()
    invalid = (flow[..., 0] == 0) & (flow[..., 1] == 0)
    flow[invalid] = np.nan
    denom = max_value if max_value is not None else np.nanmax(np.abs(flow)) or 1.0
    nf = flow / denom
    rgb = np.ones(flow.shape[:2] + (3,), np.float32)
    rgb[..., 0] += nf[..., 0]
    rgb[..., 1] -= 0.5 * (nf[..., 0] + nf[..., 1])
    rgb[..., 2] += nf[..., 1]
    return np.clip(np.nan_to_num(rgb, nan=1.0), 0, 1)


def grid2rgb(grid_hw2: np.ndarray, max_value=None) -> np.ndarray:
    """Sampling-grid picture (reference grid2rgb, myUtils.py:45-56): the
    flow recipe on an (H, W, 2) grid."""
    return flow2rgb(grid_hw2, max_value)
