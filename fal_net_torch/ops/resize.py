"""Image resizes with ``torch.nn.functional.interpolate`` semantics, NCHW
(counterpart of fal_net_tpu/ops/resize.py).

  * nearest: src = floor(dst * float32(in / out)), clamped to in - 1
    (the decoder's upsampling, FAL_netB.py:58; the ms post-process's
    upsample back, Test_KITTI.py:293).  The scale is a float32, as torch's
    and the JAX package's: a float64 scale moves indices at boundaries;
  * bilinear with align_corners=True: src = dst * (in - 1) / (out - 1)
    (realEPE's upsample, loss_functions.py:172; the ms post-process's
    downscale, Test_KITTI.py:291-292).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_nearest_torch(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor to ``size`` = (H, W)."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


def resize_bilinear_align_corners(
    x: torch.Tensor, size: Tuple[int, int], *, align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)
