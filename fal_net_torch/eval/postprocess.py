"""Inference post-processing, NCHW (counterpart of
fal_net_tpu/eval/postprocess.py; reference Test_KITTI.py:199-205, 287-300).

Both post-processors run a second forward pass on a flipped input through
``disp_fn``: normalized (B, C, H, W) image -> (B, 1, H, W) disparity.  The
reference's ``np.percentile`` host sync (Test_KITTI.py:297) is a
``torch.quantile`` on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from fal_net_torch.ops.resize import resize_bilinear_align_corners, resize_nearest_torch
from fal_net_torch.ops.shift import hflip

DispFn = Callable[[torch.Tensor], torch.Tensor]
MS_UP_FAC = 2.0 / 3.0  # the multi-scale pass's scale (Test_KITTI.py:291)
QUANTILE_MAX_NUMEL = 1 << 24  # torch.quantile refuses larger inputs


def flip_post_process(image: torch.Tensor, disp_fn: DispFn, disp: torch.Tensor) -> torch.Tensor:
    """The mean of disp and the unflipped disparity of the flipped input
    (Test_KITTI.py:199-203)."""
    return (disp + hflip(disp_fn(hflip(image)))) / 2.0


def percentile95(disp: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, 1): each image's own 95th percentile, linear interpolation
    between order statistics (``np.percentile``'s and ``jnp.percentile``'s
    default rule), in row blocks under torch.quantile's size limit."""
    flat = disp.flatten(1)
    per = max(1, QUANTILE_MAX_NUMEL // flat.shape[1])
    q = [torch.quantile(flat[i : i + per], 0.95, dim=1) for i in range(0, flat.shape[0], per)]
    return torch.cat(q).view(-1, 1, 1, 1)


def ms_post_process(
    image: torch.Tensor, disp_fn: DispFn, disp: torch.Tensor, up_fac: float = MS_UP_FAC
) -> torch.Tensor:
    """Multi-scale post-process (Test_KITTI.py:287-300).

    A second pass at ``up_fac`` scale on the flipped input (bilinear,
    align_corners=True), nearest-upsampled back (torch indices), rescaled by
    1/up_fac and unflipped, blended by ``norm = min(disp / p95(disp), 1)``:
        out = (1 - norm) * disp + norm * down_flip_disp
    The percentile is each image's own: a batch-wide one would couple an
    image's blend to its batchmates, zero-padded tail slots included.
    """
    h, w = image.shape[-2:]
    small = (int(h * up_fac), int(w * up_fac))
    dwn = disp_fn(resize_bilinear_align_corners(hflip(image), small))
    dwn = hflip((1.0 / up_fac) * resize_nearest_torch(dwn, (h, w)))
    norm = torch.clamp(disp / (percentile95(disp) + 1e-6), max=1.0)
    return (1.0 - norm) * disp + norm * dwn
