"""Edge-aware disparity smoothness loss (counterpart of
fal_net_tpu/losses/smoothness.py), NCHW.

Reference ``smoothness`` (loss_functions.py:70-109): de-normalize the image
(add back the channel means), grayscale via Rec.601, measure the disparity's
second derivative plus both first derivatives per axis, weighted by
exp(-gamma * |image second derivative|).  The 3x3 stencils are axis-aligned
shift-and-subtract expressions on a zero-padded array, which is what the
reference's zero-padding conv2d launches compute.  With ``rows`` (a
:class:`~fal_net_torch.parallel.spatial.RowShard`), ``img`` and ``disp`` are
this rank's rows: the row above and below come from the neighbouring ranks
(zeros at the image's top and bottom) and the mean is over every rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RGB_MEAN = (0.411, 0.432, 0.45)  # the normalization recipe's channel means
_REC601 = (0.299, 0.587, 0.114)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """(B,3,H,W) normalized -> (B,1,H,W) de-normalized luminance."""
    mean = torch.tensor(RGB_MEAN, dtype=img.dtype, device=img.device).view(1, 3, 1, 1)
    w = torch.tensor(_REC601, dtype=img.dtype, device=img.device).view(1, 3, 1, 1)
    return ((img + mean) * w).sum(dim=1, keepdim=True)


def smoothness(img: torch.Tensor, disp: torch.Tensor, gamma: float = 1.0, rows=None) -> torch.Tensor:
    """img: (B,3,H,W) normalized; disp: (B,1,H,W). Returns a scalar."""
    h, w = img.shape[-2:]
    if rows is None:
        gray, d = F.pad(_grayscale(img), (1, 1, 1, 1)), F.pad(disp, (1, 1, 1, 1))
    else:
        gray, d = (F.pad(rows.halo(t, 1), (1, 1)) for t in (_grayscale(img), disp))

    c = lambda a: a[..., 1 : 1 + h, 1 : 1 + w]
    left = lambda a: a[..., 1 : 1 + h, 0:w]
    right = lambda a: a[..., 1 : 1 + h, 2 : 2 + w]
    up = lambda a: a[..., 0:h, 1 : 1 + w]
    down = lambda a: a[..., 2 : 2 + h, 1 : 1 + w]

    # image second derivatives ([-1, 2, -1] stencils, zero padded)
    dx_img = 2 * c(gray) - left(gray) - right(gray)
    dy_img = 2 * c(gray) - up(gray) - down(gray)

    # disparity first derivatives: both one-sided differences per axis
    dx_d = c(d) - right(d)
    dx1_d = c(d) - left(d)
    dy_d = c(d) - down(d)
    dy1_d = c(d) - up(d)

    return (torch.mean if rows is None else rows.mean)(
        (torch.abs(dx_d) + torch.abs(dx1_d)) * torch.exp(-gamma * torch.abs(dx_img))
        + (torch.abs(dy_d) + torch.abs(dy1_d)) * torch.exp(-gamma * torch.abs(dy_img))
    )
