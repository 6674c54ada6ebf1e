"""Horizontal fractional-pixel shift ops (counterpart of fal_net_tpu/ops/shift.py).

Every warp the reference performs is a pure horizontal translation, so it is
a 1-D linear-interpolation gather along W (the last axis, NCHW) with zero
padding, matching ``F.grid_sample(..., align_corners=True,
padding_mode='zeros')``:

  output[x] = input[x + s]      (bilinear in 1-D, out-of-range reads 0)

For a normalized offset ``x_of = 2*d/W`` the pixel shift under
align_corners=True is ``s = d * (W - 1) / W`` (see
:func:`fal_net_torch.ops.med.pixel_shifts`).
"""

from __future__ import annotations

import torch


def _lerp_gather(x: torch.Tensor, base: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """``(1-frac) * x[..., base] + frac * x[..., base+1]`` along the last
    axis, out-of-range reads 0.  ``base`` is an int64 index tensor that
    broadcasts against ``x`` (same ndim); ``frac`` broadcasts likewise."""
    width = x.shape[-1]
    cols = torch.arange(width, device=x.device)
    idx0 = cols + base
    shape = torch.broadcast_shapes(x.shape, idx0.shape)
    x = x.expand(shape)

    def read(idx):
        oob = (idx < 0) | (idx >= width)
        v = torch.gather(x, -1, idx.clamp(0, width - 1).expand(shape))
        return v.masked_fill(oob, 0)

    return (1 - frac) * read(idx0) + frac * read(idx0 + 1)


def _split_shift(shift: torch.Tensor, width: int):
    """Integer part and fraction of a shift, the fraction taken in the
    shift's own precision before it is rounded to the data's dtype."""
    base = torch.floor(shift)
    frac = shift - base
    # Clamp the integer part so indices stay small even for huge shifts;
    # anything beyond +-width reads all zeros regardless.
    return base.clamp(-width - 1, width + 1).long(), frac


def hshift(x: torch.Tensor, shift) -> torch.Tensor:
    """Sample ``x`` at ``index + shift`` along the last axis (1-D lerp).

    ``shift`` is a scalar number of pixels (Python float or 0-d tensor),
    taken in float64.
    A sample position p in (W-1, W) still blends ``(1-t) * x[W-1]`` with a
    zero right-neighbour, as grid_sample's zero padding does.
    """
    shift = torch.as_tensor(shift, dtype=torch.float64, device=x.device)
    base, frac = _split_shift(shift, x.shape[-1])
    view = (1,) * x.ndim
    return _lerp_gather(x, base.reshape(view), frac.to(x.dtype).reshape(view))


def hshift_planes(x: torch.Tensor, shifts, *, plane_dim: int = 1) -> torch.Tensor:
    """Shift each plane ``x.select(plane_dim, n)`` by its own ``shifts[n]``
    pixels along the last axis.

    ``x`` is e.g. logits ``(B, N, H, W)`` (``plane_dim=1``) or an image
    broadcast over planes ``(B, C, N, H, W)`` (``plane_dim=2``).  Replaces
    the reference's per-plane loop of N ``grid_sample`` launches with one
    vectorized gather.  ``shifts`` keep their dtype (float64 from
    :func:`fal_net_torch.ops.med.pixel_shifts`) until the fraction is taken.
    """
    shifts = torch.as_tensor(shifts, device=x.device)
    base, frac = _split_shift(shifts, x.shape[-1])
    view = [1] * x.ndim
    view[plane_dim] = shifts.shape[0]
    return _lerp_gather(x, base.reshape(view), frac.to(x.dtype).reshape(view))


def hflip(x: torch.Tensor) -> torch.Tensor:
    """Horizontal mirror flip along W.

    Equals the reference's flip-grid ``grid_sample`` under both
    align_corners conventions: a normalized-coordinate negation lands
    exactly on pixel ``W-1-x``.
    """
    return torch.flip(x, dims=(-1,))
