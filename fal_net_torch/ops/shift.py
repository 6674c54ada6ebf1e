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


def _lerp_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` along its last axis at the positions ``pos`` (one per
    output index, broadcasting against ``x``): 1-D lerp, out-of-range reads 0."""
    base = torch.floor(pos)
    cols = torch.arange(x.shape[-1], device=x.device)
    return _lerp_gather(x, base.long() - cols, (pos - base).to(x.dtype))


def hshift_planes_quirk(x: torch.Tensor, levels) -> torch.Tensor:
    """The FAL_netA maskR sampler: an align_corners=False ``grid_sample`` of
    an align_corners=True grid offset by ``2 d_n / W`` (counterpart of
    fal_net_tpu/ops/shift.py::hshift_planes_quirk).

    The reference's variant-A maskR warp omits ``align_corners``
    (models/FAL_netA.py:264, so False) on a grid built with
    align_corners=True (FAL_netA.py:234).  Unnormalized with
    align_corners=False, the grid reads plane n of ``x`` (B, N, H, W) at

        p_x(x, n) = x * W/(W-1) + d_n - 0.5
        p_y(y)    = y * H/(H-1)       - 0.5

    a stretch and a half-pixel offset on both axes, instead of the uniform
    ``x + d (W-1)/W`` of every other warp.  The grid is axis-aligned, so the
    2-D bilinear read is two 1-D lerps (rows, then each plane's columns),
    each zero-padded.  Positions are fp32, as the JAX package's and
    grid_sample's; ``levels`` are the (N,) plane disparities d_n.
    """
    _, n, h, w = x.shape
    levels = torch.as_tensor(levels, device=x.device).to(torch.float32)
    rows = torch.arange(h, dtype=torch.float32, device=x.device) * (h / (h - 1)) - 0.5
    x = _lerp_at(x.transpose(-1, -2), rows).transpose(-1, -2)
    cols = torch.arange(w, dtype=torch.float32, device=x.device)
    pos = cols[None, :] * (w / (w - 1)) + levels[:, None] - 0.5  # (N, W)
    return _lerp_at(x, pos.view(1, n, 1, w))


def hflip(x: torch.Tensor) -> torch.Tensor:
    """Horizontal mirror flip along W.

    Equals the reference's flip-grid ``grid_sample`` under both
    align_corners conventions: a normalized-coordinate negation lands
    exactly on pixel ``W-1-x``.
    """
    return torch.flip(x, dims=(-1,))
