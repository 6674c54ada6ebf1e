"""The MED (mirrored exponential disparity) head in plain PyTorch, from the
published description (FAL_netB.py:200-297 of the authors' code):

  * N planes at disparities d_n = max * (max/min)^(n/(N-1) - 1);
  * disparity = sum_n d_n softmax(logits)_n;
  * pan (the synthesized right view) = sum_n shift(image, s_n) D_n, where
    D = softmax over planes of the logits shifted plane by plane, and
    shift(x, s)[x] = x[x + s] by linear interpolation with zero padding,
    s_n = d_n (W - 1) / W (grid_sample's align_corners=True step).

Each plane is shifted by two slices of a zero-padded copy, one plane at a
time: slow and plain.  Scalar bounds only.
"""

from __future__ import annotations

import math

import torch


def levels(min_disp: float, max_disp: float, n: int) -> torch.Tensor:
    """Plane disparities in float64, (N,)."""
    c = torch.arange(n, dtype=torch.float64, device="cpu") / (n - 1)
    return max_disp * torch.exp(math.log(max_disp / min_disp) * (c - 1.0))


def shift(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x`` sampled at column + ``s`` along the last axis (1-D lerp, zeros
    outside); ``s`` in float64, its fraction rounded to x's dtype."""
    w = x.shape[-1]
    base = math.floor(s)
    t = s - base
    pad = abs(base) + 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    a = xp[..., pad + base: pad + base + w]
    b = xp[..., pad + base + 1: pad + base + 1 + w]
    t = torch.tensor(t, dtype=torch.float64).to(x.dtype)
    return (1 - t) * a + t * b


def head(logits: torch.Tensor, image: torch.Tensor, min_disp: float, max_disp: float, pan: bool = False):
    """(disp (B,1,H,W), pan (B,C,H,W) or None) from logits (B,N,H,W)."""
    n, w = logits.shape[1], logits.shape[-1]
    d = levels(min_disp, max_disp, n)
    disp = (torch.softmax(logits, 1) * d.to(logits.dtype).to(logits.device).view(1, n, 1, 1)).sum(1, keepdim=True)
    if not pan:
        return disp, None
    s = (d * ((w - 1) / w)).tolist()
    dprob = torch.softmax(torch.stack([shift(logits[:, i], s[i]) for i in range(n)], 1), 1)
    out = sum(shift(image, s[i]) * dprob[:, i:i + 1] for i in range(n))
    return disp, out
