"""Inputs and weights made from ``--seed`` on the run's device, in a few
large calls of one ``torch.Generator``: the same seed gives the same
tensors, and every seed the same sizes.

  * :func:`weights`: a state_dict for a module's parameters, every weight
    Kaiming-normal (fan-in, gain sqrt(2)) and every bias zero, the init of
    the authors' models (FAL_netB.py:131-138) and of the port;
  * :func:`frames`: smooth RGB uint8 frames (HWC, on the host), a sum of
    seeded sinusoids with a little noise, as the port's chip_smoke.py
    draws them;
  * :func:`stereo_pairs`: smooth stereo pairs, a bicubic zoom of coarse
    noise centred at 0 (the training soak's SmoothStereo), the right view
    the left one shifted by a per-pair whole number of pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SEED_SPACE = 2 ** 63 - 1  # torch.Generator.manual_seed takes any seed below it


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed``; ``stream`` keeps the uses of
    one seed apart (weights, traffic, the sample of answers checked)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_SPACE)
    return g


def weights(shapes: dict, seed: int, device, stream: int = 1) -> dict:
    """{name: tensor} for {name: shape}: names ending in ``bias`` zero, the
    rest Kaiming-normal with fan-in = numel / shape[0]."""
    names = [n for n in shapes if not n.endswith("bias")]
    total = sum(math.prod(shapes[n]) for n in names)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[name] = flat[at:at + n].view(shape).mul_(math.sqrt(2.0 / fan_in))
        at += n
    return out


def frames(count: int, h: int, w: int, seed: int, device, stream: int = 2) -> np.ndarray:
    """(count, h, w, 3) uint8 frames on the host."""
    g = generator(seed, device, stream)
    phase = torch.rand(count, 3, 1, 1, generator=g, device=device) * (2 * math.pi)
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, w)
    period = (40 + 15 * torch.arange(3, device=device, dtype=torch.float32)).view(1, 3, 1, 1)
    base = torch.sin(xx / period + yy / 60 + phase)
    img = 127.5 + 90 * base + 4 * torch.randn(count, 3, h, w, generator=g, device=device)
    return img.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def stereo_pairs(count: int, h: int, w: int, seed: int, device, max_shift: int = 24, stream: int = 3):
    """(left, right), each (count, 3, h, w) float32 on ``device``, values in
    about [-0.5, 0.5]; pair i's right view is its left one shifted by
    4..max_shift px."""
    g = generator(seed, device, stream)
    shifts = torch.randint(4, max_shift + 1, (count,), generator=g, device=device).tolist()
    coarse = torch.rand(count, 3, h // 16 + 2, (w + max_shift) // 16 + 2, generator=g, device=device)
    wide = F.interpolate(coarse, scale_factor=16, mode="bicubic", align_corners=False)[..., :h, :w + max_shift]
    left = wide[..., :w] - 0.5
    right = torch.stack([wide[i, :, :, s:s + w] for i, s in enumerate(shifts)]) - 0.5
    return left.contiguous(), right.contiguous()
