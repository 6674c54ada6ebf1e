"""FAL-net in plain PyTorch: the yardstick the benchmark holds the port's
outputs against.

Written from the published description ("Forget About the LiDAR",
NeurIPS 2020; the authors' models/FAL_netA.py and FAL_netB.py) and from
nothing of the program under test: no kernel, no fused logits conv, no
row sharding.  Parameter names are the reference checkpoints' keys, which
the port keeps, so one seeded state_dict loads into both.

  * encoder: conv0 (3->32) and its residual block, the flow plane
    max_disp/100 concatenated, conv1..conv6 stride 2, each followed by a
    residual block: elu(conv2(elu(conv1(x))) + x), 3x3 pairs (B, C) or a
    (3,1) then (1,3) pair (A);
  * decoder: deconv j = nearest upsample to the skip's size, bias-free 3x3
    conv, ELU; iconv j = conv+ELU over concat(deconv, skip);
  * head: iconv1 (bias-free 3x3 over concat(deconv1, x0)) then the 1x1
    conv0 with bias: N plane logits, then the MED head (reference/med.py).
  * B and C declare an ``amask_conv`` head that forward never calls; its
    parameters exist so that the state_dict matches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import med

# variant -> (encoder conv1..6, deconv6..1, iconv6..2 widths, separable residuals, backbone key, amask head)
SPECS = {
    "A": ((64, 128, 128, 256, 256, 256), (128, 128, 128, 64, 64, 64), (256, 256, 128, 128, 64), True,
          "BackBone", False),
    "B": ((64, 128, 256, 256, 256, 512), (256, 128, 128, 128, 64, 64), (256, 256, 256, 128, 64), False,
          "backbone", True),
    "C": ((64, 128, 256, 256, 512, 512), (256, 256, 128, 128, 64, 64), (512, 256, 256, 128, 64), False,
          "synth", True),
    # the CPU tests' small stand-in (same topology)
    "tiny": ((8,) * 6, (8,) * 6, (8,) * 5, False, "backbone", False),
}


def _conv(cin, cout, k=3, stride=1, bias=True):
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), stride, (kh // 2, kw // 2), bias=bias)


class _Residual(nn.Module):
    def __init__(self, ch, separable):
        super().__init__()
        shapes = [(3, 1), (1, 3)] if separable else [3, 3]
        self.conv1 = _conv(ch, ch, shapes[0], bias=False)
        self.conv2 = _conv(ch, ch, shapes[1], bias=False)

    def forward(self, x):
        return F.elu(self.conv2(F.elu(self.conv1(x))) + x)


class _Deconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = _conv(cin, cout, bias=False)

    def forward(self, x, size):
        return F.elu(self.conv1(F.interpolate(x, size=size, mode="nearest")))


def _conv_elu(cin, cout, stride=1):
    return nn.Sequential(_conv(cin, cout, 3, stride), nn.ELU())


class Backbone(nn.Module):
    def __init__(self, variant: str, num_out: int):
        super().__init__()
        enc, dec, icv, sep, _, amask = SPECS[variant]
        self.conv0 = _conv_elu(3, 32)
        self.conv0_1 = _Residual(32, sep)
        cin = 33
        for i, ch in enumerate(enc, start=1):
            setattr(self, f"conv{i}", _conv_elu(cin, ch, stride=2))
            setattr(self, f"conv{i}_1", _Residual(ch, sep))
            cin = ch
        skip_ch = (32,) + enc
        y_ch = enc[5]
        for j in range(6, 1, -1):
            setattr(self, f"deconv{j}", _Deconv(y_ch, dec[6 - j]))
            setattr(self, f"iconv{j}", _conv_elu(dec[6 - j] + skip_ch[j - 1], icv[6 - j]))
            y_ch = icv[6 - j]
        self.deconv1 = _Deconv(y_ch, dec[5])
        self.iconv1 = _conv(dec[5] + 32, num_out, bias=False)
        if amask:
            c = dec[5] + 32
            self.amask_conv = nn.Sequential(_conv(c, c // 2), nn.ELU(), _conv(c // 2, 1, bias=False), nn.Sigmoid())

    def forward(self, image, flow):
        x0 = self.conv0_1(self.conv0(image))
        x = self.conv1_1(self.conv1(torch.cat([x0, flow], 1)))
        skips = [x0, x]
        for i in range(2, 7):
            x = getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}")(x))
            skips.append(x)
        y = skips[6]
        for j in range(6, 1, -1):
            skip = skips[j - 1]
            d = getattr(self, f"deconv{j}")(y, skip.shape[-2:])
            y = getattr(self, f"iconv{j}")(torch.cat([d, skip], 1))
        d = self.deconv1(y, x0.shape[-2:])
        return self.iconv1(torch.cat([d, x0], 1))


class FalNet(nn.Module):
    """``forward(left, min_disp, max_disp, pan=False) -> (disp, pan or None)``
    on a normalized NCHW fp32 image; scalar disparity bounds."""

    def __init__(self, variant: str, num_levels: int):
        super().__init__()
        self.key = SPECS[variant][4]
        self.add_module(self.key, Backbone(variant, num_levels))
        self.conv0 = _conv(num_levels, num_levels, 1)

    def logits(self, left, max_disp):
        b, _, h, w = left.shape
        flow = torch.full((b, 1, h, w), max_disp / 100.0, dtype=left.dtype, device=left.device)
        return self.conv0(getattr(self, self.key)(left, flow))

    def forward(self, left, min_disp, max_disp, pan=False):
        return med.head(self.logits(left, max_disp), left, min_disp, max_disp, pan=pan)
