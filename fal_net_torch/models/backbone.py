"""U-Net style encoder-decoder backbone over the A/B/C variants
(counterpart of fal_net_tpu/models/backbone.py, plain NCHW form).

  variant | encoder conv1..conv6    | deconv6..1            | iconv6..2
  --------+-------------------------+-----------------------+-------------------
  A       | 64 128 128 256 256 256  | 128 128 128 64 64 64  | 256 256 128 128 64
  B       | 64 128 256 256 256 512  | 256 128 128 128 64 64 | 256 256 256 128 64
  C       | 64 128 256 256 512 512  | 256 256 128 128 64 64 | 512 256 256 128 64

conv0 is 3->32 stride 1; a 1-channel "flow" plane is concatenated before
conv1; each encoder conv is followed by a residual block.  The final iconv1
is a bias-free 3x3 conv emitting ``num_out`` plane logits.  The backbone
computes in its image's dtype (models/layers.py); the flow plane takes that
dtype before conv1, as in JAX (backbone.py:256).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from fal_net_torch.models.layers import ConvElu, Deconv, ResidualBlock, conv


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    name: str
    enc: Tuple[int, ...]  # conv1..conv6 output channels
    deconv: Tuple[int, ...]  # deconv6..deconv1 output channels
    iconv: Tuple[int, ...]  # iconv6..iconv2 output channels
    separable_residual: bool
    default_levels: int
    has_amask: bool  # reference declares (but never calls) an amask head;
    #                  its params still count toward checkpoint parity
    torch_backbone_key: str  # attribute name in reference checkpoints
    torch_name: str  # reference factory name stored in checkpoints


VARIANTS = {
    "A": VariantSpec(
        name="A",
        enc=(64, 128, 128, 256, 256, 256),
        deconv=(128, 128, 128, 64, 64, 64),
        iconv=(256, 256, 128, 128, 64),
        separable_residual=True,
        default_levels=33,
        has_amask=False,
        torch_backbone_key="BackBone",
        torch_name="FAL_netA",
    ),
    "B": VariantSpec(
        name="B",
        enc=(64, 128, 256, 256, 256, 512),
        deconv=(256, 128, 128, 128, 64, 64),
        iconv=(256, 256, 256, 128, 64),
        separable_residual=False,
        default_levels=49,
        has_amask=True,
        torch_backbone_key="backbone",
        torch_name="FAL_netB",
    ),
    "C": VariantSpec(
        name="C",
        enc=(64, 128, 256, 256, 512, 512),
        deconv=(256, 256, 128, 128, 64, 64),
        iconv=(512, 256, 256, 128, 64),
        separable_residual=False,
        default_levels=33,
        has_amask=True,
        torch_backbone_key="synth",
        torch_name="FAL_netC",
    ),
    # Dev/test-only variant: same topology, minimal widths. Not in the
    # reference; used by tests to keep them fast.
    "tiny": VariantSpec(
        name="tiny",
        enc=(8, 8, 8, 8, 8, 8),
        deconv=(8, 8, 8, 8, 8, 8),
        iconv=(8, 8, 8, 8, 8),
        separable_residual=False,
        default_levels=5,
        has_amask=False,
        torch_backbone_key="backbone",
        torch_name="FAL_netTiny",
    ),
}


class FalNetBackbone(nn.Module):
    """Encoder-decoder emitting ``num_out`` disparity-plane logits (NCHW).
    ``phase_deconv``: the decoder's exactly-2x deconvs as one transposed conv
    each (models/layers.py::Deconv)."""

    def __init__(self, spec: VariantSpec, num_out: int, phase_deconv: bool = False):
        super().__init__()
        self.spec = spec
        rb = lambda ch: ResidualBlock(ch, separable=spec.separable_residual)
        self.conv0 = ConvElu(3, 32)
        self.conv0_1 = rb(32)
        cin = 32 + 1  # x0 + flow plane
        for i, ch in enumerate(spec.enc, start=1):
            setattr(self, f"conv{i}", ConvElu(cin, ch, stride=2))
            setattr(self, f"conv{i}_1", rb(ch))
            cin = ch
        skip_ch = (32,) + spec.enc  # channels of x0..x6
        y_ch = spec.enc[5]
        for j in range(6, 1, -1):  # deconv6..deconv2 fuse with skips 5..1
            d_ch = spec.deconv[6 - j]
            setattr(self, f"deconv{j}", Deconv(y_ch, d_ch, phase=phase_deconv))
            y_ch = spec.iconv[6 - j]
            setattr(self, f"iconv{j}", ConvElu(d_ch + skip_ch[j - 1], y_ch))
        self.deconv1 = Deconv(y_ch, spec.deconv[5], phase=phase_deconv)
        self.iconv1 = conv(spec.deconv[5] + 32, num_out, 3, bias=False)
        if spec.has_amask:
            # The reference builds an occlusion-mask head that forward() never
            # calls (FAL_netB.py:128, predict_amask:83-89).  Its parameters are
            # in every shipped checkpoint, so they are declared here for
            # state-dict and parameter-count parity and never run.
            c = spec.deconv[5] + 32
            self.amask_conv = nn.Sequential(
                conv(c, c // 2, 3), nn.ELU(), conv(c // 2, 1, 3, bias=False), nn.Sigmoid()
            )

    def forward(self, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        return self.iconv1(self.features(image, flow))

    def features(self, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """iconv1's input: concat(deconv1's output, x0), in the image's dtype."""
        x0 = self.conv0_1(self.conv0(image))
        x = self.conv1_1(self.conv1(torch.cat([x0, flow.to(x0.dtype)], dim=1)))
        skips = [x0, x]
        for i in range(2, 7):
            x = getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}")(x))
            skips.append(x)
        # skips = [x0, x1, ..., x6]; the bottleneck is x6 at 1/64 resolution.
        y = skips[6]
        for j in range(6, 1, -1):
            skip = skips[j - 1]
            d = getattr(self, f"deconv{j}")(y, skip.shape[-2:])
            y = getattr(self, f"iconv{j}")(torch.cat([d, skip], dim=1))
        d1 = self.deconv1(y, x0.shape[-2:])
        return torch.cat([d1, x0], dim=1)
