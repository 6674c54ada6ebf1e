"""U-Net style encoder-decoder backbone over the A/B/C variants
(counterpart of fal_net_tpu/models/backbone.py, plain form).  NCHW shapes;
channels-last storage for fp32 on the card with no row shard (the image and
the weights come so, conv1's input is built so, and every op keeps it;
``FalNet.logits`` runs the backbone under ``channels_last_storage``), NCHW
for bf16, row shards and the CPU (models/layers.py).

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

With a :class:`~fal_net_torch.parallel.spatial.RowShard`, ``features`` splits
the levels' rows over its ranks at JAX's boundaries (fal_net_tpu/models/
backbone.py:260-281): each residual block's output, each skip, each deconv's
output and each fuse, split where the level rule says and whole elsewhere.
An op runs on each rank's rows where its output is split and its rows need
only its input's rows and their halo (a 3x3 conv, a stride-2 conv between
two split levels, an exactly 2x deconv); otherwise on whole rows gathered
from the ranks, its output then split where the rule says.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from fal_net_torch.models.layers import ConvElu, Deconv, ResidualBlock, conv, in_channels_last, padded_channels
from fal_net_torch.ops.logits_conv import pitched_cat
from fal_net_torch.parallel.spatial import ONE_RANK, Level, RowShard, level_heights


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

    def stem(self, x0: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """conv1's input: ``x0`` and the flow plane concatenated, in ``x0``'s
        dtype.  Under :func:`channels_last_storage` (the fp32 backbone on
        the card), written into channels-last storage with zero channels up
        to :func:`padded_channels`, which conv1's weight gets too
        (``Conv2d.weight_for``): cuDNN would pad the 33 channels in passes
        of its own, and ``torch.cat`` of 32 and 1 channels takes a slow
        path."""
        if not in_channels_last():
            return torch.cat([x0, flow.to(x0.dtype)], dim=1)
        b, c, h, w = x0.shape
        x = torch.empty((b, padded_channels(c + 1), h, w), dtype=x0.dtype, device=x0.device,
                        memory_format=torch.channels_last)
        x[:, c + 1:] = 0
        x[:, c:c + 1] = flow
        x[:, :c] = x0
        return x

    def forward(self, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        return self.iconv1(self.features(image, flow).x)

    def features(self, image: torch.Tensor, flow: torch.Tensor, rows: RowShard = ONE_RANK) -> Level:
        """iconv1's input: concat(deconv1's output, x0), in the image's dtype,
        from the whole ``image`` and ``flow``: a :class:`Level`, this rank's
        rows where ``rows`` splits the full-resolution level, else all.  One
        rank (the default) splits no level: every op runs once on whole rows."""
        hs = level_heights(image.shape[-2])

        def level(fn, inputs, i, row_local=True, h_in=None):
            split = rows.sharded(hs[i], h_in)
            return Level(rows.apply(fn, inputs, split, row_local), hs[i], split)

        def deconv(j, w):  # deconv j's output rows are 2x its input's on rows, the skip's when whole
            return lambda t: getattr(self, f"deconv{j}")(t, (hs[j - 1] * t.shape[-2] // hs[j], w))

        x0 = level(lambda x: self.conv0_1(self.conv0(x)), [Level(image, hs[0], False)], 0)
        x = level(lambda a, f: self.conv1(self.stem(a, f)), [x0, Level(flow, hs[0], False)], 1, row_local=x0.split)
        x = level(self.conv1_1, [x], 1)
        skips = [x0, x]
        for i in range(2, 7):
            x = level(getattr(self, f"conv{i}"), [x], i, row_local=x.split)
            x = level(getattr(self, f"conv{i}_1"), [x], i)
            skips.append(x)
        y = skips[6]
        for j in range(6, 0, -1):  # deconv6..deconv1; the last fuse is the concat before iconv1
            skip = skips[j - 1]
            d = level(deconv(j, skip.x.shape[-1]), [y], j - 1, row_local=hs[j - 1] == 2 * hs[j], h_in=hs[j])
            if j > 1:
                fuse = lambda a, b, conv=getattr(self, f"iconv{j}"): conv(torch.cat([a, b], dim=1))
            else:  # the logits conv's input: in bf16 on L1's row pitch (ops/logits_conv.py)
                fuse = lambda a, b: (pitched_cat if a.dtype == torch.bfloat16 else torch.cat)([a, b], dim=1)
            y = level(fuse, [d, skip], j - 1)
        return y
