"""Building blocks of the FAL-net variants (counterpart of
fal_net_tpu/models/layers.py, plain domain only).

NCHW, OIHW weights.  Every conv computes in its input's dtype: fp32 as
``nn.Conv2d`` does, or bf16 with bf16 weights and a bf16 output and the bias
added in bf16 after the conv, as JAX's ``ConvOp`` does with a bf16 compute
dtype (fal_net_tpu/models/layers.py:240-243,283-285); the parameters stay
fp32.  ELU, adds, concats and nearest upsamples keep their input's dtype,
so a backbone whose image is cast to bf16 runs in bf16 throughout.
While a :class:`fal_net_torch.parallel.spatial.RowShard` is active (a level
whose rows are split over ranks), each conv takes its kh//2 boundary rows
from the neighbouring ranks and zero-pads only its columns, and an exact 2x
deconv upsamples this rank's rows alone.
Attribute names follow the reference's torch modules
so that ``state_dict`` keys are the reference's (``conv0.0.weight`` for a
conv_elu, ``conv0_1.conv1.weight`` for a residual block,
``deconvJ.conv1.weight`` for a deconv).  Init is kaiming-normal with fan-in
and gain sqrt(2), zero biases (reference models/FAL_netB.py:131-138).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fal_net_torch.ops.phase_deconv import conv3x3_on_up2
from fal_net_torch.parallel.spatial import active_rows


def init_conv(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    nn.init.kaiming_normal_(conv.weight, mode="fan_in", nonlinearity="relu", generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, on this rank's rows under an active
    row shard (see the module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows, pad = active_rows(), self.padding
        if rows is None and x.dtype == self.weight.dtype:
            return super().forward(x)
        if rows is not None and pad[0]:
            x, pad = rows.halo(x, pad[0]), (0, pad[1])
        if x.dtype == self.weight.dtype:
            return F.conv2d(x, self.weight, self.bias, self.stride, pad)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]


def conv(cin: int, cout: int, kernel=3, stride: int = 1, bias: bool = True) -> Conv2d:
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return Conv2d(cin, cout, (kh, kw), stride, padding=(kh // 2, kw // 2), bias=bias)


class ConvElu(nn.Sequential):
    """Conv (with bias) then ELU; reference ``conv_elu`` (FAL_netB.py:35-48),
    an nn.Sequential whose conv is key ``.0``."""

    def __init__(self, cin: int, cout: int, stride: int = 1, kernel: int = 3):
        super().__init__(conv(cin, cout, kernel, stride), nn.ELU())


class ResidualBlock(nn.Module):
    """``elu(conv2(elu(conv1(x))) + x)`` with bias-free convs: two 3x3
    (FAL_netB/C) or a (k,1) then (1,k) pair (``separable``, FAL_netA)."""

    def __init__(self, channels: int, separable: bool = False, kernel: int = 3):
        super().__init__()
        k = kernel
        shapes = [(k, 1), (1, k)] if separable else [(k, k), (k, k)]
        self.conv1 = conv(channels, channels, shapes[0], bias=False)
        self.conv2 = conv(channels, channels, shapes[1], bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv2(F.elu(self.conv1(x))) + x)


class Deconv(nn.Module):
    """Nearest upsample to the skip tensor's exact size, bias-free 3x3 conv,
    ELU (reference ``deconv``, FAL_netB.py:51-60).  Torch's own "nearest"
    is the semantics fal_net_tpu/ops/resize.py::resize_nearest_torch
    reproduces, including the non-2x sizes of odd KITTI heights.

    ``phase``: where the skip size is exactly 2x the input, the upsample and
    the conv run as one transposed conv with the composed 4x4 kernel
    (ops/phase_deconv.py), as JAX's ``Deconv(phase=True)`` does
    (fal_net_tpu/models/layers.py:402-423); other sizes take the plain path.
    The parameter is ``conv1.weight`` either way.  Under an active row shard,
    ``x`` and ``skip_hw`` are this rank's rows of an exactly 2x upsample
    (models/backbone.py runs other deconvs on whole rows): the transposed
    conv reads one halo row of ``x``, the nearest path upsamples the rows
    and its conv takes its own halo."""

    def __init__(self, cin: int, cout: int, phase: bool = False):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, bias=False)
        self.phase = phase

    def forward(self, x: torch.Tensor, skip_hw: Tuple[int, int]) -> torch.Tensor:
        if self.phase and tuple(skip_hw) == (2 * x.shape[-2], 2 * x.shape[-1]):
            rows = active_rows()
            if rows is None:
                return F.elu(conv3x3_on_up2(x, self.conv1.weight.to(x.dtype)))
            return F.elu(conv3x3_on_up2(rows.halo(x, 1), self.conv1.weight.to(x.dtype), halo=1))
        x = F.interpolate(x, size=tuple(skip_hw), mode="nearest")
        return F.elu(self.conv1(x))
