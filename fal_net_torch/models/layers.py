"""Building blocks of the FAL-net variants (counterpart of
fal_net_tpu/models/layers.py, plain domain only).

NCHW shapes, OIHW weights.  Storage: channels-last for fp32 on the card
with no active row shard (the weights from ``create_model``, the image
from ``FalNet.logits``, which runs the backbone under
:func:`channels_last_storage`), so that cuDNN runs its NHWC kernels with
no transposes around them; NCHW for bf16 (L1 reads NCHW rows on a pitch),
under a row shard (the halo code) and on the CPU.  The layers decide by
that mode, never by a tensor's strides, so that a traced program
(``torch.export``, whose fake convolutions come out NCHW) takes the
branches the live model takes.
Every conv computes in its input's dtype: fp32 as ``nn.Conv2d`` does, or
bf16 with bf16 weights and a bf16 output and the bias added in bf16 after
the conv, as JAX's ``ConvOp`` does with a bf16 compute dtype
(fal_net_tpu/models/layers.py:240-243,283-285); the parameters stay fp32.
ELU, adds, concats of like inputs and nearest upsamples keep their input's
dtype and storage, so a backbone whose image is cast to bf16 runs in bf16
throughout, and one whose image is channels-last stays so.
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

import contextlib
import threading
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


_STORAGE = threading.local()


@contextlib.contextmanager
def channels_last_storage(on: bool = True):
    """Run the backbone in channels-last storage (``on``) or NCHW, on this
    thread, for the duration of the block."""
    prev = getattr(_STORAGE, "on", False)
    _STORAGE.on = on
    try:
        yield
    finally:
        _STORAGE.on = prev


def in_channels_last() -> bool:
    """Whether the backbone runs in channels-last storage on this thread."""
    return getattr(_STORAGE, "on", False)


def padded_channels(c: int) -> int:
    """``c`` rounded up to a multiple of 8: cuDNN's NHWC kernels take channel
    counts so, and pad any other count in passes of their own, every call."""
    return -(-c // 8) * 8


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=2, mode="nearest")`` of a channels-last
    ``x`` as one broadcast copy into channels-last storage: on the card it
    and its backward (a sum over each 2x2 block) take the NCHW kernels'
    time, where F.interpolate's NHWC kernels take twice that."""
    n, c, h, w = x.shape
    up = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
    return up.permute(0, 3, 1, 2)


class ToNCHW(torch.autograd.Function):
    """The first ``c`` channels of a channels-last ``x`` in NCHW storage, in
    two copies through tiles of 32 pixels (of one image row where H * W is
    not a multiple of 32): each reads and writes within a tile, where one
    copy across the whole layout reads every channel's plane at a stride of
    C floats (on the card at (8, 56 -> 49, 384, 1280): 1.46 ms against
    5.49).  The backward writes the cotangent into channels-last storage
    with zeros past ``c``, in one copy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, c: int) -> torch.Tensor:
        b, ctx.c_in, h, w = x.shape
        t = 32 if h * w % 32 == 0 else w
        tiles = x.permute(0, 2, 3, 1).reshape(b, h * w // t, t, ctx.c_in)[..., :c].transpose(2, 3).contiguous()
        return tiles.permute(0, 2, 1, 3).contiguous().view(b, c, h, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        b, c, h, w = g.shape
        gx = torch.empty((b, ctx.c_in, h, w), dtype=g.dtype, device=g.device, memory_format=torch.channels_last)
        gx[:, c:] = 0
        gx[:, :c] = g
        return gx, None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, on this rank's rows under an active
    row shard (see the module docstring)."""

    def weight_for(self, x: torch.Tensor) -> torch.Tensor:
        """The weight in ``x``'s dtype and the backbone's storage:
        channels-last for fp32 under :func:`channels_last_storage` (the
        weights are held so on the card: no copy), else NCHW (bf16; NCHW
        rows under a row shard; the CPU).  Where ``x`` carries zero channels
        past the weight's input channels (conv1's input on the card,
        :func:`padded_channels`), the weight gets zero input channels to
        match."""
        w = self.weight
        if x.dtype == w.dtype and in_channels_last():
            w = w.contiguous(memory_format=torch.channels_last)
        else:
            w = w.to(x.dtype, memory_format=torch.contiguous_format)
        return w if x.shape[1] == w.shape[1] else F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows, pad = active_rows(), self.padding
        if rows is not None and pad[0]:
            x, pad = rows.halo(x, pad[0]), (0, pad[1])
        w = self.weight_for(x)
        if x.dtype == self.weight.dtype:
            return F.conv2d(x, w, self.bias, self.stride, pad)
        y = F.conv2d(x, w, None, self.stride, pad)
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
                return F.elu(conv3x3_on_up2(x, self.conv1.weight_for(x)))
            x = rows.halo(x, 1)
            return F.elu(conv3x3_on_up2(x, self.conv1.weight_for(x), halo=1))
        if in_channels_last() and tuple(skip_hw) == (2 * x.shape[-2], 2 * x.shape[-1]):
            x = nearest_up2(x)
        else:
            x = F.interpolate(x, size=tuple(skip_hw), mode="nearest")
        return F.elu(self.conv1(x))
