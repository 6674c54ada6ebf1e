"""L1: the composed logits conv in bf16 (``csrc/logits_conv.cu``) and its
plain version.

L1 replaces fal_net_tpu/models/layers.py::_conv_accum as
fal_net_tpu/models/backbone.py:329 calls it under ``fuse_logits``: a 3x3,
stride-1 conv of NCHW bf16 ``x`` (B, Cin, H, W) with the bf16 composed
kernel ``k`` (Cout, Cin, 3, 3), every product and sum in fp32, plus the
fp32 ``bias`` (Cout), into fp32 NCHW (B, Cout, H - 2 + 2 pad_h, W):

    out[b, co, y, x] = bias[co] + sum k[co, ci, dy, dx] x[b, ci, y + dy - pad_h, x + dx - 1]   (0 outside).

``pad_h`` is 1, or 0 on rows that already carry their halo (a rank of a
row-partitioned model).  The columns are always padded by 1.

It launches through the op ``fal_net_torch::logits_conv`` (ops/library.py),
whose autograd formula is ``_conv_accum_bwd``'s: the cotangent cast to bf16
and the bf16 conv VJP for ``x`` and ``k``, the fp32 sum for ``bias``.  On a
CUDA tensor the op launches the kernel (CUDA impl in csrc/torch_ops.cpp,
which checks the tensors and raises on what the kernel refuses); on a CPU
tensor it runs :func:`logits_conv_plain`.  ``LAUNCHES`` reads L1's launch
count, which the op keeps.

The kernel stages ``x`` by TMA, which takes rows on a 16-byte pitch: on the
card ``x``'s rows must be contiguous, its row, channel and batch strides
multiples of 8 elements and its data 16-byte aligned; any other ``x``
raises ``ValueError`` (the CUDA impl's check), and is never copied.  Where
W % 8 == 0 a contiguous tensor is on the pitch.  Elsewhere (KITTI's 1242
columns) the model builds the concat that L1 reads on it
(:func:`pitched_cat`: a view of a buffer whose rows are padded to a
multiple of 8 columns; :func:`pitched_empty` for other callers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fal_net_torch.ops._build import LaunchCounts, load_library

LAUNCHES = LaunchCounts(("logits_conv",))
PITCH = 8  # elements: L1's rows, channels and batches start on 16 bytes of bf16 (TMA)


def pitched_empty(shape, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor of ``shape`` with ``like``'s dtype and device
    whose rows are on L1's pitch: a view of a buffer whose last dimension is
    rounded up to a multiple of :data:`PITCH` (the buffer itself where it
    is one)."""
    *lead, w = shape
    wp = -(-w // PITCH) * PITCH
    buf = like.new_empty((*lead, wp))
    return buf if wp == w else buf[..., :w]


def pitched_cat(tensors, dim: int = 1) -> torch.Tensor:
    """``torch.cat(tensors, dim)`` written on L1's pitch (:func:`pitched_empty`,
    each tensor copied into its slice; differentiable): ``torch.cat`` itself
    where the rows already are, W % 8 == 0."""
    if tensors[0].shape[-1] % PITCH == 0:
        return torch.cat(tensors, dim)
    shape = list(tensors[0].shape)
    shape[dim] = sum(t.shape[dim] for t in tensors)
    out, at = pitched_empty(shape, tensors[0]), 0
    for t in tensors:
        out.narrow(dim, at, t.shape[dim]).copy_(t)
        at += t.shape[dim]
    return out


def logits_conv_plain(x: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, pad_h: int) -> torch.Tensor:
    """L1's function through fp32: ``x`` and ``k`` upcast (exact for bf16)
    and convolved with the fp32 ``bias``.  On the card, call it with TF32
    convolutions off, so that only the order of the sums differs from the
    kernel's."""
    return F.conv2d(x.float(), k.float(), bias, 1, (pad_h, 1))


def logits_conv(x: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, pad_h: int = 1) -> torch.Tensor:
    """L1 on bf16 ``x`` and ``k`` and an fp32 ``bias``: the kernel for CUDA
    tensors (launched on the current stream, no synchronize), the plain
    version for CPU tensors; differentiable in all three."""
    if x.is_cuda:
        load_library()
    return torch.ops.fal_net_torch.logits_conv.default(x, k, bias, pad_h)
