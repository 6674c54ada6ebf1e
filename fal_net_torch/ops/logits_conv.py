"""L1: the composed logits conv in bf16 (``csrc/logits_conv.cu``) and its
plain version.

L1 replaces fal_net_tpu/models/layers.py::_conv_accum as
fal_net_tpu/models/backbone.py:329 calls it under ``fuse_logits``: a 3x3,
stride-1 conv of NCHW bf16 ``x`` (B, Cin, H, W) with the bf16 composed
kernel ``k`` (Cout, Cin, 3, 3), every product and sum in fp32, plus the
fp32 ``bias`` (Cout), into fp32 (B, Cout, H - 2 + 2 pad_h, W):

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fal_net_torch.ops._build import LaunchCounts, load_library

LAUNCHES = LaunchCounts(("logits_conv",))


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
