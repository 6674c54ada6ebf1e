"""Image/volume ops: plain PyTorch versions, the CUDA kernels' wrappers and
the ``fal_net_torch`` PyTorch ops they launch through (ops/library.py)."""

from fal_net_torch.ops.shift import hshift, hshift_planes, hflip
from fal_net_torch.ops.med import (
    MedOutputs,
    disparity_expectation,
    disparity_levels,
    med_outputs,
    pixel_shifts,
)

from fal_net_torch.ops import library  # noqa: E402,F401  defines the fal_net_torch ops

__all__ = [
    "hshift",
    "hshift_planes",
    "hflip",
    "MedOutputs",
    "disparity_levels",
    "pixel_shifts",
    "disparity_expectation",
    "med_outputs",
]
