"""Image/volume ops: plain PyTorch versions and the CUDA MED kernel's wrapper."""

from fal_net_torch.ops.shift import hshift, hshift_planes, hflip
from fal_net_torch.ops.med import (
    MedOutputs,
    disparity_expectation,
    disparity_levels,
    med_outputs,
    pixel_shifts,
)

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
