"""Evaluation: the KITTI and Make3D metric suites, post-processing, the
Evaluator (evaluate.py), the exporters and the batched disparity pipeline.
The names are JAX's (fal_net_tpu/eval/__init__.py)."""

from fal_net_torch.eval.metrics import (
    KITTI_ERROR_NAMES,
    WIDTH_TO_BASELINE,
    WIDTH_TO_FOCAL,
    compute_kitti_errors,
    compute_make_errors,
    disps_to_depths_kitti,
    disps_to_depths_kitti2015,
    disps_to_depths_make,
    image_mae,
    image_psnr,
    image_rmse,
)
from fal_net_torch.eval.postprocess import flip_post_process, ms_post_process

__all__ = [
    "KITTI_ERROR_NAMES",
    "WIDTH_TO_FOCAL",
    "WIDTH_TO_BASELINE",
    "compute_kitti_errors",
    "compute_make_errors",
    "disps_to_depths_kitti",
    "disps_to_depths_kitti2015",
    "disps_to_depths_make",
    "image_rmse",
    "image_mae",
    "image_psnr",
    "flip_post_process",
    "ms_post_process",
]
