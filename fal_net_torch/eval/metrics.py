"""KITTI and Make3D depth metrics, and image metrics (counterpart of
fal_net_tpu/eval/metrics.py; reference myUtils.py:123-334).

The depth metrics run on the host in numpy, per image, with the
reference's exact semantics; the protocol constants (focal length and
baseline per image width, the Garg crop, depth caps) are data, with their
sources.  The image metrics take NCHW tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

KITTI_ERROR_NAMES = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]

# KITTI camera intrinsics keyed by image width (myUtils.py:177-191).
WIDTH_TO_FOCAL = {
    1242: 721.5377,
    1241: 718.856,
    1224: 707.0493,
    1238: 718.3351,
    1226: 707.0912,
    1280: 738.2355,  # focal length upscaled
}
WIDTH_TO_BASELINE = {
    1242: 0.9982 * 0.54,
    1241: 0.9848 * 0.54,
    1224: 1.0144 * 0.54,
    1238: 0.9847 * 0.54,
    1226: 0.9765 * 0.54,
    1280: 0.54,
}

# Garg crop: rows [H-219, H-4), columns [44, 1180) (myUtils.py:265).
GARG_CROP = (219, 4, 44, 1180)


def compute_kitti_errors(
    gt: np.ndarray,
    pred: np.ndarray,
    use_median: bool = False,
    min_d: float = 1.0,
    max_d: float = 80.0,
    scale_out: list | None = None,
) -> List[float]:
    """The 7 KITTI depth metrics on valid (gt > 0) pixels
    (myUtils.py:196-231).  Under ``use_median`` the per-image scale factor
    is appended to ``scale_out`` (the reference keeps a running mean in
    module globals, myUtils.py:193-207)."""
    mask = gt > 0
    gt = gt[mask]
    pred = pred[mask]
    if use_median:
        factor = np.median(gt) / np.median(pred)
        pred = factor * pred
        if scale_out is not None:
            scale_out.append(float(factor))
    pred = np.clip(pred, min_d, max_d)
    gt = np.clip(gt, min_d, max_d)
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())
    rmse = float(np.sqrt(np.mean((gt - pred) ** 2)))
    rmse_log = float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2)))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    return [abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3]


def disps_to_depths_kitti2015(gt_disps, pred_disps) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """KITTI 2015: ground truth and prediction are both disparities
    (myUtils.py:234-253)."""
    gt_depths, pred_depths = [], []
    for gt_disp, pred_disp in zip(gt_disps, pred_disps):
        width = gt_disp.shape[1]
        gt_mask = gt_disp > 0
        pred_mask = pred_disp > 0
        gt_depth = WIDTH_TO_FOCAL[width] * 0.54 / (gt_disp + (1.0 - gt_mask))
        pred_depth = WIDTH_TO_FOCAL[width] * 0.54 / (pred_disp + (1.0 - pred_mask))
        gt_depths.append(gt_mask * gt_depth)
        pred_depths.append(pred_depth)
    return gt_depths, pred_depths


def disps_to_depths_kitti(gt_depths_in, pred_disps) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Eigen protocol: the ground truth is depth; Garg crop; the predicted
    disparity to depth by the width's focal length and baseline
    (myUtils.py:256-277)."""
    top, bottom, left, right = GARG_CROP
    gt_depths, pred_depths = [], []
    for gt, pred_disp in zip(gt_depths_in, pred_disps):
        height, width = gt.shape
        gt = gt[height - top : height - bottom, left:right]
        pred_disp = pred_disp[height - top : height - bottom, left:right]
        gt_mask = gt > 0
        pred_mask = pred_disp > 0
        pred_depth = WIDTH_TO_FOCAL[width] * WIDTH_TO_BASELINE[width] / (pred_disp + (1.0 - pred_mask))
        gt_depths.append(gt_mask * gt)
        pred_depths.append(pred_depth)
    return gt_depths, pred_depths


def disps_to_depths_make(
    gt_depths_in, pred_disps, min_d: float = 1.0, max_d: float = 70.0
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Make3D: median scaling, a 70 m cap, f = 721 and b = 0.22
    (myUtils.py:280-309)."""
    gt_out, pred_out = [], []
    for gt, pred_disp in zip(gt_depths_in, pred_disps):
        gt_mask = (gt > 0) * (gt < max_d)
        pred_mask = pred_disp > 0
        pred_depth = 721 * 0.22 / (pred_disp + (1.0 - pred_mask))
        gt_v = gt[gt_mask]
        pred_v = pred_depth[gt_mask]
        factor = np.median(gt_v) / np.median(pred_v)
        gt_out.append(np.clip(gt_v, min_d, max_d))
        pred_out.append(np.clip(factor * pred_v, min_d, max_d))
    return gt_out, pred_out


def compute_make_errors(gt: np.ndarray, pred: np.ndarray) -> List[float]:
    """The Make3D suite: abs_rel, sq_rel, rms, log10, a1-a3 (myUtils.py:312-334)."""
    mask = gt > 0
    gt = gt[mask]
    pred = pred[mask]
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())
    rmse = float(np.sqrt(np.mean((gt - pred) ** 2)))
    log10 = float(np.mean(np.abs(np.log10(gt) - np.log10(pred))))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    return [abs_rel, sq_rel, rmse, log10, a1, a2, a3]


# --- image metrics in the 0-255 domain (myUtils.py:123-172), NCHW ---

RGB_MEAN = (0.411, 0.432, 0.45)


def _mean(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(RGB_MEAN, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)


def _denorm255(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + _mean(x)) * 255.0, 0.0, 255.0)


def image_rmse(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The output clipped to [0, 255], the label only de-normalized
    (myUtils.py:138-150)."""
    return torch.sqrt(torch.mean(torch.square(_denorm255(output) - (label + _mean(label)) * 255.0)))


def image_rmse_np(output: np.ndarray, label: np.ndarray) -> float:
    """:func:`image_rmse` on the host for fetched HWC images, per image: the
    validation's view-synthesis RMSE, with no device round trip a frame."""
    mean = np.asarray(RGB_MEAN, output.dtype)
    out = np.clip((output + mean) * 255.0, 0.0, 255.0)
    return float(np.sqrt(np.mean(np.square(out - (label + mean) * 255.0))))


def image_mae(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_denorm255(output) - (label + _mean(label)) * 255.0))


def image_psnr(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    rmse = torch.sqrt(torch.mean(torch.square(torch.round(_denorm255(output)) - (label + _mean(label)) * 255.0)))
    return 20.0 * torch.log10(255.0 / rmse)
