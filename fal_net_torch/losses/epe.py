"""Endpoint-error metrics, NCHW (counterpart of fal_net_tpu/losses/epe.py;
reference loss_functions.py:115-173).

``real_epe`` upsamples the prediction to the target's size (bilinear,
align_corners=True) and masks sparse targets (zeros are invalid); the
evaluation of KITTI 2015 reads it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fal_net_torch.ops.resize import resize_bilinear_align_corners


def epe(pred: torch.Tensor, target: torch.Tensor, sparse: bool = False, mean: bool = True) -> torch.Tensor:
    """The L2 norm over channels, averaged (over valid pixels where
    ``sparse``: target channel 0 nonzero, loss_functions.py:128-131), or
    summed and divided by the batch size without ``mean``."""
    epe_map = torch.linalg.vector_norm(target - pred, dim=1)  # (B, H, W)
    if sparse:
        valid = (target[:, 0] != 0).to(epe_map.dtype)
        if mean:
            return (epe_map * valid).sum() / valid.sum().clamp(min=1)
        return (epe_map * valid).sum() / epe_map.shape[0]
    if mean:
        return epe_map.mean()
    return epe_map.sum() / epe_map.shape[0]


def real_epe(pred: torch.Tensor, target: torch.Tensor, sparse: bool = False) -> torch.Tensor:
    """Upsample the prediction to the target's size (bilinear,
    align_corners=True), then the mean EPE."""
    up = resize_bilinear_align_corners(pred, target.shape[-2:], align_corners=True)
    return epe(up, target, sparse=sparse, mean=True)


def real_epe_np(pred_hw: np.ndarray, target_hw: np.ndarray) -> float:
    """:func:`real_epe` on the host for same-size single-channel disparity
    maps (the evaluation case: the upsample is the identity)."""
    if pred_hw.shape != target_hw.shape:
        raise ValueError(f"real_epe_np needs equal shapes, got {pred_hw.shape} and {target_hw.shape}")
    valid = (target_hw != 0).astype(pred_hw.dtype)
    return float((np.abs(pred_hw - target_hw) * valid).sum() / max(valid.sum(), 1.0))


def sparse_max_pool(x: torch.Tensor, size) -> torch.Tensor:
    """Adaptive max pool that keeps signed sparse values
    (loss_functions.py:141-146): positives and negatives pooled apart, so
    that zeros (invalid) never win over valid negatives."""
    pos = torch.where(x > 0, x, torch.zeros_like(x))
    neg = torch.where(x < 0, -x, torch.zeros_like(x))
    return F.adaptive_max_pool2d(pos, tuple(size)) - F.adaptive_max_pool2d(neg, tuple(size))


def multiscale_epe(outputs, target: torch.Tensor, weights=None, sparse: bool = False) -> torch.Tensor:
    """Weighted sum of per-scale EPEs (loss_functions.py:149-167): the
    target adaptively pooled (max for sparse, mean for dense) to each of
    ``outputs``' sizes."""
    if not isinstance(outputs, (tuple, list)):
        outputs = [outputs]
    if weights is None:
        weights = [0.001, 0.005, 0.01, 0.02, 0.08, 0.32]  # FlowNet's
    if len(weights) != len(outputs):
        raise ValueError(f"{len(weights)} weights for {len(outputs)} outputs")
    total = 0.0
    for out, weight in zip(outputs, weights):
        size = tuple(out.shape[-2:])
        scaled = sparse_max_pool(target, size) if sparse else F.adaptive_avg_pool2d(target, size)
        total = total + weight * epe(out, scaled, sparse, mean=False)
    return total
