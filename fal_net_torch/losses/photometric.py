"""Reconstruction (photometric + perceptual) loss (counterpart of
fal_net_tpu/losses/photometric.py).

Reference: ``rec_loss_fnc`` / ``perceptual_loss`` (loss_functions.py:52-67):

  rec = mean(mask * |synth - label|)
      + a_p * sum_{i<3} MSE(vgg_i(mask*synth + (1-mask)*label), vgg_i(label))

The composited image routes gradients only through the occlusion-visible
region; ``vgg_label`` features are computed once per step by the caller.
With ``rows`` (a :class:`~fal_net_torch.parallel.spatial.RowShard`), every
tensor holds this rank's rows and each mean is over every rank's rows.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from fal_net_torch.utils.trace import span


def perceptual_loss(
    out_features: Sequence[torch.Tensor],
    label_features: Sequence[torch.Tensor],
    layer: Optional[int] = None,
    rows=None,
) -> torch.Tensor:
    mean = torch.mean if rows is None else rows.mean
    if layer is not None:
        return mean(torch.square(out_features[layer] - label_features[layer]))
    total = 0.0
    for i in range(3):
        total = total + mean(torch.square(out_features[i] - label_features[i]))
    return total


def rec_loss(
    mask,
    synth: torch.Tensor,
    label: torch.Tensor,
    vgg_label: Optional[Sequence[torch.Tensor]],
    a_p: float,
    vgg_apply: Optional[Callable[[torch.Tensor], Sequence[torch.Tensor]]] = None,
    rows=None,
) -> torch.Tensor:
    """Masked L1 + optional perceptual term.

    ``mask`` may be a plain scalar 1 (stage-1 left-only training,
    Train_Stage1_K.py:246) or a (B,1,H,W) occlusion mask (stage 2).
    ``vgg_apply`` maps an image to its VGG feature tuple; required when
    ``a_p > 0`` and ``vgg_label`` is given.
    """
    loss = (torch.mean if rows is None else rows.mean)(mask * torch.abs(synth - label))
    if a_p > 0 and vgg_label is not None:
        composited = mask * synth + (1 - mask) * label
        with span("loss.perceptual"):
            features = vgg_apply(composited)
        loss = loss + a_p * perceptual_loss(features, vgg_label, rows=rows)
    return loss
