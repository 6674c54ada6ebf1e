"""Stage-1 loss assembly (counterpart of fal_net_tpu/train/stages.py,
reference Train_Stage1_K.py:210-262): the left view through the model with
disp and pan, masked L1 of the synthesized right view, and edge-aware
smoothness of the disparity.  ``stage1_slow_loss`` and ``stage2_loss`` wait
for the next slice.

Aux contract: every aux value is a per-batch MEAN scalar, so the trainer's
gradient accumulation may average it across microbatches.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from fal_net_torch.losses.photometric import rec_loss
from fal_net_torch.losses.smoothness import smoothness

VggFn = Optional[Callable[[torch.Tensor], Sequence[torch.Tensor]]]


def _disp_bounds(batch, min_disp, max_disp):
    """Per-sample disparity bounds.

    The reference feeds each sample's ``x_pix`` (+/- max_pix, sign-flipped
    on a random L/R swap when fix=False) into the model as the per-sample
    ``max_disp`` tensor, with ``min_disp`` scaled proportionally
    (Datasets/listdataset_train.py:74-81, Train_Stage1_K.py:227,237).  A
    batch without 'max_disp' (fix_order=True) uses the config's numbers.
    """
    mx = batch.get("max_disp")
    if mx is None:
        return min_disp, max_disp
    mx = torch.as_tensor(mx, dtype=torch.float32).reshape(-1)
    return mx * (min_disp / max_disp), mx


def stage1_loss(
    model,
    batch: Dict[str, torch.Tensor],
    *,
    min_disp: float,
    max_disp: float,
    a_p: float,
    a_sm: float,
    vgg_fn: VggFn = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: 'left', 'right' (B,3,H,W) normalized, optional 'max_disp' (B,)."""
    left, right = batch["left"], batch["right"]
    w = left.shape[-1]
    mn, mx = _disp_bounds(batch, min_disp, max_disp)
    out = model(left, mn, mx, ret_disp=True, ret_pan=True)
    rpan, ldisp = out.pan, out.disp

    vgg_right = vgg_fn(right) if (a_p > 0 and vgg_fn is not None) else None
    rec = rec_loss(1.0, rpan, right, vgg_right, a_p, vgg_fn)

    sm = torch.zeros((), device=left.device)
    if a_sm > 0:
        # ignore the left 20% dis-occluded columns (no parallax supervision)
        x0 = int(0.20 * w)
        sm = smoothness(left[..., x0:], ldisp[..., x0:], gamma=2.0)

    loss = rec + a_sm * sm
    return loss, {"rec_loss": rec, "sm_loss": sm, "loss": loss}
