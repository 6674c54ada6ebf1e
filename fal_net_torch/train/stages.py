"""Loss assemblies of the three training strategies (counterpart of
fal_net_tpu/train/stages.py).  The reference's three training scripts differ
only in how the loss is assembled around the same model:

  * stage1      -- the left view through the model with disp and pan, masked
                   L1 of the synthesized right view, edge-aware smoothness
                   (Train_Stage1_K.py:210-262);
  * stage1_slow -- the double batch [left | hflip(right)] through one
                   forward, losses on both views (Train_Stage1_Kslow.py:237-283);
  * stage2      -- MOM distillation: a frozen teacher's disparities of the
                   mirrored pair, the student's double batch with
                   sub-occlusion masks, occlusion-masked reconstruction and
                   a mirror loss (Train_Stage2_K.py:246-331).

NCHW throughout: every horizontal flip is along the last dim.

Aux contract: every aux value is a per-batch MEAN scalar, so the trainer's
gradient accumulation may average it across microbatches.

``rows`` (a :class:`~fal_net_torch.parallel.spatial.RowShard`; the model and
the teacher split rows over its ranks, ``FalNet.with_spatial``): the batch is
the whole images on every rank of the group, the model returns this rank's
rows, the labels are sliced to them, and every mean is over all the group's
rows (``rows.mean``), stage 2's per-image teacher maximum over them too, so
every rank's loss is the whole batch's and its gradient its own rows' share.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import functools

import torch

from fal_net_torch.losses.photometric import rec_loss
from fal_net_torch.losses.smoothness import smoothness
from fal_net_torch.ops.shift import hflip
from fal_net_torch.utils.trace import span

VggFn = Optional[Callable[[torch.Tensor], Sequence[torch.Tensor]]]
Aux = Dict[str, torch.Tensor]


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


def _stacked(bounds):
    """Bounds of the [view | flipped other view] double batch
    (torch.cat((max_disp, max_disp)), Train_Stage1_Kslow.py:248): per-sample
    tensors repeat, numbers stay."""
    mn, mx = bounds
    if isinstance(mx, torch.Tensor) and mx.ndim > 0:
        return torch.cat([mn, mn]), torch.cat([mx, mx])
    return mn, mx


def _label_features(vgg_fn, *images):
    """VGG features of the real views, the perceptual term's labels: the
    loss's constants, computed without autograd (the VGG is frozen and the
    views are data, so no gradient reaches them either way)."""
    with torch.no_grad(), span("loss.perceptual"):
        return tuple(vgg_fn(im) for im in images)


def _on_rows(rows, left, right, vgg_fn):
    """The views' rows that this rank's outputs cover, and ``vgg_fn`` on such
    rows (the views themselves without ``rows``)."""
    if rows is None:
        return left, right, vgg_fn
    if vgg_fn is not None:
        vgg_fn = functools.partial(vgg_fn, rows=rows, height=left.shape[-2])
    return rows.split(left), rows.split(right), vgg_fn


def _two_sided(left, right, ldisp, rdisp, lpan, rpan, rec_masks, a_p, a_sm, vgg_fn, rows=None):
    """The reconstruction of both views and the smoothness of both
    disparities, each the mean of its two sides.  ``rec_masks`` is
    (mask of the left view's loss, mask of the right view's).  With
    ``rows``, the views, outputs and masks are this rank's rows."""
    w = left.shape[-1]
    x0, x1 = int(0.20 * w), int(0.80 * w)
    if a_p > 0 and vgg_fn is not None:
        vgg_right, vgg_left = _label_features(vgg_fn, right, left)
    else:
        vgg_right = vgg_left = None
    o_l, o_r = rec_masks
    rec = (
        rec_loss(o_r, rpan, right, vgg_right, a_p, vgg_fn, rows=rows)
        + rec_loss(o_l, lpan, left, vgg_left, a_p, vgg_fn, rows=rows)
    ) / 2.0
    sm = torch.zeros((), device=left.device)
    if a_sm > 0:
        # the left view's left 20% and the right view's right 20% are
        # dis-occluded: no parallax supervision there
        sm = (
            smoothness(left[..., x0:], ldisp[..., x0:], gamma=2.0, rows=rows)
            + smoothness(right[..., :x1], rdisp[..., :x1], gamma=2.0, rows=rows)
        ) / 2.0
    return rec, sm


def stage1_loss(
    model,
    batch: Dict[str, torch.Tensor],
    *,
    min_disp: float,
    max_disp: float,
    a_p: float,
    a_sm: float,
    vgg_fn: VggFn = None,
    rows=None,
) -> Tuple[torch.Tensor, Aux]:
    """batch: 'left', 'right' (B,3,H,W) normalized, optional 'max_disp' (B,)."""
    left, right = batch["left"], batch["right"]
    w = left.shape[-1]
    mn, mx = _disp_bounds(batch, min_disp, max_disp)
    out = model(left, mn, mx, ret_disp=True, ret_pan=True)
    rpan, ldisp = out.pan, out.disp
    left, right, vgg_fn = _on_rows(rows, left, right, vgg_fn)

    vgg_right = _label_features(vgg_fn, right)[0] if (a_p > 0 and vgg_fn is not None) else None
    rec = rec_loss(1.0, rpan, right, vgg_right, a_p, vgg_fn, rows=rows)

    sm = torch.zeros((), device=left.device)
    if a_sm > 0:
        # ignore the left 20% dis-occluded columns (no parallax supervision)
        x0 = int(0.20 * w)
        sm = smoothness(left[..., x0:], ldisp[..., x0:], gamma=2.0, rows=rows)

    loss = rec + a_sm * sm
    return loss, {"rec_loss": rec, "sm_loss": sm, "loss": loss}


def stage1_slow_loss(
    model,
    batch: Dict[str, torch.Tensor],
    *,
    min_disp: float,
    max_disp: float,
    a_p: float,
    a_sm: float,
    vgg_fn: VggFn = None,
    rows=None,
) -> Tuple[torch.Tensor, Aux]:
    """Both views through one forward of the double batch; the right view's
    outputs come back un-flipped."""
    left, right = batch["left"], batch["right"]
    b = left.shape[0]
    mn, mx = _stacked(_disp_bounds(batch, min_disp, max_disp))
    out = model(torch.cat([left, hflip(right)]), mn, mx, ret_disp=True, ret_pan=True)
    rpan, lpan = out.pan[:b], hflip(out.pan[b:])
    ldisp, rdisp = out.disp[:b], hflip(out.disp[b:])
    left, right, vgg_fn = _on_rows(rows, left, right, vgg_fn)
    rec, sm = _two_sided(left, right, ldisp, rdisp, lpan, rpan, (1.0, 1.0), a_p, a_sm, vgg_fn, rows)
    loss = rec + a_sm * sm
    return loss, {"rec_loss": rec, "sm_loss": sm, "loss": loss}


def stage2_loss(
    model,
    batch: Dict[str, torch.Tensor],
    teacher,
    *,
    min_disp: float,
    max_disp: float,
    a_p: float,
    a_sm: float,
    a_mr: float,
    vgg_fn: VggFn = None,
    rows=None,
) -> Tuple[torch.Tensor, Aux]:
    """MOM distillation.  ``teacher`` is the frozen stage-1 model: it runs
    under ``torch.no_grad()`` (JAX's stop_gradient), so autograd keeps none
    of its activations.  The student's masks are stop-gradient in both MED
    heads, so the occlusion masks weigh the losses as constants."""
    left, right = batch["left"], batch["right"]
    b, w = left.shape[0], left.shape[-1]
    x0, x1 = int(0.20 * w), int(0.80 * w)
    mn, mx = _stacked(_disp_bounds(batch, min_disp, max_disp))

    # Teacher (frozen): disparities of the mirrored pair.
    if a_mr > 0:
        with torch.no_grad():
            t_disp = teacher(torch.cat([hflip(left), right]), mn, mx, ret_disp=True).disp
        mldisp, mrdisp = hflip(t_disp[:b]), t_disp[b:]

    # Student: double batch with sub-occlusion masks.
    out = model(torch.cat([left, hflip(right)]), mn, mx, ret_disp=True, ret_pan=True, ret_subocc=True)
    rpan, lpan = out.pan[:b], hflip(out.pan[b:])
    ldisp, rdisp = out.disp[:b], hflip(out.disp[b:])
    lmask, rmask = out.maskL[:b], hflip(out.maskL[b:])
    rlmask, lrmask = out.maskR[:b], hflip(out.maskR[b:])
    left, right, vgg_fn = _on_rows(rows, left, right, vgg_fn)

    if a_mr > 0:
        # occlusion masks with the dis-occluded borders forced visible
        # (Train_Stage2_K.py:296-299)
        col = torch.arange(w, device=left.device).reshape(1, 1, 1, w)
        o_l = torch.where(col < x0, 1.0, lmask * lrmask)
        o_r = torch.where(col >= x1, 1.0, rmask * rlmask)
    else:
        o_l = o_r = 1.0  # "just more training" (Train_Stage2_K.py:300-302)

    rec, sm = _two_sided(left, right, ldisp, rdisp, lpan, rpan, (o_l, o_r), a_p, a_sm, vgg_fn, rows)

    mirror = torch.zeros((), device=left.device)
    if a_mr > 0:
        # normalized by each image's largest teacher disparity
        amax = functools.partial(torch.amax, dim=(1, 2, 3), keepdim=True) if rows is None else rows.amax
        mean = torch.mean if rows is None else rows.mean
        nmaxl, nmaxr = 1.0 / amax(mldisp), 1.0 / amax(mrdisp)
        mirror = (
            mean(nmaxl * (1.0 - o_l)[..., x0:] * torch.abs(ldisp - mldisp)[..., x0:])
            + mean(nmaxr * (1.0 - o_r)[..., :x1] * torch.abs(rdisp - mrdisp)[..., :x1])
        ) / 2.0

    loss = rec + a_sm * sm + a_mr * mirror
    return loss, {"rec_loss": rec, "sm_loss": sm, "mirror_loss": mirror, "loss": loss}
