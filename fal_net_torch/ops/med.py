"""MED (Mirrored Exponential Disparity) probability-volume head, plain PyTorch.

Counterpart of fal_net_tpu/ops/med.py, in NCHW: logits ``(B, N, H, W)``,
image ``(B, C, H, W)``.  This is the oracle the CUDA kernel
(:mod:`fal_net_torch.ops.med_kernel`) is held against, and the head the
model runs on CPU tensors, where the kernel cannot run.

Semantics kept exactly (reference models/FAL_netB.py:200-297):
  * plane disparities d_n = max_disp * r**(c_n - 1), r = max/min,
    c_n = n/(N-1), and shifts s_n = d_n * (W-1)/W, computed in float64 and
    rounded once, as the TPU kernel's host tables are
    (med_pallas.py::_plane_tables): the plain head and the CUDA kernel then
    sample at the same positions (fal_net_tpu/ops/med.py computes them in
    fp32, up to 3e-5 px apart at s ~ 300 px);
  * disparity = softmax expectation over planes;
  * Dprob = softmax over planes of the *shifted logits*, where the shift
    pads with zero LOGITS (not -inf): out-of-range columns still count
    exp(0) in the softmax;
  * pan = sum_n shift(image, +s_n) * Dprob_n, s_n = d_n * (W-1)/W;
  * maskR / maskL from stop-gradient volumes, clamped to <= 1; maskR
    normalizes its softmax before it shifts;
  * ``maskr_quirk`` (opt-in): FAL_netA's maskR resample, for parity with
    published A checkpoints (:func:`fal_net_torch.ops.shift.hshift_planes_quirk`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fal_net_torch.ops.shift import hshift_planes, hshift_planes_quirk


class MedOutputs(NamedTuple):
    """Outputs of the MED head (NCHW); unrequested fields are None."""

    pan: Optional[torch.Tensor]  # (B, C, H, W) synthesized right view
    disp: Optional[torch.Tensor]  # (B, 1, H, W) disparity, pixels
    maskL: Optional[torch.Tensor]  # (B, 1, H, W) left-visible-in-right mask
    maskR: Optional[torch.Tensor]  # (B, 1, H, W) right-visible-in-left mask


def disparity_levels(min_disp, max_disp, num_levels: int, *, device=None) -> torch.Tensor:
    """Exponentially spaced plane disparities in pixels, float64, shape (..., N)."""
    min_disp = torch.as_tensor(min_disp, dtype=torch.float64, device=device)
    max_disp = torch.as_tensor(max_disp, dtype=torch.float64, device=device)
    c = torch.arange(num_levels, dtype=torch.float64, device=max_disp.device) / (
        num_levels - 1
    )
    return max_disp[..., None] * torch.exp(
        torch.log(max_disp / min_disp)[..., None] * (c - 1.0)
    )


def pixel_shifts(
    min_disp, max_disp, num_levels: int, width: int, *, device=None
) -> torch.Tensor:
    """Per-plane shifts in pixels (float64) as the reference's
    align_corners=True sampler applies them: a normalized offset 2d/W moves
    d*(W-1)/W pixels."""
    return disparity_levels(min_disp, max_disp, num_levels, device=device) * (
        (width - 1) / width
    )


def disparity_expectation(probs: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """``sum_n levels[n] * probs[:, n]``: probs (B, N, H, W), levels (N,)
    -> (B, 1, H, W)."""
    return torch.einsum("bnhw,n->bhw", probs, levels)[:, None]


def med_outputs(
    logits: torch.Tensor,
    image: torch.Tensor,
    min_disp,
    max_disp,
    *,
    ret_disp: bool = True,
    ret_pan: bool = False,
    ret_subocc: bool = False,
    maskr_quirk: bool = False,
) -> MedOutputs:
    """The requested MED head outputs from plane logits.

    Args:
      logits: (B, N, H, W) post-1x1-conv plane logits.
      image: (B, C, H, W) network input view (for pan synthesis).
      min_disp / max_disp: Python floats, 0-d tensors, or (B,) tensors of
        per-sample disparity ranges in pixels.
      maskr_quirk: resample maskR as the reference FAL_netA does (its warp
        omits align_corners, models/FAL_netA.py:264).
    """
    min_t = torch.as_tensor(min_disp)
    if min_t.ndim > 0:
        # Per-sample ranges: run the scalar head on each sample.
        max_t = torch.as_tensor(max_disp)
        outs = [
            med_outputs(
                logits[i : i + 1], image[i : i + 1], min_t[i], max_t[i],
                ret_disp=ret_disp, ret_pan=ret_pan, ret_subocc=ret_subocc,
                maskr_quirk=maskr_quirk,
            )
            for i in range(logits.shape[0])
        ]
        return MedOutputs(
            *(
                None if parts[0] is None else torch.cat(parts)
                for parts in zip(*outs)
            )
        )

    num_levels, width = logits.shape[1], logits.shape[-1]
    levels = disparity_levels(min_disp, max_disp, num_levels, device=logits.device)
    shifts = levels * ((width - 1) / width)

    disp = pan = mask_l = mask_r = None
    if ret_disp:
        disp = disparity_expectation(torch.softmax(logits, dim=1), levels.to(logits.dtype))

    if ret_pan or ret_subocc:
        # Shift-then-softmax volume: zero-padded logit shift, softmax over
        # planes AFTER shifting.
        dprob = torch.softmax(hshift_planes(logits, shifts), dim=1)

        if ret_pan:
            # pan[c, x] = sum_n image[c, x + s_n] * Dprob[n, x]
            shifted_img = hshift_planes(image[:, :, None], shifts, plane_dim=2)
            pan = torch.einsum("bcnhw,bnhw->bchw", shifted_img, dprob)

        if ret_subocc:
            if maskr_quirk:
                mask_r = quirk_mask_r(logits, min_disp, max_disp)
            else:
                sm0 = torch.softmax(logits, dim=1).detach()
                mask_r = torch.clamp(hshift_planes(sm0, shifts).sum(dim=1, keepdim=True), max=1.0)
            mask_l = hshift_planes(dprob.detach(), -shifts).sum(dim=1, keepdim=True)
            mask_l = torch.clamp(mask_l, max=1.0)

    return MedOutputs(pan=pan, disp=disp, maskL=mask_l, maskR=mask_r)


def quirk_mask_r(logits: torch.Tensor, min_disp, max_disp) -> torch.Tensor:
    """maskR (B, 1, H, W) as the reference FAL_netA resamples it
    (:func:`fal_net_torch.ops.shift.hshift_planes_quirk`), clamped to <= 1,
    from a stop-gradient softmax.  Bounds as :func:`med_outputs` takes them."""
    min_t = torch.as_tensor(min_disp)
    if min_t.ndim > 0:
        max_t = torch.as_tensor(max_disp)
        return torch.cat([quirk_mask_r(logits[i : i + 1], min_t[i], max_t[i]) for i in range(logits.shape[0])])
    levels = disparity_levels(min_disp, max_disp, logits.shape[1], device=logits.device)
    sm0 = torch.softmax(logits, dim=1).detach()
    return torch.clamp(hshift_planes_quirk(sm0, levels).sum(dim=1, keepdim=True), max=1.0)
