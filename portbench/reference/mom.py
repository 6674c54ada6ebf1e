"""The stage-2 training step (MOM distillation) in plain PyTorch, from the
published description (Train_Stage2_K.py:246-331, loss_functions.py,
FAL_netB.py:200-297 of the authors' code), for the benchmark's check of
the stage-2 cell.  Run it in fp32 with TF32 off.

With B pairs (left, right), W columns, x0 = int(0.2 W), x1 = int(0.8 W):

  * the frozen teacher, without autograd, on the mirrored double batch
    [hflip(left) | right]: mldisp = hflip(its first B disparities), mrdisp
    = its last B;
  * the student on [left | hflip(right)]: disp and pan (reference/med.py),
    and both sub-occlusion masks from stop-gradient volumes, plane by plane
    (:func:`masks`): maskR = sum_n shift(softmax(logits)_n, +s_n) and maskL
    = sum_n shift(Dprob_n, -s_n), each clamped to at most 1;
  * the occlusion masks O_L = lmask lrmask with the left x0 columns forced
    to 1, O_R = rmask rlmask with the columns from x1 on forced to 1;
  * loss = (rec(O_R, rpan, right) + rec(O_L, lpan, left)) / 2
         + a_sm (smoothness(left[x0:], ldisp[x0:]) + smoothness(right[:x1], rdisp[:x1])) / 2
         + a_mr (mean((1 - O_L) |ldisp - mldisp| / max mldisp)[x0:]
                 + mean((1 - O_R) |rdisp - mrdisp| / max mrdisp)[:x1]) / 2,
    rec(O, synth, label) = mean(O |synth - label|) + a_p sum_{i<3}
    mean((vgg_i(O synth + (1 - O) label) - vgg_i(label))^2), each maximum
    over one image.

The optimizer is reference/train.py's Adam, written out.
"""

from __future__ import annotations

import torch

from portbench.reference import med, train as ref_train


def hflip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, (-1,))


def masks(logits: torch.Tensor, min_disp: float, max_disp: float):
    """(maskL, maskR), each (B,1,H,W), from the logits (B,N,H,W) without
    their gradient, one plane at a time."""
    n, w = logits.shape[1], logits.shape[-1]
    s = (med.levels(min_disp, max_disp, n) * ((w - 1) / w)).tolist()
    lg = logits.detach()
    prob = torch.softmax(lg, 1)
    dprob = torch.softmax(torch.stack([med.shift(lg[:, i], s[i]) for i in range(n)], 1), 1)
    mask_r = sum(med.shift(prob[:, i:i + 1], s[i]) for i in range(n))
    mask_l = sum(med.shift(dprob[:, i:i + 1], -s[i]) for i in range(n))
    return mask_l.clamp(max=1.0), mask_r.clamp(max=1.0)


def rec_loss(vgg, mask, synth, label, a_p):
    loss = (mask * (synth - label).abs()).mean()
    if a_p > 0:
        with torch.no_grad():
            want = vgg(label)
        got = vgg(mask * synth + (1 - mask) * label)
        loss = loss + a_p * sum(((g - lab) ** 2).mean() for g, lab in zip(got, want))
    return loss


def stage2_loss(student, teacher, vgg, left, right, min_disp, max_disp, a_p, a_sm, a_mr):
    """(loss, {"rec_loss", "sm_loss", "mirror_loss", "loss"}) of one batch
    of pairs; ``student`` and ``teacher`` are reference/falnet.py models."""
    b, w = left.shape[0], left.shape[-1]
    x0, x1 = int(0.2 * w), int(0.8 * w)
    with torch.no_grad():
        t_disp, _ = teacher(torch.cat([hflip(left), right]), min_disp, max_disp)
    mldisp, mrdisp = hflip(t_disp[:b]), t_disp[b:]

    pair = torch.cat([left, hflip(right)])
    logits = student.logits(pair, max_disp)
    disp, pan = med.head(logits, pair, min_disp, max_disp, pan=True)
    mask_l, mask_r = masks(logits, min_disp, max_disp)
    rpan, lpan = pan[:b], hflip(pan[b:])
    ldisp, rdisp = disp[:b], hflip(disp[b:])
    lmask, rmask = mask_l[:b], hflip(mask_l[b:])
    rlmask, lrmask = mask_r[:b], hflip(mask_r[b:])

    col = torch.arange(w, device=left.device)
    o_l = torch.where(col < x0, 1.0, lmask * lrmask)
    o_r = torch.where(col >= x1, 1.0, rmask * rlmask)

    rec = (rec_loss(vgg, o_r, rpan, right, a_p) + rec_loss(vgg, o_l, lpan, left, a_p)) / 2
    sm = (ref_train.smoothness(left[..., x0:], ldisp[..., x0:])
          + ref_train.smoothness(right[..., :x1], rdisp[..., :x1])) / 2
    top_l = mldisp.amax(dim=(1, 2, 3), keepdim=True)
    top_r = mrdisp.amax(dim=(1, 2, 3), keepdim=True)
    mirror = (((1 - o_l) * (ldisp - mldisp).abs() / top_l)[..., x0:].mean()
              + ((1 - o_r) * (rdisp - mrdisp).abs() / top_r)[..., :x1].mean()) / 2
    loss = rec + a_sm * sm + a_mr * mirror
    return loss, {"rec_loss": rec, "sm_loss": sm, "mirror_loss": mirror, "loss": loss}
