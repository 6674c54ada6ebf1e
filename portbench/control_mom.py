"""The readings the stage-2 cell's correctness limits are set from, on the
card (portbench/control.py's, for the ``train_mom`` driver):

    python3 portbench/control_mom.py --workload b49_train_stage2_b4 --seeds 1 2 ...
        [--kinds sound control faults] [--seconds 2] [--out FILE]

For each seed, one short run of the cell of each kind, in one process,
each printing one JSON line with the numbers its check compared:

  * ``sound`` and ``control`` (the program's own bfloat16 path) as
    control.py takes them;
  * faults planted in the program's stage-2 step, underneath the timed path:
    ``unmirrored_teacher`` (the teacher fed [left | hflip(right)], the
    student's pair, in place of the mirrored one), ``open_borders`` (the
    occlusion masks' dis-occluded borders not forced visible),
    ``mask_gradient`` (the sub-occlusion masks carry their gradient to the
    logits: the same values, and a gradient through them) and
    ``maskr_unnormalised`` (maskR's planes shifted before the softmax
    normalises them: the sum of the shifted logits' softmax, all ones).

The benchmark's own runs never run this; tests/test_portbench_mom.py plants
the same faults small on the CPU.
"""

import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import control  # noqa: E402

FAULTS = ("unmirrored_teacher", "open_borders", "mask_gradient", "maskr_unnormalised")


class _OpenBorders:
    """``torch`` for train/stages.py, whose ``where`` drops its condition:
    the stage-2 occlusion masks are the masks' product at every column."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def where(condition, forced, masks):
        return masks


def _subocc_masks(logits, min_disp, max_disp, unnormalised=False):
    """(maskL, maskR) of the plain head's math with their gradient; maskR's
    planes shifted before the softmax with ``unnormalised``."""
    from fal_net_torch.ops.med import pixel_shifts
    from fal_net_torch.ops.shift import hshift_planes

    shifts = pixel_shifts(min_disp, max_disp, logits.shape[1], logits.shape[-1], device=logits.device)
    dprob = torch.softmax(hshift_planes(logits, shifts), 1)
    mask_l = hshift_planes(dprob, -shifts).sum(1, keepdim=True).clamp(max=1.0)
    prob_r = dprob if unnormalised else hshift_planes(torch.softmax(logits, 1), shifts)
    return mask_l, prob_r.sum(1, keepdim=True).clamp(max=1.0)


def fault(kind: str):
    """A context that plants the fault ``kind`` in the program's stage-2 step."""
    from fal_net_torch.models.falnet import FalNet
    from fal_net_torch.ops.shift import hflip
    from fal_net_torch.train import stages
    from fal_net_torch.train.trainer import Trainer

    if kind == "unmirrored_teacher":
        loss = Trainer._loss

        def unmirrored(self, batch):
            teacher = self.teacher
            self.teacher = lambda x, *a, **kw: teacher(hflip(x), *a, **kw)
            try:
                return loss(self, batch)
            finally:
                self.teacher = teacher

        return mock.patch.object(Trainer, "_loss", unmirrored)
    if kind == "open_borders":
        return mock.patch.object(stages, "torch", _OpenBorders())
    if kind in ("mask_gradient", "maskr_unnormalised"):
        med = FalNet._med

        def faulty(self, logits, image, min_disp, max_disp, **kw):
            out = med(self, logits, image, min_disp, max_disp, **kw)
            if not kw.get("ret_subocc"):
                return out
            if kind == "mask_gradient":  # the kernel's values, with the plain masks' gradient
                mask_l, mask_r = _subocc_masks(logits, min_disp, max_disp)
                return out._replace(maskL=out.maskL + (mask_l - mask_l.detach()),
                                    maskR=out.maskR + (mask_r - mask_r.detach()))
            return out._replace(maskR=_subocc_masks(logits.detach(), min_disp, max_disp, unnormalised=True)[1])

        return mock.patch.object(FalNet, "_med", faulty)
    raise ValueError(f"no fault {kind!r}; have {FAULTS}")


def main(argv=None) -> int:
    """control.py's command, with this module's faults for the stage-2 driver."""
    with mock.patch.dict(control.FAULTS, {"train_mom": FAULTS}), \
            mock.patch.object(control, "fault", lambda kind, driver: fault(kind)):
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
