"""Running-average meter (counterpart of fal_net_tpu/utils/meters.py,
reference myUtils.py:59-110)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __repr__(self):
        return f"{self.val:.3f} ({self.avg:.3f})"
