"""Running-average meters and the parameter count (counterpart of
fal_net_tpu/utils/meters.py, reference myUtils.py:59-120)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from torch import nn


def count_params(model: nn.Module) -> int:
    """Total parameter count (reference get_n_params, myUtils.py:113-120)."""
    return sum(p.numel() for p in model.parameters())


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


class MultiAverageMeter:
    """Vector meter with named components (reference multiAverageMeter)."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self.reset()

    def reset(self):
        self.val = np.zeros(len(self.names))
        self.sum = np.zeros(len(self.names))
        self.count = 0

    def update(self, vals, n: int = 1):
        vals = np.asarray(vals, dtype=np.float64)
        self.val = vals
        self.sum += vals * n
        self.count += n

    @property
    def avg(self) -> np.ndarray:
        return self.sum / self.count if self.count else self.sum * 0.0

    def __repr__(self):
        return "\n".join(f"  {name:10s} {v:.4f}" for name, v in zip(self.names, self.avg))
