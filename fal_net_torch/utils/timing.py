"""Timing on the card: CUDA events around single calls."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls of ``fn`` of the device time between CUDA
    events recorded before and after each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def tf32(enabled: bool):
    """Set TF32 for cuDNN convolutions and cuBLAS matmuls; restore on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
