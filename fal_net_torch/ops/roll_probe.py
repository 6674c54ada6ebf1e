"""The windowed roll: K5 (``csrc/roll_probe.cu``) and its plain version.

K5 replaces scripts/probe_roll_bug.py::make_fn.<locals>.kernel, the core of
the MED kernels' shift (fal_net_tpu/ops/med_pallas.py::_shift_sample)
stripped down: each row of ``x`` (H, W) sits at columns [left, left + W)
of a zero row of ``wp`` columns, the row is rolled left by a runtime
amount f, and the window is read back:

    out[h, j] = buf[h, (left + j + f) mod wp].

f is a (1,) int32 tensor, which the kernel reads from device memory as the
TPU kernel reads it from SMEM; any f wraps, negative or past the row.
The C entry owns the size limits (the window inside the row, the row in a
block's shared memory) and the wrapper raises when it refuses.
``LAUNCHES`` counts K5's launches.
"""

from __future__ import annotations

import torch

from fal_net_torch.ops._build import launch

LAUNCHES = {"roll_window": 0}


def roll_window_plain(x: torch.Tensor, f, wp: int, left: int = 128) -> torch.Tensor:
    """K5's function; ``f`` is an int or a (1,) integer tensor."""
    h, w = x.shape
    buf = x.new_zeros((h, wp))
    buf[:, left : left + w] = x
    f = torch.as_tensor(f, device=x.device).reshape(-1)[:1].long()
    idx = torch.remainder(left + torch.arange(w, device=x.device) + f, wp)
    return buf[:, idx]


def roll_window(x: torch.Tensor, f: torch.Tensor, wp: int, left: int = 128) -> torch.Tensor:
    """K5 on CUDA fp32 ``x`` (H, W) and int32 ``f`` (1,) on the same device.
    Launches on the current stream and does not synchronize."""
    if not (x.is_cuda and isinstance(f, torch.Tensor) and f.device == x.device):
        raise ValueError(f"the roll kernel needs x and f on one CUDA device; x is on {x.device}")
    if x.dtype != torch.float32 or f.dtype != torch.int32:
        raise TypeError(f"the roll kernel takes float32 x and int32 f, got {x.dtype} and {f.dtype}")
    if x.ndim != 2 or not x.is_contiguous() or f.shape != (1,):
        raise ValueError(f"x must be a contiguous (H, W) and f a (1,) tensor, got {tuple(x.shape)}, {tuple(f.shape)}")
    h, w = x.shape
    out = torch.empty_like(x)
    launch("roll_window", x.device, x.data_ptr(), f.data_ptr(), out.data_ptr(), h, w, wp, left)
    LAUNCHES["roll_window"] += 1
    return out
