"""The windowed roll: K5 (``csrc/roll_probe.cu``) and its plain version.

K5 replaces scripts/probe_roll_bug.py::make_fn.<locals>.kernel, the core of
the MED kernels' shift (fal_net_tpu/ops/med_pallas.py::_shift_sample)
stripped down: each row of ``x`` (H, W) sits at columns [left, left + W)
of a zero row of ``wp`` columns, the row is rolled left by a runtime
amount f, and the window is read back:

    out[h, j] = buf[h, (left + j + f) mod wp].

f is a (1,) int32 tensor, which the kernel reads from device memory as the
TPU kernel reads it from SMEM; any f wraps, negative or past the row.
The kernel launches through the op ``fal_net_torch::roll_window``, whose
CUDA impl (csrc/torch_ops.cpp) checks the tensors, allocates the output and
launches from C++; the C entry owns the size limits (the window inside the
row, the row in a block's shared memory) and the op raises when it refuses.
``LAUNCHES`` reads K5's launch count, which the op keeps.
"""

from __future__ import annotations

import torch

from fal_net_torch.ops._build import LaunchCounts, load_library

LAUNCHES = LaunchCounts(("roll_window",))


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
    Launches on the current stream and does not synchronize.  The op checks
    the rest in C++: the one Python step before it is the device check that
    keeps CPU tensors away from the op's plain CPU kernel (and a cached
    call that loads the kernels once)."""
    if not x.is_cuda:
        raise ValueError(f"the roll kernel needs x and f on one CUDA device; x is on {x.device}")
    load_library()
    return torch.ops.fal_net_torch.roll_window.default(x, f, wp, left)
