"""The decoder's nearest 2x upsample and 3x3 conv as one transposed conv
(counterpart of fal_net_tpu/ops/phase_deconv.py).

``nearest_up2(x) = dilate2(x) (*) ones(2, 2)``, so ``conv3x3(nearest_up2(x))``
is one input-dilated conv with the composed 4x4 kernel ``ones(2, 2) (*) w3``:
in NCHW, a stride-2 transposed conv of ``x`` with that kernel flipped and its
channel axes swapped.  The same sums in another order (fp32 rounding apart),
with 2.25x fewer multiply-adds than the 3x3 conv over the 2x tensor, which is
never materialized.  It holds where the upsample is exactly 2x; the decoder's
:class:`fal_net_torch.models.layers.Deconv` falls back to the plain path
elsewhere.  No hand-written kernel: cuDNN runs the transposed conv on the card,
as XLA's conv serves JAX's form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def composed_kernel(w3: torch.Tensor) -> torch.Tensor:
    """OIHW ``(Cout, Cin, 3, 3)`` -> ``(Cout, Cin, 4, 4)``: the 3x3 kernel
    correlated with ones(2, 2) on each spatial axis, in ``w3``'s dtype and
    summed in JAX's order (``k[t, u] = sum_{r, s in {0, 1}} w3[t - r, u - s]``)."""
    # F.pad's (left, right, top, bottom) places w3[t - r, u - s] at [t, u]
    return (F.pad(w3, (0, 1, 0, 1)) + F.pad(w3, (1, 0, 0, 1))) + F.pad(w3, (0, 1, 1, 0)) + F.pad(w3, (1, 0, 1, 0))


def conv3x3_on_up2(x: torch.Tensor, w3: torch.Tensor, halo: int = 0) -> torch.Tensor:
    """``F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w3,
    padding=1)`` without the upsample: x ``(B, Cin, H, W)``, w3 OIHW
    ``(Cout, Cin, 3, 3)`` -> ``(B, Cout, 2H, 2W)``.  ``halo``: x carries that
    many extra rows above and below (a rank's rows and its neighbours'), and
    the output is the 2x upsample of the inner H - 2 * halo rows alone."""
    k = composed_kernel(w3).flip(-1, -2).transpose(0, 1)
    return F.conv_transpose2d(x, k, stride=2, padding=(1 + 2 * halo, 1))
