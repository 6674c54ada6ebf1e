"""Setup-time gate of the MED kernels (counterpart of
fal_net_tpu/ops/med_selfcheck.py).

Before the first training step, :func:`med_selfcheck` runs K1 in each mode
the run launches (disp + pan for stage 1 and stage 1 slow, disp + pan +
subocc for the stage-2 student, disp only for its frozen teacher) and K2 at
the run's exact (crop, plane count, bounds) on seeded random logits, image
and cotangents, and holds them against the plain head and the plain VJP on
the same tensors.  Sharing the logits keeps the comparison free of TF32
convolution noise.  The JAX package falls back to its plain head when its
gate fails; here a disagreement RAISES :class:`MedSelfcheckError`, since a
fallback would hide the kernel.  The tolerances are those of the kernels'
tests (tests/test_med_pallas.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fal_net_torch.ops import med_kernel
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_vjp import med_vjp

# (rtol, atol) per compared tensor
TOL = {
    "disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4),
    "g_logits": (1e-4, 1e-5),
}
# K1's modes by name, as the model's forward requests them
MODES = {
    "disp": dict(ret_disp=True),
    "disp+pan": dict(ret_disp=True, ret_pan=True),
    "disp+pan+subocc": dict(ret_disp=True, ret_pan=True, ret_subocc=True),
}


class MedSelfcheckError(RuntimeError):
    """A MED kernel disagrees with its plain version at the run's shape."""


def med_selfcheck(
    height: int,
    width: int,
    num_levels: int,
    min_disp: Sequence[float],
    max_disp: Sequence[float],
    device,
    *,
    seed: int = 0,
    modes: Sequence[str] = ("disp+pan",),
    backward: bool = True,
) -> float:
    """Check K1 in each of ``modes`` (keys of :data:`MODES`) and, with
    ``backward``, K2 with disp and pan cotangents, at one shape, one sample
    per bound pair.

    ``min_disp`` / ``max_disp`` hold one bound per sample; a single pair
    goes in as numbers (the fix_order=True path, one table for the batch),
    several as (B,) tensors (per-sample tables).  Returns the largest
    absolute difference; raises :class:`MedSelfcheckError` on disagreement.
    """
    b = len(min_disp)
    if b == 1:
        mn, mx = float(min_disp[0]), float(max_disp[0])
    else:
        mn = torch.tensor(min_disp, dtype=torch.float32, device=device)
        mx = torch.tensor(max_disp, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    draw = lambda c: torch.from_numpy(
        rng.standard_normal((b, c, height, width)).astype(np.float32)
    ).to(device)
    logits, image, g_disp, g_pan = draw(num_levels), draw(3), draw(1), draw(3)

    pairs = []
    for mode in modes:
        got = med_kernel.med_outputs_fused(logits, image, mn, mx, **MODES[mode])
        want = med_outputs(logits, image, mn, mx, **MODES[mode])
        pairs += [(name, f"K1 {mode}", getattr(got, name), getattr(want, name))
                  for name in want._fields if getattr(want, name) is not None]
    if backward:
        g_logits, _ = med_kernel.med_vjp_fused(logits, image, mn, mx, g_disp, g_pan, image_grad=False)
        want_g, _ = med_vjp(logits, image, mn, mx, g_disp, g_pan, image_grad=False)
        pairs.append(("g_logits", "K2 disp+pan", g_logits, want_g))
    worst = 0.0
    for name, mode, g, w in pairs:
        rtol, atol = TOL[name]
        err = float((g - w).abs().max())
        worst = max(worst, err)
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            raise MedSelfcheckError(
                f"MED kernel {name} disagrees with its plain version ({mode}) at "
                f"(B={b}, N={num_levels}, {height}x{width}), bounds {list(min_disp)}.."
                f"{list(max_disp)}: max abs err {err:.3e} (rtol {rtol}, atol {atol})"
            )
    return worst
