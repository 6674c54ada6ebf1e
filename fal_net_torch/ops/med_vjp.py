"""The MED head's hand-derived VJP in closed form, plain PyTorch.

Plain version of the CUDA backward kernel K2 (``csrc/med_bwd.cu``), which
replaces fal_net_tpu/ops/med_pallas.py::_bwd_kernel.  The masks are
stop-gradient (reference FAL_netB.py:264-273), so only disp and pan carry
cotangents.  With sm0 = softmax(l), D = softmax(S l) (the shifted-logit
softmax) and S_n the lerp gather of plane n (f_n = floor(s_n),
t_n = s_n - f_n, zero outside [0, W)):

  disp term:  g_l_n  += sm0_n * (d_n - disp) * g_disp
  pan terms:  gD_n    = sum_c S_n(img_c) * g_pan_c
              q_n     = D_n * gD_n;   g_shift_n = q_n - D_n * sum_m q_m
              g_l_n  += S_n^T(g_shift_n)
              g_img_c = sum_n S_n^T(D_n * g_pan_c)

where S^T(g)[x] = (1-t) g[x-f] + t g[x-f-1] is a forward gather with
f' = -f-1 and t' = 1-t, taken from the FORWARD row of the plane tables.
The tables are :func:`fal_net_torch.ops.med_kernel.plane_tables`, the ones
the kernels read, so the plain version and K2 sample at the same positions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fal_net_torch.ops.med_kernel import plane_tables
from fal_net_torch.ops.shift import _lerp_gather


def med_vjp(
    logits: torch.Tensor,
    image: torch.Tensor,
    min_disp,
    max_disp,
    g_disp: Optional[torch.Tensor],
    g_pan: Optional[torch.Tensor],
    *,
    image_grad: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(g_logits, g_image) of the MED head's disp and pan outputs.

    Args:
      logits: (B, N, H, W); image: (B, C, H, W).
      min_disp / max_disp: numbers, 0-d tensors or (B,) per-sample bounds.
      g_disp: (B, 1, H, W) cotangent of disp, or None (no disp term).
      g_pan: (B, C, H, W) cotangent of pan, or None (no pan terms).
      image_grad: compute g_image; None is returned in its place otherwise,
        and also when there is no pan cotangent (disp does not read the
        image).
    """
    b, n, h, w = logits.shape
    tabs = plane_tables(min_disp, max_disp, n, w, device=logits.device)
    s = tabs.shape[0]  # 1, or B for per-sample bounds
    lev = tabs[:, 0].view(s, n, 1, 1)
    f = tabs[:, 1].long()
    t = tabs[:, 2]
    g_logits = torch.zeros_like(logits)
    g_image = None

    if g_disp is not None:
        sm0 = torch.softmax(logits, dim=1)
        disp = (sm0 * lev).sum(dim=1, keepdim=True)
        g_logits = g_logits + sm0 * (lev - disp) * g_disp

    if g_pan is not None:
        plane = (s, n, 1, 1)  # tables against (B, N, H, W)
        img_plane = (s, 1, n, 1, 1)  # tables against (B, C, N, H, W)
        dprob = torch.softmax(_lerp_gather(logits, f.view(plane), t.view(plane)), dim=1)
        img_s = _lerp_gather(image[:, :, None], f.view(img_plane), t.view(img_plane))
        q = dprob * (img_s * g_pan[:, :, None]).sum(dim=1)
        g_shift = q - dprob * q.sum(dim=1, keepdim=True)
        # S^T: the forward gather with f' = -f-1, t' = 1-t
        g_logits = g_logits + _lerp_gather(g_shift, (-f - 1).view(plane), (1 - t).view(plane))
        if image_grad:
            g_image = _lerp_gather(
                dprob[:, None] * g_pan[:, :, None], (-f - 1).view(img_plane), (1 - t).view(img_plane)
            ).sum(dim=2)
    return g_logits, g_image
