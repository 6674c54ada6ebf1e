"""Wrapper of the CUDA MED forward kernel (``csrc/med_fwd.cu``).

The kernel replaces fal_net_tpu/ops/med_pallas.py::_fwd_kernel.  It takes
CUDA fp32 contiguous NCHW tensors and disparity bounds that are numbers,
0-d tensors or per-sample (B,) tensors; anything else raises here.  The
plain version is :func:`fal_net_torch.ops.med.med_outputs`.

``MedForward.launches`` counts the kernel's launches, so that a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import functools
import numbers

import torch

from fal_net_torch.ops.med import MedOutputs, disparity_levels

MAX_PLANES = 128  # kMaxPlanes in med_fwd.cu
MAX_CHANNELS = 4  # kMaxChannels in med_fwd.cu
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may use


def plane_tables(min_disp, max_disp, num_levels: int, width: int, *, device=None) -> torch.Tensor:
    """Plane tables (S, 5, N) fp32, one per bound pair (S = 1 for scalar
    bounds, B for per-sample ones).  Rows: level d_n, floor(s_n),
    s_n - floor(s_n), floor(-s_n), -s_n - floor(-s_n) with
    s_n = d_n * (W-1)/W, computed in float64 as the TPU kernel's tables are
    (med_pallas.py::_plane_tables) and rounded once.  Floors are clamped to
    [-W-1, W+1], beyond which every read is out of range anyway, so they are
    whole numbers that fp32 holds exactly."""
    lev = disparity_levels(min_disp, max_disp, num_levels, device=device).reshape(-1, num_levels)
    s = lev * ((width - 1) / width)
    f_fw, f_bw = torch.floor(s), torch.floor(-s)
    rows = (lev, f_fw.clamp(-width - 1, width + 1), s - f_fw, f_bw.clamp(-width - 1, width + 1), -s - f_bw)
    return torch.stack(rows, dim=1).float().contiguous()


@functools.lru_cache(maxsize=64)
def _scalar_tables(min_disp: float, max_disp: float, num_levels: int, width: int, device) -> torch.Tensor:
    """The tables of number bounds, made once per key and kept on ``device``:
    the serving path passes the same bounds with every batch.  Read-only.
    Made outside inference mode, since later calls may run outside it."""
    with torch.inference_mode(False):
        return plane_tables(min_disp, max_disp, num_levels, width).to(device)


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _device_tables(min_disp, max_disp, num_levels: int, width: int, device):
    """(tables on ``device``, per-sample stride in elements: 0 if one table
    serves the whole batch)."""
    if _is_number(min_disp) and _is_number(max_disp):
        return _scalar_tables(float(min_disp), float(max_disp), num_levels, width, device), 0
    tabs = plane_tables(min_disp, max_disp, num_levels, width, device=device)
    return tabs, (0 if tabs.shape[0] == 1 else 5 * num_levels)


def _check(logits, image, min_disp, max_disp, want_disp, want_pan, want_subocc):
    for name, t in (("logits", logits), ("image", image)):
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous NCHW tensor, got {tuple(t.shape)}")
    b, n, h, w = logits.shape
    for name, v in (("min_disp", min_disp), ("max_disp", max_disp)):
        if _is_number(v):
            continue
        if not isinstance(v, torch.Tensor) or v.dtype == torch.bool:
            raise TypeError(f"{name} must be a number or a tensor, got {type(v)}")
        if v.ndim > 1 or (v.ndim == 1 and v.shape[0] != b):
            raise ValueError(
                f"{name} must be 0-d or hold one bound per sample (B={b}), got shape {tuple(v.shape)}"
            )
    for name, t in (("logits", logits), ("image", image)):
        if not t.is_cuda:
            raise ValueError(f"the MED kernel needs CUDA tensors; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the MED kernel takes float32; {name} is {t.dtype}")
    if image.device != logits.device:
        raise ValueError(f"logits on {logits.device} but image on {image.device}")
    c = image.shape[1]
    if image.shape != (b, c, h, w):
        raise ValueError(f"image {tuple(image.shape)} does not match logits {tuple(logits.shape)}")
    if not 2 <= n <= MAX_PLANES:
        raise ValueError(f"the MED kernel takes 2..{MAX_PLANES} planes, got {n}")
    if want_pan and not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the MED kernel takes 1..{MAX_CHANNELS} image channels, got {c}")
    if not (want_disp or want_pan or want_subocc):
        raise ValueError("request at least one of disp, pan, subocc")
    smem = 4 * (4 * n + (c * w if want_pan else 0) + (4 * w if want_subocc else 0))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"W={w} needs {smem} B of shared memory, above {MAX_SMEM_BYTES}")


def _launch(logits, image, tables, tab_stride, want_disp, want_pan, want_subocc):
    from fal_net_torch.ops._build import load_library

    lib = load_library()
    b, n, h, w = logits.shape
    c = image.shape[1]

    def out(ch, want):
        return torch.empty((b, ch, h, w), dtype=torch.float32, device=logits.device) if want else None

    disp, pan = out(1, want_disp), out(c, want_pan)
    mask_l, mask_r = out(1, want_subocc), out(1, want_subocc)
    dptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(logits.device):  # the runtime launches on the current device
        err = lib.med_fwd(
            logits.data_ptr(), image.data_ptr(),
            dptr(disp), dptr(pan), dptr(mask_l), dptr(mask_r),
            tables.data_ptr(), tab_stride,
            b, n, c, h, w, int(want_disp), int(want_pan), int(want_subocc),
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"med_fwd launch failed: CUDA error {err}")
    MedForward.launches += 1
    return disp, pan, mask_l, mask_r


class MedForward(torch.autograd.Function):
    """K1 as an autograd node.  The masks are stop-gradient; the gradient of
    disp and pan is the backward kernel, still to be ported."""

    launches = 0

    @staticmethod
    def forward(ctx, logits, image, tables, tab_stride, want_disp, want_pan, want_subocc):
        outs = _launch(logits, image, tables, tab_stride, want_disp, want_pan, want_subocc)
        ctx.mark_non_differentiable(*(t for t in outs[2:] if t is not None))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the MED backward kernel (K2, fal_net_tpu/ops/med_pallas.py::"
            "_bwd_kernel) is not ported yet; train with med_impl='reference'"
        )


def med_outputs_fused(
    logits: torch.Tensor,
    image: torch.Tensor,
    min_disp,
    max_disp,
    *,
    ret_disp: bool = True,
    ret_pan: bool = False,
    ret_subocc: bool = False,
) -> MedOutputs:
    """The MED head through the CUDA kernel; same outputs as
    :func:`fal_net_torch.ops.med.med_outputs`.  ``min_disp`` / ``max_disp``
    are numbers, 0-d tensors or (B,) tensors of per-sample bounds.  Launches
    on the current stream and does not synchronize."""
    _check(logits, image, min_disp, max_disp, ret_disp, ret_pan, ret_subocc)
    _, n, _, w = logits.shape
    tables, tab_stride = _device_tables(min_disp, max_disp, n, w, logits.device)
    disp, pan, mask_l, mask_r = MedForward.apply(
        logits, image, tables, tab_stride, ret_disp, ret_pan, ret_subocc
    )
    return MedOutputs(pan=pan, disp=disp, maskL=mask_l, maskR=mask_r)
