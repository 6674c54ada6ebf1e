"""Wrappers of the CUDA MED kernels: K1, the forward (``csrc/med_fwd.cu``),
and K2, its backward (``csrc/med_bwd.cu``).

K1 replaces fal_net_tpu/ops/med_pallas.py::_fwd_kernel and K2 replaces
``_bwd_kernel``.  They take CUDA fp32 contiguous NCHW tensors and disparity
bounds that are numbers, 0-d tensors or per-sample (B,) tensors; anything
else raises here.  The plain versions are
:func:`fal_net_torch.ops.med.med_outputs` and
:func:`fal_net_torch.ops.med_vjp.med_vjp`.

Both kernels stage plane rows in shared memory (csrc/med_stage.cuh); their
C entries plan the staging, own the size limits that follow from it and
refuse, launching nothing, what does not fit (the wrapper raises
ValueError).  :func:`stage_plan` reports a plan.

``MedForward.launches`` and ``MedForward.bwd_launches`` count the launches of
K1 and K2, so that a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from fal_net_torch.ops._build import launch, load_library
from fal_net_torch.ops.med import MedOutputs, disparity_levels

MAX_PLANES = 128  # kMaxPlanes in csrc/med_stage.cuh
MAX_CHANNELS = 4  # kMaxChannels in csrc/med_stage.cuh


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


def _check_bwd(logits, image, g_disp, g_pan):
    """The cotangents K2 reads: contiguous CUDA fp32 of disp's and pan's
    shapes.  Sizes beyond the kernel's shared memory are refused by its C
    entry (see :func:`stage_plan`)."""
    b, n, h, w = logits.shape
    c = image.shape[1]
    for name, g, ch in (("g_disp", g_disp, 1), ("g_pan", g_pan, c)):
        if g is None:
            continue
        if g.shape != (b, ch, h, w) or not g.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {(b, ch, h, w)} tensor, got {tuple(g.shape)}")
        if g.device != logits.device or g.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {logits.device}, got {g.dtype} on {g.device}")


PLAN_FIELDS = ("consumers", "cpt", "chunks", "group", "slots", "whole", "sweeps", "loads", "smem", "direct")


def stage_plan(kernel: str, n: int, c: int, w: int, *, disp=True, pan=False, subocc=False, image_grad=False) -> dict:
    """The staging plan the C entry of ``kernel`` ("med_fwd" or "med_bwd")
    launches with at N = ``n``, C = ``c``, W = ``w`` and the given outputs
    (K1: disp, pan, subocc) or cotangents (K2: disp, pan, image_grad), from
    the built library: consumer threads, columns per thread, column chunks,
    plane rows per stage, ring slots (stages), whether the whole row is
    staged (each plane row loaded once per image row), sweeps over the
    planes, stage loads per image row, dynamic shared-memory bytes, and
    whether K2 reads the image and g_pan rows from device memory instead of
    staging them (rows too wide; see csrc/med_bwd.cu).  Raises ValueError for sizes the kernel refuses."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    flags = (int(disp), int(pan), int(subocc if kernel == "med_fwd" else image_grad))
    if getattr(load_library(), f"{kernel}_plan")(n, c, w, *flags, out) != 0:
        raise ValueError(f"{kernel} takes no plan at N={n}, C={c}, W={w} with these outputs or cotangents")
    return dict(zip(PLAN_FIELDS, out))


def _launch(logits, image, tables, tab_stride, want_disp, want_pan, want_subocc):
    b, n, h, w = logits.shape
    c = image.shape[1]

    def out(ch, want):
        return torch.empty((b, ch, h, w), dtype=torch.float32, device=logits.device) if want else None

    disp, pan = out(1, want_disp), out(c, want_pan)
    mask_l, mask_r = out(1, want_subocc), out(1, want_subocc)
    dptr = lambda t: 0 if t is None else t.data_ptr()
    launch(
        "med_fwd", logits.device, logits.data_ptr(), image.data_ptr(),
        dptr(disp), dptr(pan), dptr(mask_l), dptr(mask_r),
        tables.data_ptr(), tab_stride,
        b, n, c, h, w, int(want_disp), int(want_pan), int(want_subocc),
    )
    MedForward.launches += 1
    return disp, pan, mask_l, mask_r


def _launch_bwd(logits, image, g_disp, g_pan, tables, tab_stride, image_grad):
    b, n, h, w = logits.shape
    c = image.shape[1]
    want_gimg = image_grad and g_pan is not None
    g_logits = torch.empty_like(logits)
    g_image = torch.empty_like(image) if want_gimg else None
    dptr = lambda t: 0 if t is None else t.data_ptr()
    launch(
        "med_bwd", logits.device, logits.data_ptr(), image.data_ptr(), dptr(g_disp), dptr(g_pan),
        g_logits.data_ptr(), dptr(g_image), tables.data_ptr(), tab_stride,
        b, n, c, h, w, int(g_disp is not None), int(g_pan is not None), int(want_gimg),
    )
    MedForward.bwd_launches += 1
    return g_logits, g_image


class MedForward(torch.autograd.Function):
    """K1 as an autograd node whose backward is K2.  The masks are
    stop-gradient; only disp and pan carry cotangents, and an output that
    got none (unrequested or unused) adds no term."""

    launches = 0  # K1
    bwd_launches = 0  # K2

    @staticmethod
    def forward(ctx, logits, image, tables, tab_stride, want_disp, want_pan, want_subocc):
        outs = _launch(logits, image, tables, tab_stride, want_disp, want_pan, want_subocc)
        ctx.mark_non_differentiable(*(t for t in outs[2:] if t is not None))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(logits, image, tables)
        ctx.tab_stride = tab_stride
        return outs

    @staticmethod
    def backward(ctx, g_disp, g_pan, _g_mask_l, _g_mask_r):
        if g_disp is None and g_pan is None:
            return (None,) * 7
        logits, image, tables = ctx.saved_tensors
        g_disp = None if g_disp is None else g_disp.contiguous()
        g_pan = None if g_pan is None else g_pan.contiguous()
        _check_bwd(logits, image, g_disp, g_pan)
        g_logits, g_image = _launch_bwd(
            logits, image, g_disp, g_pan, tables, ctx.tab_stride, ctx.needs_input_grad[1]
        )
        return g_logits, g_image, None, None, None, None, None


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


def med_vjp_fused(
    logits: torch.Tensor,
    image: torch.Tensor,
    min_disp,
    max_disp,
    g_disp,
    g_pan,
    *,
    image_grad: bool = True,
):
    """K2 called directly: (g_logits, g_image) of the MED head's disp and pan,
    the same function as :func:`fal_net_torch.ops.med_vjp.med_vjp`.  A None
    cotangent adds no term; g_image is None without ``image_grad`` or g_pan."""
    want_disp, want_pan = g_disp is not None, g_pan is not None
    _check(logits, image, min_disp, max_disp, want_disp, want_pan, False)
    _check_bwd(logits, image, g_disp, g_pan)
    _, n, _, w = logits.shape
    tables, tab_stride = _device_tables(min_disp, max_disp, n, w, logits.device)
    return _launch_bwd(logits, image, g_disp, g_pan, tables, tab_stride, image_grad)
