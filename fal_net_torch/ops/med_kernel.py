"""Wrappers of the CUDA MED kernels: K1, the forward (``csrc/med_fwd.cu``),
and K2, its backward (``csrc/med_bwd.cu``).

K1 replaces fal_net_tpu/ops/med_pallas.py::_fwd_kernel and K2 replaces
``_bwd_kernel``.  Both launch through the PyTorch ops
``fal_net_torch::med_fwd`` and ``med_bwd`` (ops/library.py), whose CUDA
impls (csrc/torch_ops.cpp) check the tensors, plan the shift margin and
launch on the current stream; ``med_fwd``'s autograd formula is K2.  The
wrappers take CUDA fp32 contiguous NCHW tensors and disparity bounds that
are numbers, 0-d tensors or per-sample (B,) tensors; anything else raises
here.  The plain versions are :func:`fal_net_torch.ops.med.med_outputs`
and :func:`fal_net_torch.ops.med_vjp.med_vjp`.

Both kernels stage plane rows in shared memory (csrc/med_stage.cuh); their
C entries plan the staging, own the size limits that follow from it and
refuse, launching nothing, what does not fit (the op raises ValueError).
:func:`stage_plan` reports a plan.  Rows too wide for whole plane rows take
the direct path, which stages each column chunk's window with a margin of
:func:`shift_margin` columns on each side: no width is refused there, only
a margin wider than a chunk (disparities past ~1,276 px).

``MedForward.launches`` and ``MedForward.bwd_launches`` read the launch
counts of K1 and K2 that the ops' CUDA impls keep, so that a run can show
that its main path went through them; ``MedForward.mode_launches`` reads
K1's by mode.  ``_build.reset_launch_counts()`` sets them to 0.
"""

from __future__ import annotations

import ctypes
import math
import numbers

import torch

from fal_net_torch.ops._build import K1_MODES, launch_counts, load_library
from fal_net_torch.ops.med import MedOutputs, disparity_levels
from fal_net_torch.utils.device import device_constant

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


@device_constant
def _scalar_tables(min_disp: float, max_disp: float, num_levels: int, width: int, device) -> torch.Tensor:
    """The tables of number bounds, made once per key and kept on ``device``."""
    return plane_tables(min_disp, max_disp, num_levels, width).to(device)


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _device_tables(min_disp, max_disp, num_levels: int, width: int, device) -> torch.Tensor:
    """The plane tables on ``device``: (1, 5, N) for one bound pair (cached
    for numbers), (B, 5, N) for per-sample bounds."""
    if _is_number(min_disp) and _is_number(max_disp):
        return _scalar_tables(float(min_disp), float(max_disp), num_levels, width, device)
    return plane_tables(min_disp, max_disp, num_levels, width, device=device)


def _check(logits, image, min_disp, max_disp, want_disp, want_pan, want_subocc, cuda=True):
    """Raise on what the kernels do not take; with ``cuda`` (the public
    wrappers), on CPU tensors too."""
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
        if cuda and not t.is_cuda:
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


PLAN_FIELDS = ("consumers", "cpt", "chunks", "group", "slots", "whole", "sweeps", "loads", "smem", "direct", "margin")


def shift_margin(largest_disp: float, width: int) -> int:
    """Columns the direct path's chunk windows hold on each side for
    disparities of magnitude up to ``largest_disp``, as :func:`stage_plan`
    plans them: the largest |floor| of a plane shift d (W-1)/W is at most
    ceil(|d|) (the tables clamp floors at W + 1), plus the lerp's second
    column and the masks' neighbour, rounded up to a multiple of 4 so that
    the windows' copies stay 16-byte aligned.  The ops' CUDA impls launch
    with the same count taken from the tables' floors themselves
    (csrc/torch_ops.cpp::shift_margin), never more than this."""
    m = min(math.ceil(abs(largest_disp)), width + 1) + 2
    return (m + 3) // 4 * 4


def _flags(kernel, disp, pan, subocc, image_grad):
    return int(disp), int(pan), int(subocc if kernel == "med_fwd" else image_grad)


def _shifted(kernel, flags) -> bool:
    """Whether a kernel reads other columns than its own: K1 with pan or
    subocc, K2 with pan cotangents.  Without, its windows need no margin."""
    return bool(flags[1] or (kernel == "med_fwd" and flags[2]))


def _plan(kernel, n, c, w, flags, margin):
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if getattr(load_library(), f"{kernel}_plan")(n, c, w, *flags, margin, out) != 0:
        return None
    return dict(zip(PLAN_FIELDS, out))


def stage_plan(kernel: str, n: int, c: int, w: int, *, disp=True, pan=False, subocc=False, image_grad=False,
               max_disp: float = 300.0) -> dict:
    """The staging plan the C entry of ``kernel`` ("med_fwd" or "med_bwd")
    launches with at N = ``n``, C = ``c``, W = ``w`` and the given outputs
    (K1: disp, pan, subocc) or cotangents (K2: disp, pan, image_grad), for
    disparities of magnitude up to ``max_disp``, from the built library:
    consumer threads, columns per thread, column chunks, plane rows per
    stage, ring slots (stages), whether the whole row is staged (each plane
    row loaded once per image row), sweeps over the planes, stage loads per
    image row, dynamic shared-memory bytes, whether the kernel takes the
    direct path (rows too wide: chunk windows in the slots, the image row
    and K2's g_pan row read from device memory; see csrc/med_fwd.cu and
    csrc/med_bwd.cu) and its windows' margin.  Raises ValueError for sizes
    the kernel refuses."""
    flags = _flags(kernel, disp, pan, subocc, image_grad)
    margin = shift_margin(max_disp, w) if _shifted(kernel, flags) else 0
    p = _plan(kernel, n, c, w, flags, margin)
    if p is None:
        raise ValueError(f"{kernel} takes no plan at N={n}, C={c}, W={w} with these outputs or cotangents "
                         f"and a shift margin of {margin} columns")
    return p


def describe_plan(kernel: str, n: int, c: int, w: int, **flags) -> str:
    """The staging path of :func:`stage_plan`'s plan, in words."""
    p = stage_plan(kernel, n, c, w, **flags)
    path = "whole row" if p["whole"] else f"ring of {p['slots']}"
    copy = "bulk copies" if w % 4 == 0 else "cp.async"
    rows = "image and g_pan rows" if kernel == "med_bwd" else "image row"
    span = p["cpt"] * p["consumers"] + 2 * p["margin"]
    direct = (f", chunk windows of {span} columns (margin {p['margin']}), {rows} from device memory"
              if p["direct"] else "")
    return (f"{path} in stages of {p['group']}, {p['chunks']} chunk(s), {p['loads']} stage loads a row, "
            f"{copy}, {p['smem']} B{direct}")


class _LaunchCounts(type):
    """Read-only class properties over the ops' launch counts."""

    @property
    def launches(cls) -> int:
        counts = launch_counts()
        return sum(counts[f"med_fwd:{m}"] for m in K1_MODES)

    @property
    def mode_launches(cls) -> dict:
        counts = launch_counts()
        return {m: counts[f"med_fwd:{m}"] for m in K1_MODES if counts[f"med_fwd:{m}"]}

    @property
    def bwd_launches(cls) -> int:
        return launch_counts()["med_bwd"]


class MedForward(metaclass=_LaunchCounts):
    """The launch counts of K1 (``launches``; ``mode_launches`` by mode,
    e.g. "disp", "disp+pan+subocc") and K2 (``bwd_launches``), counted by
    the ops' CUDA impls where they launch."""


def med_outputs_op(logits, image, min_disp, max_disp, *, ret_disp=True, ret_pan=False, ret_subocc=False,
                   cuda=True) -> MedOutputs:
    """The MED head through the op ``fal_net_torch::med_fwd``: K1 on CUDA
    tensors.  With ``cuda=False`` CPU tensors reach the op's plain CPU
    kernel: for ``serve.export_forward``'s traced copy of the model only."""
    _check(logits, image, min_disp, max_disp, ret_disp, ret_pan, ret_subocc, cuda=cuda)
    if logits.is_cuda:
        load_library()
    _, n, _, w = logits.shape
    tables = _device_tables(min_disp, max_disp, n, w, logits.device)
    disp, pan, mask_l, mask_r = torch.ops.fal_net_torch.med_fwd(logits, image, tables, ret_disp, ret_pan, ret_subocc)
    return MedOutputs(pan=pan if ret_pan else None, disp=disp if ret_disp else None,
                      maskL=mask_l if ret_subocc else None, maskR=mask_r if ret_subocc else None)


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
    on the current stream and does not synchronize; differentiable (K2)."""
    return med_outputs_op(logits, image, min_disp, max_disp, ret_disp=ret_disp, ret_pan=ret_pan,
                          ret_subocc=ret_subocc)


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
    load_library()
    _, n, _, w = logits.shape
    tables = _device_tables(min_disp, max_disp, n, w, logits.device)
    g_logits, g_image = torch.ops.fal_net_torch.med_bwd(logits, image, g_disp, g_pan, tables, image_grad)
    return g_logits, g_image if g_image.numel() else None
