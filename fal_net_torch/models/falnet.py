"""FAL-net: backbone + MED probability-volume head (counterpart of
fal_net_tpu/models/falnet.py).

  * the "flow" conditioning plane is max_disp/100 broadcast over HxW and
    concatenated before conv1 (reference FAL_netB.py:208-209);
  * an extra 1x1 conv on the logits ("not shown in paper",
    FAL_netB.py:190-192), module ``conv0`` as in the reference;
  * the MED head runs in fp32 in every compute dtype, on fp32 logits and
    the fp32 image, through the CUDA kernel or the plain head as
    ``med_impl`` selects.

``dtype`` is the backbone's compute dtype, a model attribute as in JAX
(fal_net_tpu/models/falnet.py:54); the parameters stay fp32 in both:
  * ``torch.float32``: the backbone in fp32 (TF32 convolutions on the card
    where torch allows them), then ``conv0`` on iconv1's output, outside
    autocast;
  * ``torch.bfloat16``: the image is cast at conv0 and every backbone conv,
    the deconvs included, runs on bf16 input and weights with a bf16 output
    (models/layers.py).  The logits follow JAX's default ``fuse_logits``
    (fal_net_tpu/models/backbone.py:320-335, :func:`composed_logits`):
    iconv1 and the 1x1 are composed in fp32, rounded to bf16 once, and
    convolved over the bf16 concat with fp32 accumulation and an fp32
    result; the 1x1's fp32 bias is added after.

``med_impl``:
  * ``"reference"``: the plain head (:func:`fal_net_torch.ops.med.med_outputs`);
  * ``"fused"``: the CUDA kernel; CPU tensors raise;
  * ``"auto"``: the kernel whenever the tensors are on CUDA, whatever the
    bounds (numbers or per-sample tensors) and the outputs requested
    (disp-only included: NCHW logits are already the kernel's layout, so
    there is no relayout to avoid); the plain head for CPU tensors, where
    the kernel cannot run.

``a_maskr_quirk`` (opt-in, off by default): reproduce the reference
FAL_netA's maskR resample, whose warp omits ``align_corners``
(models/FAL_netA.py:264), for parity with published A checkpoints
(:func:`fal_net_torch.ops.shift.hshift_planes_quirk`).  The CUDA kernel has
no such resample, as the JAX package's Pallas kernel has none: with the
quirk, a forward that requests the masks still runs the kernel (or the plain
head) as ``med_impl`` selects for disp, pan and maskL, and maskR alone goes
through the plain quirk sampler (:func:`fal_net_torch.ops.med.quirk_mask_r`),
replacing the kernel's.  It is chosen by the caller, never taken in reaction
to a failure.
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from fal_net_torch.models.backbone import VARIANTS, FalNetBackbone, VariantSpec
from fal_net_torch.models.layers import conv, init_conv
from fal_net_torch.ops._build import ensure_loaded
from fal_net_torch.ops.med import MedOutputs, med_outputs, quirk_mask_r
from fal_net_torch.ops.med_kernel import med_outputs_fused
from fal_net_torch.utils.device import resolve_device

Bound = Union[float, torch.Tensor]
MED_IMPLS = ("auto", "fused", "reference")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DType = Union[str, torch.dtype]


def compute_dtype(dtype: DType) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` or the torch dtype -> the torch dtype;
    any other raises."""
    if isinstance(dtype, str):
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype must be one of {sorted(COMPUTE_DTYPES)}, got {dtype!r}")
        return COMPUTE_DTYPES[dtype]
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype must be torch.float32 or torch.bfloat16, got {dtype!r}")
    return dtype


def composed_logits(x: torch.Tensor, iconv1_weight: torch.Tensor, conv1x1: nn.Conv2d) -> torch.Tensor:
    """JAX's ``fuse_logits`` (fal_net_tpu/models/backbone.py:320-335): the 3x3
    ``iconv1_weight`` and the 1x1 ``conv1x1`` composed in fp32 into one 3x3
    kernel, rounded to ``x``'s dtype once, convolved over ``x`` with fp32
    accumulation and an fp32 result, plus the 1x1's fp32 bias.  The operands
    are upcast and convolved in fp32: exact for bf16 operands, TF32
    included (bf16's 8-bit significand fits TF32's 11 bits)."""
    k = torch.einsum("om,mihw->oihw", conv1x1.weight[:, :, 0, 0], iconv1_weight)
    k = k.to(x.dtype).float()
    pad = (iconv1_weight.shape[-2] // 2, iconv1_weight.shape[-1] // 2)
    return F.conv2d(x.float(), k, conv1x1.bias, 1, pad)


class FalNet(nn.Module):
    def __init__(self, spec: VariantSpec, num_levels: int, med_impl: str = "auto", a_maskr_quirk: bool = False,
                 dtype: DType = torch.float32):
        super().__init__()
        if med_impl not in MED_IMPLS:
            raise ValueError(f"med_impl must be one of {MED_IMPLS}, got {med_impl!r}")
        self.spec = spec
        self.num_levels = num_levels
        self.med_impl = med_impl
        self.a_maskr_quirk = a_maskr_quirk
        self.dtype = compute_dtype(dtype)
        # Attribute names give the reference's state_dict keys: the backbone
        # under BackBone / backbone / synth, the logits 1x1 conv as conv0.
        self.add_module(spec.torch_backbone_key, FalNetBackbone(spec, num_levels))
        self.conv0 = conv(num_levels, num_levels, 1, bias=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-normal (fan-in) weights from ``generator``, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m, generator)

    def with_dtype(self, dtype: DType) -> "FalNet":
        """This model computing in ``dtype``: itself if it already does, else
        a shallow copy that shares its modules and parameters."""
        dtype = compute_dtype(dtype)
        if dtype == self.dtype:
            return self
        other = copy.copy(self)
        other.dtype = dtype
        return other

    def logits(self, left: torch.Tensor, max_disp: Bound) -> torch.Tensor:
        """Plane logits (B, N, H, W) in fp32 for a normalized NCHW image."""
        b, _, h, w = left.shape
        max_t = torch.as_tensor(max_disp, dtype=torch.float32, device=left.device)
        flow = (max_t / 100.0).reshape(-1, 1, 1, 1).expand(b, 1, h, w)
        backbone = self.get_submodule(self.spec.torch_backbone_key)
        if self.dtype != torch.float32:
            return composed_logits(backbone.features(left.to(self.dtype), flow), backbone.iconv1.weight, self.conv0)
        dlog = backbone(left, flow)
        with torch.autocast(left.device.type, enabled=False):
            return self.conv0(dlog.float())

    def forward(
        self,
        left: torch.Tensor,
        min_disp: Bound,
        max_disp: Bound,
        *,
        ret_disp: bool = True,
        ret_pan: bool = False,
        ret_subocc: bool = False,
    ) -> MedOutputs:
        logits = self.logits(left, max_disp).contiguous()
        image = left.float().contiguous()
        kw = dict(ret_disp=ret_disp, ret_pan=ret_pan, ret_subocc=ret_subocc)
        quirk = self.a_maskr_quirk and ret_subocc
        if self.med_impl == "fused" or (self.med_impl == "auto" and logits.is_cuda):
            out = med_outputs_fused(logits, image, min_disp, max_disp, **kw)
            return out._replace(maskR=quirk_mask_r(logits, min_disp, max_disp)) if quirk else out
        return med_outputs(logits, image, min_disp, max_disp, maskr_quirk=quirk, **kw)


def resolve_variant(variant: str) -> VariantSpec:
    """'A' | 'B' | 'C' | 'tiny', a reference name like 'FAL_netB', or an
    alias like 'falnet_b'."""
    if variant in VARIANTS:
        return VARIANTS[variant]
    for spec in VARIANTS.values():
        if variant in (spec.torch_name, f"falnet_{spec.name.lower()}"):
            return spec
    raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")


def create_model(
    variant: str = "B",
    num_levels: Optional[int] = None,
    *,
    med_impl: str = "auto",
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
    a_maskr_quirk: bool = False,
    dtype: DType = torch.float32,
) -> FalNet:
    """Build a FAL-net variant with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; the global one if None) on ``device``: the GPU
    unless the caller asks for the CPU.  Without a card, "cuda" raises; with
    one, the kernels are built (once) and loaded before the first forward.
    ``a_maskr_quirk`` and ``dtype`` (the compute dtype, ``"float32"`` or
    ``"bfloat16"``): see the module docstring."""
    device = resolve_device(device)
    ensure_loaded(device)
    spec = resolve_variant(variant)
    model = FalNet(spec, num_levels or spec.default_levels, med_impl=med_impl, a_maskr_quirk=a_maskr_quirk,
                   dtype=dtype)
    model.reset_parameters(generator)
    return model.to(device)
