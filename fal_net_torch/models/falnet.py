"""FAL-net: backbone + MED probability-volume head (counterpart of
fal_net_tpu/models/falnet.py).

  * the "flow" conditioning plane is max_disp/100 broadcast over HxW and
    concatenated before conv1 (reference FAL_netB.py:208-209);
  * an extra 1x1 conv on the logits ("not shown in paper",
    FAL_netB.py:190-192), module ``conv0`` as in the reference, runs in
    fp32 outside autocast;
  * the MED head runs in fp32, through the CUDA kernel or the plain head
    as ``med_impl`` selects.

``med_impl``:
  * ``"reference"``: the plain head (:func:`fal_net_torch.ops.med.med_outputs`);
  * ``"fused"``: the CUDA kernel; CPU tensors raise;
  * ``"auto"``: the kernel whenever the tensors are on CUDA, whatever the
    bounds (numbers or per-sample tensors) and the outputs requested
    (disp-only included: NCHW logits are already the kernel's layout, so
    there is no relayout to avoid); the plain head for CPU tensors, where
    the kernel cannot run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from fal_net_torch.models.backbone import VARIANTS, FalNetBackbone, VariantSpec
from fal_net_torch.models.layers import conv, init_conv
from fal_net_torch.ops.med import MedOutputs, med_outputs
from fal_net_torch.ops.med_kernel import med_outputs_fused
from fal_net_torch.utils.device import resolve_device

Bound = Union[float, torch.Tensor]
MED_IMPLS = ("auto", "fused", "reference")


class FalNet(nn.Module):
    def __init__(self, spec: VariantSpec, num_levels: int, med_impl: str = "auto"):
        super().__init__()
        if med_impl not in MED_IMPLS:
            raise ValueError(f"med_impl must be one of {MED_IMPLS}, got {med_impl!r}")
        self.spec = spec
        self.num_levels = num_levels
        self.med_impl = med_impl
        # Attribute names give the reference's state_dict keys: the backbone
        # under BackBone / backbone / synth, the logits 1x1 conv as conv0.
        self.add_module(spec.torch_backbone_key, FalNetBackbone(spec, num_levels))
        self.conv0 = conv(num_levels, num_levels, 1, bias=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-normal (fan-in) weights from ``generator``, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m, generator)

    def logits(self, left: torch.Tensor, max_disp: Bound) -> torch.Tensor:
        """Plane logits (B, N, H, W) in fp32 for a normalized NCHW image."""
        b, _, h, w = left.shape
        max_t = torch.as_tensor(max_disp, dtype=torch.float32, device=left.device)
        flow = (max_t / 100.0).reshape(-1, 1, 1, 1).expand(b, 1, h, w)
        dlog = self.get_submodule(self.spec.torch_backbone_key)(left, flow)
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
        if self.med_impl == "fused" or (self.med_impl == "auto" and logits.is_cuda):
            return med_outputs_fused(logits, image, min_disp, max_disp, **kw)
        return med_outputs(logits, image, min_disp, max_disp, **kw)


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
) -> FalNet:
    """Build a FAL-net variant with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; the global one if None) on ``device``: the GPU
    unless the caller asks for the CPU.  Without a card, "cuda" raises."""
    device = resolve_device(device)
    spec = resolve_variant(variant)
    model = FalNet(spec, num_levels or spec.default_levels, med_impl=med_impl)
    model.reset_parameters(generator)
    return model.to(device)
