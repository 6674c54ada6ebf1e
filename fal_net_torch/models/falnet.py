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
    where torch allows them);
  * ``torch.bfloat16``: the image is cast at conv0 and every backbone conv,
    the deconvs included, runs on bf16 input and weights with a bf16 output
    (models/layers.py).
In both, the logits follow JAX's default ``fuse_logits``
(fal_net_tpu/models/backbone.py:320-335, :func:`composed_logits`): iconv1
and the 1x1 are composed in fp32 into one 3x3 kernel, rounded to the
compute dtype once, and convolved over the concat with fp32 accumulation
and an fp32 result, plus the 1x1's fp32 bias: one fp32 convolution in
fp32, the kernel L1 (ops/logits_conv.py) in bf16.  The parameters and their
state_dict keys are those of the two convs.

Shapes are NCHW throughout; storage follows the rule of models/layers.py.
On the card with no row shard, the fp32 backbone holds its activations and
conv weights channels-last (``create_model`` places the weights so,
``logits`` converts the image once), so cuDNN runs its NHWC kernels with no
transposes around them, and the composed kernel is built channels-last
too.  bf16, row shards and the CPU keep NCHW.

``phase_deconv`` (off by default): the decoder's exactly-2x deconvs run as
one transposed conv with a composed 4x4 kernel (ops/phase_deconv.py), 2.25x
fewer multiply-adds, the same sums up to fp32 rounding; JAX's default
(fal_net_tpu/models/falnet.py:73).  The port keeps the upsample and 3x3 conv
by default until its time on the card is measured against them.  A shallow
copy (``with_dtype``) keeps it: the deconv modules are shared.

``med_impl``:
  * ``"reference"``: the plain head (:func:`fal_net_torch.ops.med.med_outputs`);
  * ``"fused"``: the CUDA kernel; CPU tensors raise;
  * ``"auto"``: the kernel whenever the tensors are on CUDA, whatever the
    bounds (numbers or per-sample tensors) and the outputs requested
    (disp-only included); the plain head for CPU tensors, where the kernel
    cannot run.  Both read NCHW logits: the fp32 logits conv on the card
    writes them channels-last and :func:`composed_logits` relays them once,
    the one relayout left on that path (it replaces cuDNN's own); L1 and
    the CPU write NCHW.

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

``spatial`` (:meth:`FalNet.with_spatial`): a
:class:`~fal_net_torch.parallel.spatial.RowShard`.  The forward then takes the
whole image on every rank of the shard's group and returns this rank's rows
of every output: the backbone splits its levels' rows over the ranks as JAX's
rule does (models/backbone.py), the logits conv takes its halo rows, and the
MED head, whose shifts act along W, runs on this rank's rows of the logits and
the image; where the full-resolution level is kept whole (its rows not
divisible by the ranks), the head runs on whole rows and its outputs are split
after it, as JAX's ``med_outputs_fused_dp`` keeps such rows whole
(fal_net_tpu/ops/med_pallas.py:613-614).
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from fal_net_torch.models.backbone import VARIANTS, FalNetBackbone, VariantSpec
from fal_net_torch.models.layers import ToNCHW, channels_last_storage, conv, in_channels_last, init_conv, padded_channels
from fal_net_torch.ops._build import ensure_loaded
from fal_net_torch.ops.logits_conv import logits_conv
from fal_net_torch.ops.med import MedOutputs, med_outputs, quirk_mask_r
from fal_net_torch.ops.med_kernel import _is_number, med_outputs_fused
from fal_net_torch.parallel.spatial import ONE_RANK, Level, RowShard, active_rows
from fal_net_torch.utils.device import device_constant, place, resolve_device

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
    accumulation and an fp32 result, plus the 1x1's fp32 bias: in fp32 one
    ``F.conv2d`` (TF32 on the card where torch allows it), in bf16 L1
    (:func:`fal_net_torch.ops.logits_conv.logits_conv`: the kernel on the
    card, its plain version on the CPU), whose backward is JAX's
    ``_conv_accum_bwd``.  Under an active row shard, on this rank's rows
    with their halo.  On the card L1 takes ``x``'s rows only on a 16-byte
    pitch and raises otherwise (:mod:`fal_net_torch.ops.logits_conv`): the
    backbone builds its bf16 concat on it and the halo keeps the row
    stride, so ``x`` goes to the kernel as it is.  For fp32 under
    :func:`~fal_net_torch.models.layers.channels_last_storage` (on the
    card), the kernel is composed in channels-last storage (the same sums,
    one matmul on a view of the weight's storage), with zero output
    channels up to :func:`~fal_net_torch.models.layers.padded_channels`
    (else cuDNN pads them in passes of its own), and the first N planes of
    the conv's channels-last output come back NCHW through
    :class:`~fal_net_torch.models.layers.ToNCHW`.  The logits are NCHW in
    every path."""
    w1x1 = conv1x1.weight[:, :, 0, 0]
    pad = (iconv1_weight.shape[-2] // 2, iconv1_weight.shape[-1] // 2)
    rows = active_rows()
    if rows is not None:
        x, pad = rows.halo(x, pad[0]), (0, pad[1])
    if x.dtype == torch.float32 and in_channels_last():
        n, (m, kh, kw, cin) = w1x1.shape[0], iconv1_weight.permute(0, 2, 3, 1).shape
        zeros = padded_channels(n) - n
        k = F.pad(w1x1, (0, 0, 0, zeros)) @ iconv1_weight.permute(0, 2, 3, 1).reshape(m, kh * kw * cin)
        y = F.conv2d(x, k.view(n + zeros, kh, kw, cin).permute(0, 3, 1, 2), F.pad(conv1x1.bias, (0, zeros)), 1, pad)
        return ToNCHW.apply(y, n)
    k = torch.einsum("om,mihw->oihw", w1x1, iconv1_weight).to(x.dtype, memory_format=torch.contiguous_format)
    if x.dtype == torch.float32:
        return F.conv2d(x, k, conv1x1.bias, 1, pad)
    return logits_conv(x, k, conv1x1.bias, pad[0])


@device_constant
def _flow_value(max_disp: float, device) -> torch.Tensor:
    """The flow plane's value for a number ``max_disp``, 0-d on ``device``:
    ``float32(max_disp) / 100`` computed there in fp32, as the per-sample
    tensor path computes it, made once per (value, device)."""
    return torch.as_tensor(max_disp, dtype=torch.float32, device=device) / 100.0


class FalNet(nn.Module):
    def __init__(self, spec: VariantSpec, num_levels: int, med_impl: str = "auto", a_maskr_quirk: bool = False,
                 dtype: DType = torch.float32, phase_deconv: bool = False):
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
        self.add_module(spec.torch_backbone_key, FalNetBackbone(spec, num_levels, phase_deconv=phase_deconv))
        self.conv0 = conv(num_levels, num_levels, 1, bias=True)
        self.spatial = ONE_RANK

    @property
    def phase_deconv(self) -> bool:
        """Whether the decoder's exactly-2x deconvs run as one transposed conv."""
        return self.get_submodule(self.spec.torch_backbone_key).deconv1.phase

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

    def with_spatial(self, rows: Optional[RowShard]) -> "FalNet":
        """This model with its rows split over ``rows``' ranks (see the
        module docstring): a shallow copy that shares its modules and
        parameters; itself for None or one rank."""
        if rows is None or rows.size == 1:
            return self
        other = copy.copy(self)
        other.spatial = rows
        return other

    def logits(self, left: torch.Tensor, max_disp: Bound) -> torch.Tensor:
        """Plane logits (B, N, H, W) in fp32 and NCHW storage for a
        normalized NCHW image; on a spatial model, this rank's rows where the
        rule splits the full-resolution level, else all H.  The fp32
        backbone on the card with no row shard takes the image in
        channels-last storage (see the module docstring)."""
        b, _, h, w = left.shape
        flow = (_flow_value(float(max_disp), left.device) if _is_number(max_disp)
                else torch.as_tensor(max_disp, dtype=torch.float32, device=left.device) / 100.0)
        flow = flow.reshape(-1, 1, 1, 1).expand(b, 1, h, w)
        x = left.to(self.dtype)
        cl = x.is_cuda and x.dtype == torch.float32 and self.spatial.size == 1
        backbone = self.get_submodule(self.spec.torch_backbone_key)
        with channels_last_storage(cl):
            feats = backbone.features(x.contiguous(memory_format=torch.channels_last) if cl else x, flow, self.spatial)
            return self.spatial.apply(lambda f: self._head(backbone, f), [feats], feats.split)

    def _head(self, backbone: FalNetBackbone, feats: torch.Tensor) -> torch.Tensor:
        """iconv1 and the logits 1x1 on the backbone's features, composed
        (:func:`composed_logits`)."""
        return composed_logits(feats, backbone.iconv1.weight, self.conv0)

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
        kw = dict(ret_disp=ret_disp, ret_pan=ret_pan, ret_subocc=ret_subocc)
        rows, h = self.spatial, left.shape[-2]
        logits = Level(self.logits(left, max_disp), h, rows.sharded(h))
        # on this rank's rows, or on whole rows (split after where there are ranks)
        return rows.apply(lambda lg, im: self._med(lg, im, min_disp, max_disp, **kw),
                          [logits, Level(left.float(), h, False)], rows.size > 1, row_local=logits.split)

    def _med(self, logits: torch.Tensor, image: torch.Tensor, min_disp: Bound, max_disp: Bound, **kw) -> MedOutputs:
        """The MED head on fp32 logits and image, as ``med_impl`` selects."""
        logits, image = logits.contiguous(), image.contiguous()
        quirk = self.a_maskr_quirk and kw["ret_subocc"]
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
    phase_deconv: bool = False,
) -> FalNet:
    """Build a FAL-net variant with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; the global one if None) on ``device``: the GPU
    unless the caller asks for the CPU.  Without a card, "cuda" raises; with
    one, the kernels are built (once) and loaded before the first forward.
    ``a_maskr_quirk``, ``dtype`` (the compute dtype, ``"float32"`` or
    ``"bfloat16"``) and ``phase_deconv``: see the module docstring.  On the
    card the conv weights are held channels-last (:func:`place`);
    ``load_state_dict`` copies into them and keeps it."""
    device = resolve_device(device)
    ensure_loaded(device)
    spec = resolve_variant(variant)
    model = FalNet(spec, num_levels or spec.default_levels, med_impl=med_impl, a_maskr_quirk=a_maskr_quirk,
                   dtype=dtype, phase_deconv=phase_deconv)
    model.reset_parameters(generator)
    return place(model, device)
