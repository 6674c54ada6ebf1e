"""Checkpoints: the port's ``.pt`` and the reference's ``.pth.tar``.

Both are ``{"m_model": <reference factory name>, "state_dict": ...}``
(reference Train_Stage1_K.py:202-207); the port's modules carry the
reference's key layout, so one loader reads both.  The variant comes from
the backbone key (``BackBone`` / ``backbone`` / ``synth``, as
fal_net_tpu/models/torch_import.py detects it) and the plane count from
``conv0.weight.shape[0]``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from fal_net_torch.models.backbone import VARIANTS, VariantSpec
from fal_net_torch.models.falnet import FalNet, create_model, resolve_variant


def strip_data_parallel(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` prefix that ``DataParallel`` training adds."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def detect_variant(state_dict: Mapping[str, Any]) -> VariantSpec:
    """The variant whose backbone key and encoder widths the state_dict has
    (B and the test-only ``tiny`` share the key ``backbone``)."""
    roots = {k.split(".")[0] for k in state_dict}
    for spec in VARIANTS.values():
        bk = spec.torch_backbone_key
        widths = tuple(
            state_dict.get(f"{bk}.conv{i}.0.weight", torch.empty(0)).shape[:1]
            for i in range(1, 7)
        )
        if bk in roots and widths == tuple((c,) for c in spec.enc):
            return spec
    raise ValueError(f"cannot detect the FAL-net variant from state_dict roots {sorted(roots)}")


def save_checkpoint(path: str, model: FalNet) -> None:
    torch.save({"m_model": model.spec.torch_name, "state_dict": model.state_dict()}, path)


def read_state_dict(path: str) -> Dict[str, Any]:
    """The state_dict of a port ``.pt`` or reference ``.pth.tar`` (on the
    CPU, ``module.`` prefixes stripped)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return strip_data_parallel(data["state_dict"] if "state_dict" in data else data)


def load_checkpoint(
    path: str,
    *,
    variant: Optional[str] = None,
    num_levels: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    **model_kw,
) -> FalNet:
    """Build the model a checkpoint holds on ``device`` (the GPU unless the
    caller asks for the CPU) and load its weights; ``variant`` /
    ``num_levels`` override what the checkpoint says; ``model_kw`` go to
    :func:`create_model` (``med_impl``, ``a_maskr_quirk``)."""
    sd = read_state_dict(path)
    spec = resolve_variant(variant) if variant else detect_variant(sd)
    model = create_model(spec.name, num_levels or sd["conv0.weight"].shape[0], device=device, **model_kw)
    model.load_state_dict(sd)
    return model


def load_model_any(path: str, *, device: Union[str, torch.device] = "cuda") -> Tuple[FalNet, str, int]:
    """(model, variant, plane count) of a port ``.pt`` or reference
    ``.pth.tar``, the variant and plane count read from the checkpoint
    (counterpart of fal_net_tpu's ``load_params_any``).  Stage 2 loads its
    frozen teacher so, whatever the student's variant and N."""
    model = load_checkpoint(path, device=device)
    return model, model.spec.name, model.num_levels
