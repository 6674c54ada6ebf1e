"""FAL-net model family (torch, NCHW)."""

from fal_net_torch.models.backbone import VARIANTS, FalNetBackbone, VariantSpec
from fal_net_torch.models.falnet import FalNet, create_model
from fal_net_torch.models import registry

__all__ = [
    "VariantSpec",
    "FalNetBackbone",
    "FalNet",
    "VARIANTS",
    "create_model",
    "registry",
]
