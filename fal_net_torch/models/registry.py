"""Name-based model lookup (counterpart of fal_net_tpu/models/registry.py):
the variant letters, the reference's factory names ('FAL_netB') and the
lower-case aliases ('falnet_b')."""

from __future__ import annotations

from fal_net_torch.models.falnet import FalNet, create_model, resolve_variant


def get(name: str, num_levels: int | None = None, **kw) -> FalNet:
    return create_model(resolve_variant(name).name, num_levels, **kw)
