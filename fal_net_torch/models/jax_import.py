"""Carry weights from fal_net_tpu's parameter trees into the port: the
models' and the VGG19 perceptual net's.

The port's modules have the reference's ``state_dict`` key layout, so
fal_net_tpu.models.torch_import.convert_state_dict maps a port state_dict
to the JAX tree as it maps a reference checkpoint.  :func:`state_dict_from_jax`
is its exact inverse: JAX params (numpy, HWIO) -> port state_dict (numpy,
OIHW).  numpy-only; neither JAX nor torch is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from fal_net_torch.models.falnet import resolve_variant


def _hwio_to_oihw(w) -> np.ndarray:
    return np.array(np.transpose(np.asarray(w), (3, 2, 0, 1)), order="C")


def state_dict_from_jax(params: Mapping[str, Any], variant: str) -> Dict[str, np.ndarray]:
    """JAX params ``{"backbone": ..., "logits_1x1": ...}`` of ``variant``
    -> port state_dict with numpy values (load with ``torch.from_numpy``)."""
    spec = resolve_variant(variant)
    bk = spec.torch_backbone_key
    src = params["backbone"]
    sd: Dict[str, np.ndarray] = {}

    def conv_elu(jax_name: str, torch_name: str) -> None:
        sd[f"{bk}.{torch_name}.0.weight"] = _hwio_to_oihw(src[jax_name]["conv"]["kernel"])
        sd[f"{bk}.{torch_name}.0.bias"] = np.array(src[jax_name]["conv"]["bias"])

    def residual(jax_name: str, torch_name: str) -> None:
        for c in ("conv1", "conv2"):
            sd[f"{bk}.{torch_name}.{c}.weight"] = _hwio_to_oihw(src[jax_name][c]["kernel"])

    def deconv(name: str) -> None:
        sd[f"{bk}.{name}.conv1.weight"] = _hwio_to_oihw(src[name]["conv"]["kernel"])

    conv_elu("conv0", "conv0")
    residual("rb0", "conv0_1")
    for i in range(1, 7):
        conv_elu(f"conv{i}", f"conv{i}")
        residual(f"rb{i}", f"conv{i}_1")
    for j in range(6, 1, -1):
        deconv(f"deconv{j}")
        conv_elu(f"iconv{j}", f"iconv{j}")
    deconv("deconv1")
    sd[f"{bk}.iconv1.weight"] = _hwio_to_oihw(src["iconv1"]["kernel"])
    if spec.has_amask:
        sd[f"{bk}.amask_conv.0.weight"] = _hwio_to_oihw(src["amask_conv1_kernel"])
        sd[f"{bk}.amask_conv.0.bias"] = np.array(src["amask_conv1_bias"])
        sd[f"{bk}.amask_conv.2.weight"] = _hwio_to_oihw(src["amask_conv2_kernel"])
    sd["conv0.weight"] = _hwio_to_oihw(params["logits_1x1"]["kernel"])
    sd["conv0.bias"] = np.array(params["logits_1x1"]["bias"])
    return sd


def vgg_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """fal_net_tpu's VGG19 feature params (``{"params": {"conv{i}": {"kernel"
    (HWIO), "bias"}}}`` or the inner dict) -> the state_dict of
    :class:`fal_net_torch.losses.vgg.Vgg19Features` (``features.{i}.weight``
    OIHW, ``features.{i}.bias``), i the torchvision index; the inverse of
    fal_net_tpu.losses.vgg.convert_torch_vgg19."""
    src = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    for name, leaf in src.items():
        idx = int(name[len("conv"):])
        sd[f"features.{idx}.weight"] = _hwio_to_oihw(leaf["kernel"])
        sd[f"features.{idx}.bias"] = np.array(leaf["bias"])
    return sd
