"""Checkpoints: the port's ``.pt``, the reference's ``.pth.tar`` and the JAX
package's flax msgpack.

The port's ``.pt`` and the reference's ``.pth.tar`` are ``{"m_model":
<reference factory name>, "state_dict": ...}`` (reference
Train_Stage1_K.py:202-207); the port's modules carry the reference's key
layout, so one loader reads both.  The variant comes from the backbone key
(``BackBone`` / ``backbone`` / ``synth``, as
fal_net_tpu/models/torch_import.py detects it) and the plane count from
``conv0.weight.shape[0]``.

A JAX checkpoint (``checkpoint.msgpack`` / ``model_best.msgpack``, or its
run directory) is read as JAX's ``load_params_any``
(fal_net_tpu/train/checkpoint.py:63-113) reads it: a TrainState
(``params`` and ``opt_state``), a flax variables dict (``params``) or a bare
params dict (``backbone``), anything else a ``ValueError``; the variant and
plane count come from the JSON sidecar ``checkpoint.json`` beside it where it
names them, else from the parameters' shapes.  The parameters are decoded by
the port's own msgpack reader (models/msgpack.py) and mapped to the
reference's layout by :func:`fal_net_torch.models.jax_import.state_dict_from_jax`.
Any path with another suffix than ``.pt``, ``.pth``, ``.pth.tar`` or
``.tar`` is read as msgpack, as JAX does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from fal_net_torch.models.backbone import VARIANTS, VariantSpec
from fal_net_torch.models.falnet import DType, FalNet, create_model, resolve_variant
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.models.msgpack import msgpack_restore

TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".tar")
JAX_CKPT_NAME = "checkpoint.msgpack"  # fal_net_tpu/train/checkpoint.py CKPT_NAME, META_NAME
JAX_META_NAME = "checkpoint.json"
TORCH_CKPT_NAME = "checkpoint.pt"  # train/checkpoint.py's CKPT_NAME


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


def _detect_jax_variant(params: Mapping[str, Any]) -> VariantSpec:
    """The variant whose encoder widths and residual form JAX params have."""
    bb = params["backbone"]
    widths = tuple(np.shape(bb.get(f"conv{i}", {}).get("conv", {}).get("kernel", ()))[-1:] for i in range(1, 7))
    separable = np.shape(bb.get("rb1", {}).get("conv1", {}).get("kernel", ()))[:2] == (3, 1)
    for spec in VARIANTS.values():
        if widths == tuple((c,) for c in spec.enc) and separable == spec.separable_residual:
            return spec
    raise ValueError(f"cannot detect the FAL-net variant from JAX encoder widths {widths}")


def save_checkpoint(path: str, model: FalNet) -> None:
    torch.save({"m_model": model.spec.torch_name, "state_dict": model.state_dict()}, path)


def _as_variables(node: Any) -> Optional[Dict[str, Any]]:
    if not isinstance(node, dict):
        return None
    if isinstance(node.get("params"), dict):
        return node  # a flax variables dict
    if "backbone" in node:
        return {"params": node}  # a bare params dict
    return None


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[str], Optional[int]]:
    """``(params, model_name, num_levels)`` of a JAX msgpack checkpoint (a
    file, or a run directory's ``checkpoint.msgpack``): the checks and
    sidecar of JAX's ``load_params_any``; numpy leaves."""
    run_dir = path if os.path.isdir(path) else os.path.dirname(path)
    with open(os.path.join(path, JAX_CKPT_NAME) if os.path.isdir(path) else path, "rb") as f:
        tree = msgpack_restore(f.read())
    name = num_levels = None
    meta_path = os.path.join(run_dir, JAX_META_NAME)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        name, num_levels = meta.get("model_name"), meta.get("num_levels")
    if isinstance(tree, dict) and "opt_state" in tree and "params" in tree:
        variables = _as_variables(tree["params"])  # a serialized TrainState
    else:
        variables = _as_variables(tree)
    if variables is None:
        keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(
            f"unrecognized checkpoint structure in {path!r}: root keys {keys}; expected a TrainState "
            "('params'+'opt_state'), a flax variables dict ('params'), or a bare params dict ('backbone')"
        )
    return variables["params"], name, num_levels


def _is_torch(path: str) -> bool:
    if os.path.isdir(path):
        return not os.path.isfile(os.path.join(path, JAX_CKPT_NAME))
    return path.endswith(TORCH_SUFFIXES)


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[str], Optional[int]]:
    """``(state_dict, model_name, num_levels)`` of any checkpoint this module
    reads (a file or a run directory); the name and plane count are what a
    JAX sidecar says, else None.  The state_dict is on the CPU, in the
    reference's layout, ``module.`` prefixes stripped."""
    if not _is_torch(path):
        params, name, num_levels = read_jax_checkpoint(path)
        spec = resolve_variant(name) if name else _detect_jax_variant(params)
        sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state_dict_from_jax(params, spec.name).items()}
        return sd, name, num_levels
    if os.path.isdir(path):
        path = os.path.join(path, TORCH_CKPT_NAME)
    data = torch.load(path, map_location="cpu", weights_only=True)
    return strip_data_parallel(data["state_dict"] if "state_dict" in data else data), None, None


def read_state_dict(path: str) -> Dict[str, Any]:
    """The state_dict of a port ``.pt``, a reference ``.pth.tar`` or a JAX
    msgpack checkpoint (on the CPU, ``module.`` prefixes stripped)."""
    return read_checkpoint(path)[0]


def load_checkpoint(
    path: str,
    *,
    variant: Optional[str] = None,
    num_levels: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    dtype: DType = torch.float32,
    **model_kw,
) -> FalNet:
    """Build the model a checkpoint holds on ``device`` (the GPU unless the
    caller asks for the CPU) in the compute ``dtype`` and load its weights;
    ``variant`` / ``num_levels`` override what the checkpoint says;
    ``model_kw`` go to :func:`create_model` (``med_impl``, ``a_maskr_quirk``)."""
    sd, name, levels = read_checkpoint(path)
    spec = resolve_variant(variant or name) if (variant or name) else detect_variant(sd)
    model = create_model(spec.name, num_levels or levels or sd["conv0.weight"].shape[0], device=device,
                         dtype=dtype, **model_kw)
    model.load_state_dict(sd)
    return model


def load_model_any(path: str, *, device: Union[str, torch.device] = "cuda",
                   dtype: DType = torch.float32) -> Tuple[FalNet, str, int]:
    """(model, variant, plane count) of any checkpoint :func:`read_checkpoint`
    reads, the variant and plane count from the checkpoint (counterpart of
    fal_net_tpu's ``load_params_any``), computing in ``dtype``.  Stage 2
    loads its frozen teacher so, whatever the student's variant and N."""
    model = load_checkpoint(path, device=device, dtype=dtype)
    return model, model.spec.name, model.num_levels
