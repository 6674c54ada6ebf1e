"""Serving artifacts: the forward exported once, in one file (counterpart of
fal_net_tpu/serve.py).

    blob = export_forward(model, batch=1, height=384, width=1280)  # device "cuda"
    save_exported("falnetB.pt2z", blob)
    # ... on the serving host, without the model code or the checkpoint:
    fwd = load_exported("falnetB.pt2z")                # device "cuda"
    (disp,) = fwd(left_nhwc)                           # (B, H, W, 1) fp32 disparity

``torch.export`` traces a copy of the forward whose MED head always calls
the op ``fal_net_torch::med_fwd`` (ops/library.py), the port's counterpart
of JAX's ``portable`` copy: an artifact made on the card runs K1 inside it,
and one made on the CPU runs the op's plain CPU kernel.  The weights are
baked in.  Inputs and outputs are NHWC, as JAX's artifacts take and give
them: ``left`` (B, H, W, 3) raw uint8 (``uint8_input``: normalized on the
device) or normalized float32; disp (B, H, W, 1), then pan (B, H, W, 3)
and maskL, maskR (B, H, W, 1) where exported.

An artifact is one zip file: ``meta.json`` and one ``torch.export``
program per shape.  It is shape-static: a bundle (:func:`export_bundle`)
holds one program per (height, width) and dispatches by the input's shape;
a shape it does not hold raises.  An artifact runs on the device type it
was exported for: :func:`load_exported` raises when that device is absent
or another is asked for, and never moves an artifact to the CPU.  Loading
needs ``fal_net_torch.ops`` (the op's schema and kernels) and this module,
not ``fal_net_torch.models``.

An artifact computes in its model's dtype (``meta["dtype"]``, as JAX's
serve.py:110-113 records it): a bfloat16 artifact runs the backbone in bf16
and its MED head, K1 on the card, in fp32 on fp32 logits, as the live model
does; its outputs are fp32 either way.
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from typing import Sequence, Tuple

import torch
from torch import nn

from fal_net_torch.data.transforms import normalize_device
from fal_net_torch.ops import _build
from fal_net_torch.ops.med import quirk_mask_r
from fal_net_torch.ops.med_kernel import med_outputs_op
from fal_net_torch.utils.device import resolve_device

FORMAT = "fal_net_torch.export/1"


class _Forward(nn.Module):
    """What an artifact computes: NHWC input, (optionally) on-device
    normalization, the model's logits, the MED head through the op, NHWC
    outputs."""

    def __init__(self, model, min_disp, max_disp, ret_pan, ret_subocc, uint8_input):
        super().__init__()
        self.model = model
        self.bounds = (float(min_disp), float(max_disp))
        self.ret_pan, self.ret_subocc, self.uint8_input = ret_pan, ret_subocc, uint8_input

    def forward(self, left: torch.Tensor):
        x = left.permute(0, 3, 1, 2)
        x = (normalize_device(x) if self.uint8_input else x).contiguous()
        logits = self.model.logits(x, self.bounds[1]).contiguous()
        out = med_outputs_op(logits, x, *self.bounds, ret_disp=True, ret_pan=self.ret_pan,
                             ret_subocc=self.ret_subocc, cuda=False)
        if self.ret_subocc and self.model.a_maskr_quirk:
            out = out._replace(maskR=quirk_mask_r(logits, *self.bounds))
        res = [out.disp]
        if self.ret_pan:
            res.append(out.pan)
        if self.ret_subocc:
            res += [out.maskL, out.maskR]
        return tuple(t.permute(0, 2, 3, 1) for t in res)


def export_forward(model, *, batch: int = 1, height: int = 384, width: int = 1280, **kw) -> bytes:
    """The forward of ``model`` (a :class:`fal_net_torch.models.FalNet`)
    exported at one shape, its weights baked in; returns the artifact's
    bytes.  ``kw``: ``min_disp`` (2.0), ``max_disp`` (300.0), ``ret_pan``
    and ``ret_subocc`` (False), ``device`` (``"cuda"``: the card unless the
    caller asks for the CPU), ``uint8_input`` (False: the artifact takes
    raw uint8 RGB and normalizes on the device, ``input: "uint8"`` in its
    meta, when True).  The artifact computes in ``model.dtype``."""
    return _archive([_export(model, batch=batch, height=height, width=width, **kw)])


def export_bundle(model, shapes: Sequence[Tuple[int, int]], *, batch: int = 1, **kw) -> bytes:
    """One program per (height, width) in one file, dispatched by the input's
    shape; ``kw`` as :func:`export_forward` takes them."""
    exports = [_export(model, batch=batch, height=h, width=w, **kw) for h, w in shapes]
    return _archive(exports, {"shapes": [list(s) for s in shapes], "batch": batch, "count": len(exports)})


def _export(model, *, batch, height, width, min_disp=2.0, max_disp=300.0, ret_pan=False, ret_subocc=False,
            device="cuda", uint8_input=False):
    device = resolve_device(device)
    _build.ensure_loaded(device)
    if next(model.parameters()).device != device:
        model = copy.deepcopy(model).to(device)
    fwd = _Forward(model.eval(), min_disp, max_disp, ret_pan, ret_subocc, uint8_input).eval()
    example = torch.zeros((batch, height, width, 3), dtype=torch.uint8 if uint8_input else torch.float32,
                          device=device)
    with torch.no_grad():
        program = torch.export.export(fwd, (example,), strict=False)
    program.example_inputs = None  # else saved beside the weights: 47 MB at (8, 384, 1280, 3) fp32
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "batch": batch,
        "height": height,
        "width": width,
        "min_disp": min_disp,
        "max_disp": max_disp,
        "outputs": ["disp"] + (["pan"] if ret_pan else []) + (["maskL", "maskR"] if ret_subocc else []),
        "device": device.type,
        "variant": model.spec.name,
        "num_levels": model.num_levels,
        "input": "uint8" if uint8_input else "float32_normalized",
        "dtype": str(model.dtype).removeprefix("torch."),
        "n_params": sum(p.numel() for p in model.parameters()),
    }
    return meta, buf.getvalue()


def _archive(exports, bundle=None) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps({"format": FORMAT, "programs": [m for m, _ in exports],
                                            "bundle": bundle}))
        for i, (_, blob) in enumerate(exports):
            z.writestr(f"program_{i}.pt2", blob)
    return buf.getvalue()


def save_exported(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


def _single(program, meta, device):
    module = program.module()
    dtype = torch.uint8 if meta["input"] == "uint8" else torch.float32

    def fwd(left):
        left = torch.as_tensor(left, device=device)
        if left.dtype != dtype:
            raise TypeError(f"this artifact takes {meta['input']} input ({dtype}), got {left.dtype}")
        with torch.no_grad():
            return tuple(module(left))

    fwd.meta = meta
    return fwd


def load_exported(path: str, device="cuda"):
    """Load an artifact for ``device`` (the card unless the caller asks for
    the CPU); returns ``fwd(left) -> tuple(outputs)`` with ``fwd.meta``
    describing shapes, outputs and input.  Bundles load to a dispatcher by
    ``left.shape[1:3]`` (ValueError on a shape not in the bundle), with
    ``fwd.meta["shapes"]`` and ``fwd.by_shape``; their other meta fields
    come from the first program.  Raises ValueError for a file that is no
    artifact, and for an artifact made for another device type."""
    device = resolve_device(device)
    try:
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            if meta.get("format") != FORMAT:
                raise ValueError(f"{path}: not a fal_net_torch export artifact (format {meta.get('format')!r})")
            made = {m["device"] for m in meta["programs"]}
            if made != {device.type}:
                raise ValueError(f"{path} was exported for {sorted(made)}, not {device.type}: an artifact runs "
                                 "on the device type it was made for, and is never moved")
            _build.ensure_loaded(device)
            fwds = [_single(torch.export.load(io.BytesIO(z.read(f"program_{i}.pt2"))), m, device)
                    for i, m in enumerate(meta["programs"])]
    except (zipfile.BadZipFile, KeyError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a fal_net_torch export artifact ({e})") from e
    if meta["bundle"] is None:
        return fwds[0]
    by_shape = {(f.meta["height"], f.meta["width"]): f for f in fwds}

    def fwd(left):
        hw = tuple(left.shape[1:3])
        if hw not in by_shape:
            raise ValueError(f"input shape {hw} not in bundle; have {sorted(by_shape)}")
        return by_shape[hw](left)

    fwd.meta = {**fwds[0].meta, **meta["bundle"]}
    fwd.by_shape = by_shape
    return fwd
