"""VGG19 perceptual feature extractor (counterpart of
fal_net_tpu/losses/vgg.py), NCHW.

The reference's ``Vgg19_pc`` (loss_functions.py:7-44): torchvision VGG19
config-E features sliced after pool1 / pool2 / pool3 (and pool4 with
``full=True``), ReLU after every conv, 2x2 max-pool, frozen.  The convs are
cuDNN ``F.conv2d``, as the backbone's are.

Weights: the reference downloads ImageNet-pretrained torchvision weights
(``models.vgg19(pretrained=True)``, loss_functions.py:10).  Without network
access, :func:`load_torch_vgg19` takes a local torchvision-layout
``state_dict`` (``features.{i}.weight`` or ``{i}.weight`` keys; torchvision
itself is not needed) or a pickled module, and :func:`init_vgg19` makes
seeded Kaiming random weights with a warning: random features still give a
structured-similarity signal, but not pretrained fidelity.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

log = logging.getLogger(__name__)

# torchvision vgg19.features conv layer indices per stage (config E)
STAGE_CONVS: Tuple[Tuple[int, ...], ...] = (
    (0, 2),  # conv1_1, conv1_2 -> pool1
    (5, 7),  # conv2_1, conv2_2 -> pool2
    (10, 12, 14, 16),  # conv3_1 .. conv3_4 -> pool3
    (19, 21, 23, 25),  # conv4_1 .. conv4_4 -> pool4
)
STAGE_WIDTH = (64, 128, 256, 512)


class Vgg19Features(nn.Module):
    """Returns the (pool1, pool2, pool3[, pool4]) feature maps of an NCHW
    image.  Parameters are ``features.{i}.weight`` / ``.bias`` with i the
    torchvision index, so ``load_state_dict`` takes torchvision's keys.
    Frozen: no parameter requires grad and the module stays in eval mode
    (it has no layer whose mode matters)."""

    def __init__(self, full: bool = False):
        super().__init__()
        self.full = full
        self.features = nn.ModuleDict()
        cin = 3
        for stage in range(4 if full else 3):
            for idx in STAGE_CONVS[stage]:
                self.features[str(idx)] = nn.Conv2d(cin, STAGE_WIDTH[stage], 3, padding=1)
                cin = STAGE_WIDTH[stage]
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):  # frozen: always eval
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for stage in range(4 if self.full else 3):
            for idx in STAGE_CONVS[stage]:
                conv = self.features[str(idx)]
                x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            x = F.max_pool2d(x, 2, 2)
            outs.append(x)
        return tuple(outs)


def init_vgg19(full: bool = False, seed: int = 0, device=None) -> Vgg19Features:
    """Random-init VGG19 features: Kaiming-normal (fan-in, gain sqrt(2))
    weights from an explicit ``torch.Generator`` seeded with ``seed``, zero
    biases."""
    log.warning(
        "VGG19 perceptual net initialized with RANDOM weights; supply a "
        "torchvision vgg19 state_dict via load_torch_vgg19() for pretrained "
        "perceptual fidelity."
    )
    model = Vgg19Features(full=full)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in model.features.values():
            nn.init.kaiming_normal_(conv.weight, mode="fan_in", nonlinearity="relu", generator=g)
            nn.init.zeros_(conv.bias)
    return model.to(device) if device is not None else model


def convert_torch_vgg19(state_dict: Mapping[str, Any], full: bool = False) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg19().state_dict()`` (``features.{i}.weight``) or
    ``vgg19().features.state_dict()`` (``{i}.weight``) -> the
    :class:`Vgg19Features` state_dict of the sliced layers (fp32 tensors).
    Raises KeyError naming a missing conv."""
    out: Dict[str, torch.Tensor] = {}
    for stage in range(4 if full else 3):
        for idx in STAGE_CONVS[stage]:
            for key in (f"features.{idx}.weight", f"{idx}.weight"):
                if key in state_dict:
                    w, b = state_dict[key], state_dict[key[: -len("weight")] + "bias"]
                    break
            else:
                raise KeyError(f"missing vgg19 conv weight for features index {idx}")
            out[f"features.{idx}.weight"] = torch.as_tensor(np.asarray(w), dtype=torch.float32)
            out[f"features.{idx}.bias"] = torch.as_tensor(np.asarray(b), dtype=torch.float32)
    return out


def load_torch_vgg19(path: str, full: bool = False, device=None) -> Vgg19Features:
    """VGG19 features from a torch file: a state_dict in torchvision's
    layout or a pickled module (``torch.load(map_location="cpu")``)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(data, "state_dict"):
        data = data.state_dict()
    sd = {k: v.detach().cpu().numpy() for k, v in data.items() if isinstance(v, torch.Tensor)}
    model = Vgg19Features(full=full)
    model.load_state_dict(convert_torch_vgg19(sd, full=full))
    return model.to(device) if device is not None else model


def build_vgg(vgg_weights: Optional[str], allow_random: bool, a_p: float, seed: int, device) -> Optional[Vgg19Features]:
    """The trainer's frozen perceptual net: None with ``a_p == 0``; else
    from ``vgg_weights``, or random with ``allow_random``; else raises, as
    fal_net_tpu's trainer does: the reference always trains a_p > 0 against
    pretrained ImageNet features (loss_functions.py:10,48), and random
    features change the training in a way the loss curve does not show."""
    if a_p <= 0:
        return None
    if vgg_weights:
        return load_torch_vgg19(vgg_weights, device=device)
    if allow_random:
        return init_vgg19(seed=seed, device=device)
    raise ValueError(
        f"a_p={a_p} > 0 enables the perceptual loss but no "
        "--vgg_weights were given.  Either supply a torchvision "
        "vgg19 state_dict (--vgg_weights path.pth), disable the "
        "term (--a_p 0), or explicitly opt into random-init VGG "
        "features with --allow_random_vgg."
    )
