"""Losses of the training stages: masked L1 (+ VGG19 perceptual)
reconstruction, edge-aware smoothness, and the sparse EPE of evaluation.
The names are JAX's (fal_net_tpu/losses/__init__.py)."""

from fal_net_torch.losses.epe import epe, real_epe
from fal_net_torch.losses.photometric import perceptual_loss, rec_loss
from fal_net_torch.losses.smoothness import smoothness
from fal_net_torch.losses.vgg import Vgg19Features, init_vgg19, load_torch_vgg19

__all__ = [
    "Vgg19Features",
    "load_torch_vgg19",
    "init_vgg19",
    "rec_loss",
    "perceptual_loss",
    "smoothness",
    "epe",
    "real_epe",
]
