"""Host data path: normalization, stereo co-transforms, the bundled split
lists, the datasets and the batch loader.  The names are JAX's
(fal_net_tpu/data/__init__.py)."""

from fal_net_torch.data.datasets import (
    REGISTRY,
    StereoEvalDataset,
    StereoTrainDataset,
    cityscapes_jpg,
    kitti2015,
    kitti_eigen_test_improved,
    kitti_eigen_test_original,
    kitti_train,
    make3d,
    split2list,
)
from fal_net_torch.data.loader import DataLoader, prefetch_to_device
from fal_net_torch.data.transforms import (
    Compose,
    RandomBrightness,
    RandomChannelBrightness,
    RandomGamma,
    RandomHorizontalFlip,
    RandomResizeCrop,
    default_train_transform,
    denormalize,
    normalize,
)

__all__ = [
    "REGISTRY",
    "StereoEvalDataset",
    "StereoTrainDataset",
    "kitti_train",
    "kitti2015",
    "kitti_eigen_test_improved",
    "kitti_eigen_test_original",
    "cityscapes_jpg",
    "make3d",
    "split2list",
    "DataLoader",
    "prefetch_to_device",
    "Compose",
    "RandomResizeCrop",
    "RandomHorizontalFlip",
    "RandomGamma",
    "RandomBrightness",
    "RandomChannelBrightness",
    "default_train_transform",
    "normalize",
    "denormalize",
]
