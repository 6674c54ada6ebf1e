"""The stage-1 training dataset (counterpart of the training part of
fal_net_tpu/data/datasets.py, reference Datasets/Kitti.py and
listdataset_train.py).

Split-list files: the Eigen splits are bundled (:mod:`fal_net_torch.data.lists`)
and used when no directory is given; pass ``lists_dir`` or set
``FAL_NET_LISTS_DIR`` to read plain "left.png right.png" lines from files
instead.  Images decode with PIL.  The evaluation datasets wait for the
evaluation slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from fal_net_torch.data.transforms import Compose, normalize


def _imread(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def split2list(items: List, split) -> Tuple[List, List]:
    """0 -> all test; 1 -> all train; float -> Bernoulli split (util.py:4-13)."""
    if split == 0:
        return [], list(items)
    if split == 1:
        return list(items), []
    rng = np.random.default_rng(0)
    mask = rng.random(len(items)) < float(split)
    train = [x for x, m in zip(items, mask) if m]
    test = [x for x, m in zip(items, mask) if not m]
    return train, test


def _list_lines(lists_dir: Optional[str], fname: str) -> List[str]:
    """Lines of split list ``fname``: from ``lists_dir`` / the
    ``FAL_NET_LISTS_DIR`` env var when given, else from the bundled Eigen
    splits."""
    d = lists_dir or os.environ.get("FAL_NET_LISTS_DIR", "")
    if d:
        with open(os.path.join(d, fname)) as f:
            return [ln for ln in f.read().splitlines() if ln.strip()]
    from fal_net_torch.data.lists import bundled_list_lines

    try:
        return bundled_list_lines(fname)
    except KeyError:
        raise ValueError(
            f"split list {fname!r} is not bundled: pass lists_dir= or set "
            "FAL_NET_LISTS_DIR to the directory holding it"
        ) from None


@dataclass
class StereoTrainDataset:
    """Self-supervised training sampler (reference listdataset_train.py).

    Per item: optional random L/R swap with sign-flipped ``max_disp`` unless
    ``fix`` (the trainers always set fix=True -> x_pix=+max_pix,
    listdataset_train.py:74-81); co-transforms; normalization.  Yields
    ``{'left','right'}`` HWC float32 + ``'max_disp'`` scalar + ``'name'``.
    """

    root: str
    pairs: List[Tuple[str, str]]
    co_transform: Optional[Compose] = None
    max_pix: float = 300.0
    fix: bool = True

    def __len__(self) -> int:
        return len(self.pairs)

    def get(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        lp, rp = self.pairs[index]
        if self.fix or rng.random() < 0.5:
            x_pix = self.max_pix
        else:
            lp, rp = rp, lp
            x_pix = -self.max_pix
        left = _imread(os.path.join(self.root, lp))
        right = _imread(os.path.join(self.root, rp))
        inputs = [left, right]
        if self.co_transform is not None:
            inputs, _ = self.co_transform(inputs, None, rng)
        return {
            "left": normalize(inputs[0]),
            "right": normalize(inputs[1]),
            "max_disp": np.float32(x_pix),
            "name": os.path.basename(lp)[:-4],
        }


def _pairs_from_lines(lines: List[str], root: str) -> List[Tuple[str, str]]:
    """(left, right) pairs of the lines whose left image is on disk."""
    pairs = [(a, b) for a, b, *_ in (ln.split(" ") for ln in lines)]
    return [p for p in pairs if os.path.isfile(os.path.join(root, p[0]))]


def kitti_train(
    root: str,
    split=1,
    co_transform: Optional[Compose] = None,
    max_pix: float = 300.0,
    fix: bool = True,
    lists_dir: Optional[str] = None,
):
    """Eigen train split (Kitti.py:26-60): 22,600 L/R pairs filtered to disk."""
    pairs = _pairs_from_lines(_list_lines(lists_dir, "kitti_eigen_train.txt"), root)
    train, test = split2list(pairs, split)
    mk = lambda lst: StereoTrainDataset(root, lst, co_transform, max_pix, fix)
    return mk(train), StereoTrainDataset(root, test, None, max_pix, fix)


# Reference-compatible name lookup (Datasets.__dict__[name] pattern).
REGISTRY: Dict[str, Callable] = {
    "Kitti": kitti_train,
    "kitti": kitti_train,
}
