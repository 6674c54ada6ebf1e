"""Bundled KITTI Eigen split lists (counterpart of fal_net_tpu/data/lists.py,
with its own copy of ``lists/kitti_eigen_splits.npz``).

The reference ships the Eigen splits as text pair lists
(``Datasets/kitti_eigen_train.txt``, 22,600 L/R pairs; the two 697-line
test lists).  Every line is fully determined by a ``(date, drive, frame)``
triple, so the bundle stores one uint16 array per list and the exact lines
are regenerated on demand.

Line grammar:

- ``pair`` style (train + improved test)::

    {date}/{date}_drive_{drive:04d}_sync/image_02/data/{frame:010d}.png \
 {same with image_03}

- ``flat`` style (original test)::

    {date}_drive_{drive:04d}_sync_02/{frame:010d}.jpg \
 {same with _03}
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

# The five KITTI-raw recording dates (index 0-4 in the encoded arrays).
DATES = ("2011_09_26", "2011_09_28", "2011_09_29", "2011_09_30", "2011_10_03")

# filename -> line style
LIST_SPECS: Dict[str, str] = {
    "kitti_eigen_train.txt": "pair",
    "kitti_eigen_test_improved.txt": "pair",
    "kitti_eigen_test_original.txt": "flat",
}

_BUNDLE = os.path.join(os.path.dirname(__file__), "lists", "kitti_eigen_splits.npz")


def _format_pair(date: str, drive: int, frame: int) -> str:
    stem = f"{date}/{date}_drive_{drive:04d}_sync"
    return f"{stem}/image_02/data/{frame:010d}.png {stem}/image_03/data/{frame:010d}.png"


def _format_flat(date: str, drive: int, frame: int) -> str:
    stem = f"{date}_drive_{drive:04d}_sync"
    return f"{stem}_02/{frame:010d}.jpg {stem}_03/{frame:010d}.jpg"


_FORMATTERS = {"pair": _format_pair, "flat": _format_flat}


def bundled_names() -> List[str]:
    return list(LIST_SPECS)


@lru_cache(maxsize=None)
def _cached_lines(fname: str) -> Tuple[str, ...]:
    if fname not in LIST_SPECS:
        raise KeyError(f"no bundled split list named {fname!r}; have {bundled_names()}")
    with np.load(_BUNDLE) as z:
        rows = z[fname.replace(".txt", "")]
    fmt = _FORMATTERS[LIST_SPECS[fname]]
    return tuple(fmt(DATES[d], int(dr), int(fr)) for d, dr, fr in rows)


def bundled_list_lines(fname: str) -> List[str]:
    """The exact lines of a bundled reference split list (a fresh list)."""
    return list(_cached_lines(fname))
