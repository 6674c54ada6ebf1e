"""Dataset catalog: KITTI (Eigen), KITTI 2015, Cityscapes, Make3D
(counterpart of fal_net_tpu/data/datasets.py, reference Datasets/ and
listdataset_{train,test}.py).

Plain samplers yielding numpy dicts; batching, shuffling and prefetch live
in :mod:`fal_net_torch.data.loader` and the Evaluator.  Split-list files:
the Eigen splits are bundled (:mod:`fal_net_torch.data.lists`) and used
when no directory is given; pass ``lists_dir`` or set ``FAL_NET_LISTS_DIR``
to read plain "left.png right.png" lines from files instead.  Images and
16-bit PNGs decode with the native decoder (:mod:`fal_net_torch.native.io`)
where it builds, else with PIL; Make3D's .mat files with scipy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
import glob
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from fal_net_torch.data.transforms import Compose, normalize


def _imread(path: str) -> np.ndarray:
    """Decode one image file: with the native decoder (GIL-free libpng and
    libjpeg, the same pixels as PIL) where it is available, else with PIL;
    also with PIL for a file the native decoder rejects (e.g. CMYK JPEGs,
    which libjpeg does not convert to RGB), as fal_net_tpu's loader does."""
    from fal_net_torch.native import io as native_io

    if native_io.available():
        try:
            return native_io.imread(path)
        except (ValueError, RuntimeError):
            pass
    with Image.open(path) as im:
        return np.asarray(im)


def load_kitti_disp_png(path: str) -> np.ndarray:
    """A 16-bit grayscale disparity or depth PNG scaled by 256
    (listdataset_test.py:43-46), as (H, W, 1) float32."""
    return (_imread(path).astype(np.float32) / 256.0)[..., None]


def load_depth_npy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)[..., None]


def load_kitti_flow_png(path: str) -> np.ndarray:
    """A KITTI optical-flow PNG: uint16 RGB with u = (R - 2^15) / 64,
    v = (G - 2^15) / 64 and B the validity mask.  Returns (H, W, 3) float32
    [u, v, valid], u and v zero where invalid.

    PIL reads 16-bit RGB PNGs as 8 bits, which corrupts the fixed-point
    encoding: this reads them with the native decoder, or where it did not
    build with :mod:`fal_net_torch.native.png16`.  It raises on a PNG that
    is not 3 channels of uint16 (an 8-bit file)."""
    from fal_net_torch.native import io as native_io, png16

    if native_io.available():
        raw = native_io.imread(path)  # RGB channel order
    else:
        with open(path, "rb") as f:
            buf = f.read()
        try:
            raw = png16.decode(buf)
        except ValueError as e:
            raise ValueError(f"not a KITTI flow PNG (need 3 uint16 channels): {path}: {e}") from e
    if raw.ndim != 3 or raw.shape[-1] < 3 or raw.dtype != np.uint16:
        raise ValueError(f"not a KITTI flow PNG (need 3 uint16 channels): {path}")
    rgb = raw.astype(np.float32)
    u = (rgb[..., 0] - 2.0**15) / 64.0
    v = (rgb[..., 1] - 2.0**15) / 64.0
    valid = (rgb[..., 2] > 0).astype(np.float32)
    return np.stack([u * valid, v * valid, valid], axis=-1)


def load_make3d_depth(path: str) -> np.ndarray:
    """Make3D's .mat Position3DGrid depth, NEAREST-resized to 1704x2272
    (listdataset_test.py:29-35)."""
    import scipy.io as sio

    mat = sio.loadmat(path, verify_compressed_data_integrity=False)
    depth = Image.fromarray(mat["Position3DGrid"][:, :, 3]).resize((1704, 2272), resample=Image.NEAREST)
    return np.asarray(depth)[..., None].astype(np.float32)


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


@dataclass
class StereoEvalDataset:
    """Evaluation sampler: a stereo pair and its ground-truth target(s).

    Items are ``((paths...), targets)``: paths the (L, R) pair or, for
    KITTI-2015 scene-flow items (Kitti2015.py:36-52), (L_t, R_t, L_t+1,
    R_t+1), the second pair yielded as ``left_t1`` / ``right_t1``.
    ``target_loaders`` gives one loader per target slot (a None slot is
    skipped); else ``target_loader`` loads every slot.  ``load_t1`` decodes
    the t+1 pair (no evaluation reads it).  ``raw_uint8`` yields ``left`` as
    the decoded uint8 RGB instead of normalized float32, for an upload 4x
    smaller with the normalization on the device
    (data/transforms.py::normalize_device); settable after construction.
    """

    root: str
    items: List[Tuple[Tuple[str, ...], Optional[List[str]]]]
    target_loader: Optional[Callable[[str], np.ndarray]] = None
    target_loaders: Optional[List[Optional[Callable[[str], np.ndarray]]]] = None
    load_t1: bool = True
    raw_uint8: bool = False

    def __len__(self) -> int:
        return len(self.items)

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        paths, targets = self.items[index]
        lp, rp = paths[0], paths[1]
        left = _imread(os.path.join(self.root, lp))
        sample = {
            "left": np.ascontiguousarray(left) if self.raw_uint8 else normalize(left),
            "right": normalize(_imread(os.path.join(self.root, rp))),
            "name": os.path.basename(lp)[:-4],
        }
        if len(paths) >= 4 and self.load_t1:
            sample["left_t1"] = normalize(_imread(os.path.join(self.root, paths[2])))
            sample["right_t1"] = normalize(_imread(os.path.join(self.root, paths[3])))
        if targets:
            loaders = self.target_loaders or [self.target_loader] * len(targets)
            loaded = [ld(os.path.join(self.root, t)) for t, ld in zip(targets, loaders) if ld is not None]
            if loaded:
                sample["targets"] = loaded
        return sample


def _pairs_from_lines(lines: List[str], root: str, check_exists: bool = True) -> List[Tuple[str, str]]:
    """(left, right) pairs of the lines (with ``check_exists``, only those
    whose left image is on disk)."""
    pairs = [(a, b) for a, b, *_ in (ln.split(" ") for ln in lines)]
    if check_exists:
        pairs = [p for p in pairs if os.path.isfile(os.path.join(root, p[0]))]
    return pairs


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


def kitti2015(root: str, split=0.0, disp: bool = True, of: bool = False, load_t1: bool = True,
              lists_dir: Optional[str] = None):
    """KITTI 2015 scene flow (Kitti2015.py:26-96).

    ``disp`` or ``of``: 200 ``training`` items of four images, the stereo
    pair at frames _10 and _11, with ``[disp_occ_0, flow_occ]`` targets,
    kept only where all four images exist, split by ``split``.  The
    disparity target loads with ``disp``, the flow target with ``of`` (see
    :func:`load_kitti_flow_png`).  Neither: no targets; the train list is
    both frames of ``training`` as separate pairs, the test list both
    frames of ``testing``.
    """
    if disp or of:
        items = []
        for i in range(200):
            paths = tuple(
                os.path.join("training", cam, f"{i:06d}_{fr}.png")
                for fr in ("10", "11")
                for cam in ("image_2", "image_3")
            )  # (L_10, R_10, L_11, R_11)
            if not all(os.path.isfile(os.path.join(root, p)) for p in paths):
                continue  # the reference needs all 4 frames (Kitti2015.py:44-49)
            d = os.path.join("training", "disp_occ_0", f"{i:06d}_10.png")
            f = os.path.join("training", "flow_occ", f"{i:06d}_10.png")
            items.append((paths, [d, f]))
        if not items and os.path.isfile(os.path.join(root, "training", "image_2", "000000_10.png")):
            import warnings

            warnings.warn(
                f"kitti2015: scene-flow mode found _10 frames under {root} but no complete (_10, _11) "
                "quadruples - the reference requires all 4 images per item (Kitti2015.py:44-49). The "
                "validation set is EMPTY; restore the _11 frames or use disp=False of=False (GT-free mode)."
            )
        loaders = [load_kitti_disp_png if disp else None, load_kitti_flow_png if of else None]
        mk = lambda lst: StereoEvalDataset(root, lst, target_loaders=loaders, load_t1=load_t1)
        train, test = split2list(items, split)
        return mk(train), mk(test)

    def scan(mode: str) -> list:
        out = []
        for i in range(200):
            for fr in ("10", "11"):
                lp = os.path.join(mode, "image_2", f"{i:06d}_{fr}.png")
                rp = os.path.join(mode, "image_3", f"{i:06d}_{fr}.png")
                if os.path.isfile(os.path.join(root, lp)) and os.path.isfile(os.path.join(root, rp)):
                    out.append(((lp, rp), None))
        return out

    return StereoEvalDataset(root, scan("training")), StereoEvalDataset(root, scan("testing"))


def kitti_eigen_test_improved(root: str, split=1, lists_dir: Optional[str] = None):
    """The improved Eigen split: groundtruth and raw-velodyne depth PNGs
    found from the image path (Kitti_eigen_test_improved.py:26-58)."""
    items = []
    for lp, rp in _pairs_from_lines(_list_lines(lists_dir, "kitti_eigen_test_improved.txt"), root, False):
        drive, frame = lp[:-29], lp[-14:]
        gt = os.path.join(drive, "proj_depth", "groundtruth", "image_02", frame)
        velo = os.path.join(drive, "proj_depth", "velodyne_raw", "image_02", frame)
        if os.path.isfile(os.path.join(root, gt)) and os.path.isfile(os.path.join(root, lp)):
            items.append(((lp, rp), [gt, velo]))
    train, test = split2list(items, split)
    mk = lambda lst: StereoEvalDataset(root, lst, load_kitti_disp_png)
    return mk(train), mk(test)


def kitti_eigen_test_original(root: str, split=1, lists_dir: Optional[str] = None):
    """The original Eigen split: .npy depths beside the images
    (Kitti_eigen_test_original.py:25-49)."""
    items = []
    for lp, rp in _pairs_from_lines(_list_lines(lists_dir, "kitti_eigen_test_original.txt"), root, False):
        gt = lp[:-3] + "npy"
        if os.path.isfile(os.path.join(root, gt)) and os.path.isfile(os.path.join(root, lp)):
            items.append(((lp, rp), [gt]))
    train, test = split2list(items, split)
    mk = lambda lst: StereoEvalDataset(root, lst, load_depth_npy)
    return mk(train), mk(test)


def cityscapes_jpg(root: str, split=1, co_transform: Optional[Compose] = None, max_pix: float = 300.0,
                   fix: bool = True, lists_dir: Optional[str] = None):
    """Cityscapes leftImg8bit / rightImg8bit JPG trees; the 'val' subtree is
    the validation split (Cityscapes_jpg.py:25-53)."""
    train_pairs, val_pairs = [], []
    left_root = os.path.join(root, "leftImg8bit")
    for ttv in sorted(os.listdir(left_root)):
        sub = os.path.join(left_root, ttv)
        if not os.path.isdir(sub):
            continue
        bucket = val_pairs if ttv == "val" else train_pairs
        for city in sorted(os.listdir(sub)):
            cdir = os.path.join(sub, city)
            if not os.path.isdir(cdir):
                continue
            for lpath in sorted(glob.iglob(os.path.join(cdir, "*.jpg"))):
                base = os.path.basename(lpath)[: -len("leftImg8bit.jpg")]
                lp = os.path.join("leftImg8bit", ttv, city, base + "leftImg8bit.jpg")
                rp = os.path.join("rightImg8bit", ttv, city, base + "rightImg8bit.jpg")
                if os.path.isfile(os.path.join(root, rp)):
                    bucket.append((lp, rp))
    mk = lambda lst, ct: StereoTrainDataset(root, lst, ct, max_pix, fix)
    return mk(train_pairs, co_transform), mk(val_pairs, None)


def make3d(root: str, split=1, lists_dir: Optional[str] = None):
    """Make3D zero-shot evaluation: *.jpg and depth_sph_corr*.mat
    (Make3D.py:26-44)."""
    items = []
    for p in sorted(glob.glob(os.path.join(root, "*.jpg"))):
        base = os.path.basename(p)
        items.append(((base, base), ["depth_sph_corr" + base[3:-3] + "mat"]))
    train, test = split2list(items, split)
    mk = lambda lst: StereoEvalDataset(root, lst, load_make3d_depth)
    return mk(train), mk(test)


@dataclass
class ConcatDataset:
    """Mixed-dataset training (KITTI + Cityscapes; the reference ships only
    the Cityscapes dataset and defers the mixed trainer, README.md:30)."""

    parts: List

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    def get(self, index: int, rng: np.random.Generator):
        for p in self.parts:
            if index < len(p):
                return p.get(index, rng)
            index -= len(p)
        raise IndexError(index)


def mixed_train(datasets) -> ConcatDataset:
    return ConcatDataset(list(datasets))


def kitti_cs_train(root: str, split=1, co_transform: Optional[Compose] = None, max_pix: float = 300.0,
                   fix: bool = True, lists_dir: Optional[str] = None):
    """KITTI + Cityscapes mixed training.  ``root`` is one directory holding
    both trees, or ``'KITTI_ROOT,CITYSCAPES_ROOT'``.  Validation stays on
    the KITTI side."""
    parts = [p for p in root.split(",") if p]
    k_root, c_root = parts[0], parts[1] if len(parts) > 1 else parts[0]
    k_train, k_val = kitti_train(k_root, split, co_transform, max_pix, fix, lists_dir)
    c_train, _ = cityscapes_jpg(c_root, split, co_transform, max_pix, fix)
    return mixed_train([k_train, c_train]), k_val


# Reference-compatible name lookup (Datasets.__dict__[name] pattern).  Every
# factory takes ``lists_dir``; those that scan their tree instead of reading
# a split list ignore it.
REGISTRY: Dict[str, Callable] = {
    "Kitti": kitti_train,
    "kitti": kitti_train,
    "Kitti2015": kitti2015,
    "kitti2015": kitti2015,
    "Kitti_eigen_test_improved": kitti_eigen_test_improved,
    "Kitti_eigen_test_original": kitti_eigen_test_original,
    "Cityscapes_jpg": cityscapes_jpg,
    "cityscapes": cityscapes_jpg,
    "Kitti_CS": kitti_cs_train,
    "kitti_cs": kitti_cs_train,
    "Make3D": make3d,
    "make3d": make3d,
}
# The factories that return (train, val) training samplers: the ones
# ``cli.train --dataset`` can train on.
TRAIN_FACTORIES = (kitti_train, cityscapes_jpg, kitti_cs_train)
