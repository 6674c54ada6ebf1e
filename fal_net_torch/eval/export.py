"""Artifact exporters (counterpart of fal_net_tpu/eval/export.py;
Test_KITTI.py:211-253, myUtils.py:339-394), HWC numpy on the host:

  * the disparity PNG in the plasma colour map, normalized by its 95th
    percentile.  The JAX package draws it with ``plt.imsave``; the port
    keeps plasma's 256-entry table (matplotlib's ``plasma`` as bytes) and
    writes the PNG with PIL, so that it needs no matplotlib;
  * the point cloud .ply by the pinhole model;
  * de-normalized input and pan PNGs, and per-channel feature maps.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

from fal_net_torch.data.transforms import RGB_MEAN
from fal_net_torch.eval.metrics import WIDTH_TO_BASELINE, WIDTH_TO_FOCAL

# matplotlib's "plasma" colour map, its 256 entries as RGB bytes (alpha 255):
# plt.get_cmap("plasma")(np.arange(256), bytes=True)[:, :3]
PLASMA_RGB = np.frombuffer(bytes.fromhex(
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f2305902505912705922905932b05942d04942f0495"
    "3104963304973404983604983804993a049a3b039a3d039b3f039c40039c42039d44039e45039e47029f49029f4a02a0"
    "4c02a14e02a14f02a25101a25201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
    "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a87801a87901a87b02a87c02a7"
    "7e03a77f03a78104a78204a78405a68506a68607a68807a58908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a1"
    "9511a19612a09713a099149f9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8bb7308ab83289b93388ba3487"
    "bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678"
    "cb4777cc4876cd4975ce4a75cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
    "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660e3675fe3685ee46a5de56b5c"
    "e56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4e"
    "f0804df0814df1824cf2844bf2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436fca635fca735fca934fcaa33"
    "fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62dfdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328"
    "fdc427fdc626fcc726fcc926fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
    "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126f1f326f0f525f0f623eff821"
), np.uint8).reshape(256, 3)


def save_disparity_png(path: str, disp_hw: np.ndarray) -> None:
    """Plasma-coloured disparity normalized by its 95th percentile
    (Test_KITTI.py:213-216): the RGBA pixels ``plt.imsave(path, v,
    cmap="plasma", vmin=0, vmax=256)`` writes for v = rint(256 * clip(disp /
    (p95 + 1e-6), 0, 1)), i.e. entry min(v, 255) of the table."""
    disp = np.asarray(disp_hw, np.float64)
    level = np.rint(256 * np.clip(disp / (np.percentile(disp, 95) + 1e-6), 0, 1)).astype(np.int64)
    rgb = PLASMA_RGB[np.minimum(level, 255)]
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    Image.fromarray(rgba, "RGBA").save(path)


def save_image_png(path: str, image_hwc: np.ndarray, denormalize: bool = True) -> None:
    img = np.asarray(image_hwc, np.float32)
    if denormalize:
        img = img + RGB_MEAN
    Image.fromarray(np.rint(255 * np.clip(img, 0, 1)).astype(np.uint8)).save(path)


def save_feature_pngs(dir_path: str, tag: str, feat_hwc: np.ndarray) -> None:
    """Per-channel grayscale dumps of |feature| * 255 clipped to 255
    (Test_KITTI.py:245-253)."""
    os.makedirs(dir_path, exist_ok=True)
    feat = np.clip(np.abs(np.asarray(feat_hwc, np.float32)) * 255, 0, 255)
    for c in range(feat.shape[-1]):
        Image.fromarray(np.rint(feat[..., c]).astype(np.uint8)).save(os.path.join(dir_path, f"{tag}_c{c}.png"))


def disparity_to_point_cloud(
    image_hwc: np.ndarray,
    disp_hw: np.ndarray,
    focal: Optional[float] = None,
    baseline: Optional[float] = None,
) -> np.ndarray:
    """Disparity -> (H*W, 6) rows [x, z, -y, r, g, b] (myUtils.py:339-373;
    the reference's axes for viewing in Blender); image in 0..255, z capped
    to [0, 200] m."""
    h, w = disp_hw.shape
    focal = focal if focal is not None else WIDTH_TO_FOCAL[w]
    baseline = baseline if baseline is not None else WIDTH_TO_BASELINE[w]
    z = focal * baseline / (np.asarray(disp_hw, np.float64) + 1e-4)
    # pixel centres: affine_grid (align_corners=False) unnormalized by
    # (u+1)/2*size lands on x+0.5 (myUtils.py:352-360)
    u = np.arange(w, dtype=np.float64)[None, :] + 0.5
    v = np.arange(h, dtype=np.float64)[:, None] + 0.5
    x = ((u - w / 2) / focal) * z
    y = ((v - h / 2) / focal) * z
    z = np.clip(z, 0, 200)
    rgb = np.asarray(image_hwc, np.float64).reshape(h * w, 3)
    pts = np.stack([x.ravel(), z.ravel(), -y.ravel()], axis=1)
    return np.concatenate([pts, rgb], axis=1)


def save_point_cloud_ply(path: str, xyzrgb: np.ndarray) -> None:
    """ASCII .ply (myUtils.py:376-394)."""
    header = "\n".join([
        "ply",
        "format ascii 1.0",
        f"element vertex {xyzrgb.shape[0]}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar diffuse_red",
        "property uchar diffuse_green",
        "property uchar diffuse_blue",
        "end_header",
    ])
    with open(path, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, xyzrgb, fmt="%f %f %f %d %d %d")
