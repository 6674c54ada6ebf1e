"""Inference CLI: a directory of images -> 16-bit disparity PNGs
(counterpart of fal_net_tpu/cli/infer.py, checkpoint mode).

    python -m fal_net_torch.cli.infer --images /data/frames --out_dir out \\
        --pretrained ckpt.pt            # a port .pt or a reference .pth.tar

Each image is resized to the model resolution, run through the batched
pipeline (eval/pipeline.py) with a raw uint8 upload and on-device
normalization, and its disparity is resized back and rescaled by the width
ratio (disparity is in pixels, so it scales with width).  Output per image:
``<name>_disp.png``, uint16 with value*256 (the KITTI convention).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def list_images(root: str) -> List[str]:
    if os.path.isfile(root):
        return [root]
    return [
        os.path.join(root, name)
        for name in sorted(os.listdir(root))
        if name.lower().endswith(IMG_EXTS)
    ]


def load_uint8(path: str, height: int, width: int):
    """-> (HWC uint8 RGB at (height, width), original (H, W))."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        orig = (im.height, im.width)
        if orig != (height, width):
            im = im.resize((width, height), Image.BILINEAR)
        return np.asarray(im, np.uint8), orig


def restore_disparity(disp_hw: np.ndarray, orig_hw: Tuple[int, int]) -> np.ndarray:
    """Resize a disparity map back to the original resolution, rescaling
    values by the width ratio."""
    from PIL import Image

    h, w = orig_hw
    if disp_hw.shape == (h, w):
        return disp_hw
    scale = w / disp_hw.shape[1]
    im = Image.fromarray(np.asarray(disp_hw, np.float32))
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) * scale


def save_disp16(path: str, disp_hw: np.ndarray) -> None:
    """uint16 PNG, value*256 (the KITTI disparity file convention); the
    format's ceiling is 65535/256 = 255.996 px, and values above clip.
    Written by the native encoder where it builds, else by PIL: the same
    uint16 values either way (the compressed rows may be filtered apart)."""
    from fal_net_torch.native import io as native_io

    u16 = np.clip(np.asarray(disp_hw, np.float64) * 256.0, 0, 65535).astype(np.uint16)
    if native_io.available():
        native_io.imwrite_png16(path, u16)
        return
    from PIL import Image

    Image.fromarray(u16).save(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fal_net_torch batch inference")
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--pretrained", required=True, help="port .pt or reference .pth.tar")
    p.add_argument("--model", default=None, help="variant override")
    p.add_argument("--no_levels", type=int, default=None)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_disp", type=float, default=300.0)
    p.add_argument("--min_disp", type=float, default=2.0)
    p.add_argument("--ms_post_process", action="store_true",
                   help="the reference's multi-scale post-process: a second forward at 2/3 scale on the "
                   "flipped image, blended in by each image's 95th percentile")
    p.add_argument(
        "--quantize_transfer",
        action="store_true",
        help="fetch disparities as device-quantized 16-bit values (half the "
        "device->host bytes). Quantizes to 1/256 px AT THE INFERENCE "
        "RESOLUTION and caps values at 255.996 px, so leave this off "
        "when inputs are resized or disparities can exceed 256",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> int:
    """Returns the number of images written."""
    args = build_parser().parse_args(argv)
    paths = list_images(args.images)
    if not paths:
        raise SystemExit(f"no images under {args.images}")
    os.makedirs(args.out_dir, exist_ok=True)

    from fal_net_torch.eval.pipeline import DisparityPipeline
    from fal_net_torch.models.checkpoint import load_checkpoint

    model = load_checkpoint(
        args.pretrained, variant=args.model, num_levels=args.no_levels, device=args.device
    )
    pipe = DisparityPipeline(
        model,
        batch_size=args.batch_size,
        min_disp=args.min_disp,
        max_disp=args.max_disp,
        ms_post_process=args.ms_post_process,
        quantize_uint16=args.quantize_transfer,
        device_normalize=True,
    )

    # Unique output names: the stem alone collides for inputs differing only
    # by extension (img.jpg + img.png).
    names, used = {}, set()
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        name, k = stem, 0
        while name in used:
            k += 1
            name = f"{stem}.{k}"
        used.add(name)
        names[path] = name

    origs = {}

    def items():
        for path in paths:
            img, orig = load_uint8(path, args.height, args.width)
            origs[names[path]] = orig
            yield names[path], img

    n = 0
    for name, disp in pipe.run(items()):
        disp = restore_disparity(disp, origs[name])
        save_disp16(os.path.join(args.out_dir, f"{name}_disp.png"), disp)
        n += 1
    print(f"=> wrote disparities for {n} images to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
