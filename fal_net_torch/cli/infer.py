"""Inference CLI: a directory of images -> disparity maps (counterpart of
fal_net_tpu/cli/infer.py).

    python -m fal_net_torch.cli.infer --images /data/frames --out_dir out \\
        --pretrained ckpt.pt            # a port .pt, a reference .pth.tar or a JAX .msgpack
    python -m fal_net_torch.cli.infer --images /data/frames --out_dir out \\
        --artifact falnetB.pt2z         # a serving artifact from cli.export

Each image is resized to the model resolution (a bundle's nearest shape),
run through the batched pipeline (eval/pipeline.py) with a raw uint8 upload
and on-device normalization, or through the artifact in batches of its own
size, and its disparity is resized back and rescaled by the width ratio
(disparity is in pixels, so it scales with width).  Output per image:
``<name>_disp.png``, uint16 with value*256 (the KITTI convention), and with
``--colormap`` a plasma PNG, with ``--save_pc`` a ``.ply`` point cloud.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Iterator, List, Tuple

import numpy as np

from fal_net_torch.data.transforms import normalize

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
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pretrained", help="port .pt, reference .pth.tar or JAX msgpack checkpoint")
    src.add_argument("--artifact", help="serving artifact or bundle from cli.export")
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
    p.add_argument("--colormap", action="store_true", help="also write plasma-colormap PNGs")
    p.add_argument("--save_pc", action="store_true", help="also write .ply point clouds")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


# checkpoint-mode flags an artifact bakes in (or fixes); giving one with --artifact is refused
ARTIFACT_FIXED = ("ms_post_process", "quantize_transfer", "batch_size", "min_disp", "max_disp", "height", "width",
                  "model", "no_levels")


def run_artifact(fwd, items) -> Iterator[Tuple[str, np.ndarray]]:
    """``(name, disparity)`` of ``(name, HWC image)`` items through a loaded
    artifact (``serve.load_exported``): images are bucketed by shape and
    each bucket runs in batches of the artifact's size, the last one padded
    with zero images."""
    bs = fwd.meta["batch"]
    buckets = {}

    def flush(key):
        names, imgs = buckets.pop(key)
        batch = np.stack(imgs + [np.zeros_like(imgs[0])] * (bs - len(imgs)))
        disp = fwd(batch)[0][..., 0].cpu().numpy()
        yield from zip(names, disp)

    for name, img in items:
        names, imgs = buckets.setdefault(img.shape, ([], []))
        names.append(name)
        imgs.append(img)
        if len(imgs) == bs:
            yield from flush(img.shape)
    for key in list(buckets):
        yield from flush(key)


def main(argv=None) -> int:
    """Returns the number of images written."""
    parser = build_parser()
    args = parser.parse_args(argv)
    paths = list_images(args.images)
    if not paths:
        raise SystemExit(f"no images under {args.images}")
    os.makedirs(args.out_dir, exist_ok=True)

    if args.artifact:
        fixed = [name for name in ARTIFACT_FIXED if getattr(args, name) != parser.get_default(name)]
        if fixed:
            raise SystemExit("--artifact mode bakes the forward into the export; these checkpoint-mode flags "
                             "have no effect here: " + ", ".join("--" + n for n in fixed)
                             + ".  Re-export with cli.export to change them.")
        from fal_net_torch.serve import load_exported

        fwd = load_exported(args.artifact, device=args.device)
        shapes = [tuple(s) for s in fwd.meta.get("shapes", [(fwd.meta["height"], fwd.meta["width"])])]
    else:
        shapes = [(args.height, args.width)]

    def target(path):
        """The nearest shape by log-scale distance (keeps aspect and
        resolution close); the only one without a bundle."""
        if len(shapes) == 1:
            return shapes[0]
        from PIL import Image

        with Image.open(path) as im:  # the header only
            oh, ow = im.height, im.width
        return min(shapes, key=lambda s: abs(math.log(s[0] / oh)) + abs(math.log(s[1] / ow)))

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

    def items(raw_uint8: bool = True):
        for path in paths:
            img, orig = load_uint8(path, *target(path))
            origs[names[path]] = (orig, path)
            yield names[path], img if raw_uint8 else normalize(img)

    if args.artifact:
        results = run_artifact(fwd, items(raw_uint8=fwd.meta["input"] == "uint8"))
    else:
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
        results = pipe.run(items())

    n = 0
    for name, disp in results:
        orig, src = origs[name]
        disp = restore_disparity(disp, orig)
        save_disp16(os.path.join(args.out_dir, f"{name}_disp.png"), disp)
        if args.colormap:
            from fal_net_torch.eval.export import save_disparity_png

            save_disparity_png(os.path.join(args.out_dir, f"{name}_cmap.png"), disp)
        if args.save_pc:
            save_point_cloud(os.path.join(args.out_dir, f"{name}.ply"), src, disp)
        n += 1
    print(f"=> wrote disparities for {n} images to {args.out_dir}")
    return n


def save_point_cloud(path: str, image_path: str, disp: np.ndarray) -> None:
    """The image's point cloud from its disparity: KITTI's camera where the
    width is one of KITTI's, else f = 0.58 W and a 54 cm baseline."""
    from PIL import Image

    from fal_net_torch.eval.export import disparity_to_point_cloud, save_point_cloud_ply
    from fal_net_torch.eval.metrics import WIDTH_TO_BASELINE, WIDTH_TO_FOCAL

    with Image.open(image_path) as im:
        rgb = np.asarray(im.convert("RGB"), np.float64)
    w = disp.shape[1]
    pc = disparity_to_point_cloud(rgb, disp, focal=WIDTH_TO_FOCAL.get(w, 0.58 * w),
                                  baseline=WIDTH_TO_BASELINE.get(w, 0.54))
    save_point_cloud_ply(path, pc)


if __name__ == "__main__":
    main()
