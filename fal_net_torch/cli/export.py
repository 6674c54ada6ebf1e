"""Export CLI: checkpoint -> single-file serving artifact (counterpart of
fal_net_tpu/cli/export.py).

    python -m fal_net_torch.cli.export --pretrained ckpt.pt \\
        --height 384 --width 1280 --batch 1 --out falnetB_384x1280.pt2z

Takes a port ``.pt`` or a reference ``.pth.tar``.  The artifact bakes the
weights in and runs through ``fal_net_torch.serve.load_exported`` on the
device type it was exported for (``--device``, the card by default; JAX's
``--platforms`` lists TPU lowerings instead), with no model code or
checkpoint on the serving host.  On the card its MED head is K1.
``--pretrained`` also takes a JAX msgpack checkpoint; ``--dtype bfloat16``
bakes in a bf16 backbone (the MED head and the outputs stay fp32).
"""

from __future__ import annotations

import argparse

from fal_net_torch.eval.postprocess import MS_UP_FAC


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fal_net_torch export")
    p.add_argument("--pretrained", required=True, help="port .pt, reference .pth.tar or JAX msgpack checkpoint")
    p.add_argument("--model", default=None, help="override model variant")
    p.add_argument("--no_levels", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument(
        "--sizes", default=None,
        help="comma-separated HxW list (e.g. 375x1242,370x1224): export a multi-shape BUNDLE covering every "
        "bucket (overrides --height/--width); the loaded artifact dispatches by input shape",
    )
    p.add_argument(
        "--with_ms_pp", action="store_true",
        help="also export each size's 2/3-scale shape, so that artifact-based evaluation (cli.test --artifact) "
        "can run the default multi-scale post-processing",
    )
    p.add_argument("--max_disp", type=float, default=300.0)
    p.add_argument("--min_disp", type=float, default=2.0)
    p.add_argument("--pan", action="store_true", help="also emit the pan view")
    p.add_argument("--subocc", action="store_true", help="also emit maskL/maskR")
    p.add_argument("--uint8_input", action="store_true",
                   help="artifact takes raw uint8 RGB and normalizes on the device (4x smaller uploads)")
    p.add_argument("--device", default="cuda", help="torch device the artifact runs on (default: cuda)")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="backbone compute dtype baked into the artifact (the disparity stays fp32)")
    p.add_argument("--out", required=True)
    return p


def shapes_of(sizes, with_ms_pp: bool, height: int, width: int) -> list:
    """The bundle's (H, W) shapes: ``--sizes`` (or, with ``--with_ms_pp``
    alone, --height x --width), each followed by its 2/3 shape under
    ``with_ms_pp``; [] for a single-shape artifact."""
    shapes = []
    if sizes:
        for tok in sizes.split(","):
            h, w = tok.strip().lower().split("x")
            shapes.append((int(h), int(w)))
    elif with_ms_pp:
        shapes = [(height, width)]
    if with_ms_pp:
        for h, w in list(shapes):
            small = (int(h * MS_UP_FAC), int(w * MS_UP_FAC))  # eval/postprocess.py::ms_post_process's scale
            if small not in shapes:
                shapes.append(small)
    return shapes


def main(argv=None) -> int:
    """Returns the artifact's size in bytes."""
    args = build_parser().parse_args(argv)
    if args.uint8_input and args.with_ms_pp:
        # ms-pp resamples the float input for its second pass, which a uint8
        # artifact hides behind its baked normalization; Evaluator.from_artifact
        # refuses the pair, so fail before the bundle ships
        raise SystemExit("--with_ms_pp needs a float32-input artifact; drop --uint8_input (ms-pp resamples "
                         "the input, which a uint8 artifact hides behind its baked normalization)")
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.serve import export_bundle, export_forward, save_exported

    model = load_checkpoint(args.pretrained, variant=args.model, num_levels=args.no_levels, device=args.device,
                            dtype=args.dtype)
    kw = dict(min_disp=args.min_disp, max_disp=args.max_disp, ret_pan=args.pan, ret_subocc=args.subocc,
              device=args.device, uint8_input=args.uint8_input)
    shapes = shapes_of(args.sizes, args.with_ms_pp, args.height, args.width)
    if shapes:
        blob = export_bundle(model, shapes, batch=args.batch, **kw)
    else:
        blob = export_forward(model, batch=args.batch, height=args.height, width=args.width, **kw)
    save_exported(args.out, blob)
    print(f"=> exported {len(blob)} bytes to {args.out} ({shapes or [(args.height, args.width)]}, batch {args.batch}, "
          f"{args.dtype})")
    return len(blob)


def run(argv=None) -> None:
    """The ``falnet-torch-export`` console script: :func:`main` without
    the artifact's size, which the script would pass to ``sys.exit`` as a failure."""
    main(argv)


if __name__ == "__main__":
    main()
