"""Evaluation CLI (counterpart of fal_net_tpu/cli/test.py; reference
Test_KITTI.py).

    python -m fal_net_torch.cli.test --data_root /data/KITTI \\
        --lists_dir /data/lists --pretrained ckpt.pt --tdataName Kitti_eigen_test_improved

    python -m fal_net_torch.cli.test --data_root /data/KITTI \\
        --lists_dir /data/lists --artifact bundle.pt2z     # a serving artifact

``--pretrained`` takes a port ``.pt``, a reference ``.pth.tar`` or a JAX
msgpack checkpoint (or its run directory); ``--artifact`` a serving
artifact from ``cli.export``, evaluated exactly as it is deployed (the
checkpoint-mode flags it bakes in are refused, ``--num_devices`` among
them, as JAX refuses them).  Runs on the GPU unless ``--device cpu`` is
given (an artifact runs on the device type it was exported for).
``--dtype bfloat16`` runs the backbone in bf16 (the MED head stays fp32);
``--num_devices N`` splits each batch over N cards, one model replica each
(N CPU replicas with ``--device cpu``), and ``--batch_size`` must divide by
it.  Writes ``errors.txt`` and ``metrics.json`` under ``--save_path``
(eval/evaluate.py).
"""

from __future__ import annotations

import argparse

from fal_net_torch.data.datasets import (
    kitti2015,
    kitti_eigen_test_improved,
    kitti_eigen_test_original,
    make3d,
)
from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
from fal_net_torch.models.checkpoint import load_checkpoint
from fal_net_torch.parallel.mesh import make_mesh

# checkpoint-mode flags an artifact bakes in (or fixes); giving one with --artifact is refused
ARTIFACT_FIXED = ("model", "no_levels", "max_disp", "min_disp", "rel_baseline", "dtype", "maskr_quirk",
                  "batch_size", "fp32_upload", "num_devices")

EVAL_DATASETS = {
    "Kitti_eigen_test_improved": kitti_eigen_test_improved,
    "Kitti_eigen_test_original": kitti_eigen_test_original,
    "Kitti2015": kitti2015,
    "Make3D": make3d,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fal_net_torch evaluator")
    p.add_argument("--tdataName", default="Kitti_eigen_test_improved", choices=sorted(EVAL_DATASETS))
    p.add_argument("--data_root", required=True)
    p.add_argument("--lists_dir", default=None)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pretrained", help="port .pt, reference .pth.tar or JAX msgpack checkpoint")
    src.add_argument("--artifact", help="serving artifact or bundle from cli.export")
    p.add_argument("--model", default=None, help="override model variant")
    p.add_argument("--no_levels", type=int, default=None)
    p.add_argument("--max_disp", type=float, default=300.0)
    p.add_argument("--min_disp", type=float, default=2.0)
    p.add_argument("--rel_baselne", "--rel_baseline", dest="rel_baseline", type=float, default=1.0)
    p.add_argument("--f_post_process", action="store_true")
    p.add_argument("--no_ms_post_process", action="store_true")
    p.add_argument("--median", action="store_true")
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_pan", action="store_true")
    p.add_argument("--save_input", action="store_true")
    p.add_argument("--save_pc", action="store_true")
    p.add_argument("--save_path", default="Test_Results")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument(
        "--maskr_quirk", action="store_true",
        help="bit-for-bit FAL_netA maskR compat: reproduce the reference's align_corners-less maskR warp "
        "(models/FAL_netA.py:264) for published A checkpoints",
    )
    p.add_argument(
        "--batch_size", type=int, default=8,
        help="images per forward within a shape bucket (metrics are per image and the same at any batch "
        "size; the reference forces 1, Test_KITTI.py:113)",
    )
    p.add_argument(
        "--decode_workers", type=int, default=4,
        help="threads decoding images ahead of the device, in order (the metrics equal 0 = inline decode)",
    )
    p.add_argument(
        "--quantize_transfer", action="store_true",
        help="fetch disparities as device-quantized 16-bit values (1/256 px, the KITTI GT PNG fixed point; "
        "half the device->host bytes, metrics shift ~1e-5; caps at 255.996 px)",
    )
    p.add_argument(
        "--fp32_upload", action="store_true",
        help="upload host-normalized fp32 images instead of the default raw uint8 with the normalization "
        "on the device (4x fewer host->device bytes)",
    )
    p.add_argument(
        "--no_med_selfcheck", action="store_true",
        help="skip the gate that holds the MED kernel against the plain head at each new evaluation shape "
        "(on by default; a disagreement raises)",
    )
    p.add_argument("--num_devices", type=int, default=None,
                   help="split each evaluation batch over this many cards, one model replica each (batch_size "
                   "must be divisible by it)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Returns the metrics the Evaluator wrote to metrics.json."""
    parser = build_parser()
    args = parser.parse_args(argv)
    fwd = model = mesh = None
    if args.artifact:
        fixed = [name for name in ARTIFACT_FIXED if getattr(args, name) != parser.get_default(name)]
        if fixed:
            raise SystemExit("--artifact mode evaluates the deployed forward exactly; these checkpoint-mode "
                             "flags have no effect here: " + ", ".join("--" + n for n in fixed)
                             + ".  Re-export with cli.export to change them.")
        from fal_net_torch.serve import load_exported

        fwd = load_exported(args.artifact, device=args.device)
        shapes = fwd.meta.get("shapes") or [[fwd.meta["height"], fwd.meta["width"]]]
        print(f"=> loaded artifact {args.artifact} ({fwd.meta['variant']}, N={fwd.meta['num_levels']}, "
              f"shapes {shapes}, batch {fwd.meta['batch']}, {fwd.meta['input']} input)")
    else:
        if args.num_devices and args.num_devices > 1:
            mesh = make_mesh(args.num_devices, device=args.device)
        model = load_checkpoint(args.pretrained, variant=args.model, num_levels=args.no_levels,
                                device=mesh.devices[0] if mesh else args.device, a_maskr_quirk=args.maskr_quirk,
                                dtype=args.dtype)
        print(f"=> loaded {model.spec.torch_name} (N={model.num_levels}, {args.dtype}) from {args.pretrained}"
              + (f" on {[str(d) for d in mesh.devices]}" if mesh else ""))

    factory = EVAL_DATASETS[args.tdataName]
    _, dataset = factory(args.data_root, split=0, lists_dir=args.lists_dir)
    print(f"=> {len(dataset)} evaluation samples")
    if fwd is not None:
        dataset.raw_uint8 = fwd.meta["input"] == "uint8"  # the artifact's input stage decides
    elif not args.fp32_upload:
        dataset.raw_uint8 = True  # 4x fewer upload bytes; the Evaluator normalizes on the device

    cfg = EvalConfig(
        dataset=args.tdataName,
        max_disp=args.max_disp,
        min_disp=args.min_disp,
        rel_baseline=args.rel_baseline,
        batch_size=args.batch_size,
        decode_workers=args.decode_workers,
        quantize_transfer=args.quantize_transfer,
        f_post_process=args.f_post_process,
        ms_post_process=not args.no_ms_post_process and not args.f_post_process,
        use_median=args.median,
        save=args.save,
        save_pan=args.save_pan,
        save_input=args.save_input,
        save_point_cloud=args.save_pc,
        save_path=args.save_path,
        med_selfcheck=not args.no_med_selfcheck,
    )
    evaluator = Evaluator(model, cfg, mesh=mesh) if fwd is None else Evaluator.from_artifact(fwd, cfg)
    metrics = evaluator.run(dataset)
    print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


def run(argv=None) -> None:
    """The ``falnet-torch-test`` console script: :func:`main` without
    the metrics, which the script would pass to ``sys.exit`` as a failure."""
    main(argv)


if __name__ == "__main__":
    main()
