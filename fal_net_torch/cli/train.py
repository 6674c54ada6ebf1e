"""Training CLI, the three stages (counterpart of fal_net_tpu/cli/train.py).

    python -m fal_net_torch.cli.train --stage 1 --data_root /data/KITTI \\
        --a_p 0 --model B
    python -m fal_net_torch.cli.train --stage 1 --slow ...     # stage 1 slow
    python -m fal_net_torch.cli.train --stage 2 --fix_model STAGE1.pt ...

Runs on the GPU unless ``--device cpu`` is given.  The flags of later
slices (validation, resume, bf16, the profiler, multi-GPU) are parsed so
that giving one raises and names the ROADMAP item that brings it; none is
ignored.
"""

from __future__ import annotations

import argparse

from fal_net_torch.data.datasets import REGISTRY as DATASETS
from fal_net_torch.train.config import Stage1Config, Stage2Config
from fal_net_torch.train.trainer import Trainer, not_ported

# flag -> (what it enables, ROADMAP.md queue 1 item)
LATER = {
    "val_root": ("--val_root (validation)", "item 10"),
    "val_batch_size": ("--tbatch_size (validation)", "item 10"),
    "rel_baseline_val": ("--rel_baset (validation)", "item 10"),
    "resume": ("--resume (full-state resume)", "item 10"),
    "profile_steps": ("--profile_steps", "item 10"),
    "num_devices": ("--num_devices (multi-GPU)", "item 12"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fal_net_torch trainer (stages 1, 1 slow, 2)")
    p.add_argument("--stage", type=int, default=1, choices=(1, 2))
    p.add_argument("--slow", action="store_true", help="two-sided stage-1 variant (stage 1 only)")
    p.add_argument("--model", default="B")
    p.add_argument("--no_levels", type=int, default=None)
    p.add_argument("--dataset", default="Kitti", choices=sorted(DATASETS))
    p.add_argument("--data_root", required=True)
    p.add_argument("--lists_dir", default=None)
    p.add_argument("--val_root", default=None, help="KITTI2015 root for validation")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch_size", type=int, default=0)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument(
        "--weight_decay", "--wd", dest="weight_decay", type=float, default=0.0,
        help="L2-into-grad on non-bias params (torch Adam per-group "
        "weight_decay; reference --weight-decay default 0.0)",
    )
    p.add_argument(
        "--bias_decay", type=float, default=0.0,
        help="L2-into-grad on bias params (reference --bias-decay, default 0.0)",
    )
    p.add_argument(
        "--momentum", "--beta1", dest="beta1", type=float, default=None,
        help="Adam beta1 (the reference's --momentum, default 0.5)",
    )
    p.add_argument(
        "--beta", "--beta2", dest="beta2", type=float, default=None,
        help="Adam beta2 (the reference's --beta, default 0.999)",
    )
    p.add_argument(
        "--milestones", type=int, nargs="*", default=None,
        help="epochs at which LR halves (MultiStepLR; default 30 40)",
    )
    p.add_argument("--print_freq", "--print-freq", dest="print_freq", type=int, default=None)
    p.add_argument("--tbatch_size", "--val_batch_size", dest="val_batch_size", type=int, default=None)
    p.add_argument("--rel_baset", "--rel_baseline_val", dest="rel_baseline_val", type=float, default=None)
    p.add_argument("--max_disp", type=float, default=300.0)
    p.add_argument("--min_disp", type=float, default=2.0)
    p.add_argument("--a_p", type=float, default=None)
    p.add_argument("--a_sm", type=float, default=None)
    p.add_argument("--a_mr", type=float, default=None, help="mirror-loss weight (stage 2; default 1)")
    p.add_argument("--crop_height", type=int, default=192)
    p.add_argument("--crop_width", type=int, default=640)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", default="runs")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--pretrained", default=None,
                   help="params-only warm start (port .pt or reference .pth.tar)")
    p.add_argument("--resume", default=None)
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="also checkpoint mid-epoch every N steps")
    p.add_argument("--profile_steps", type=int, default=None)
    p.add_argument("--fix_model", default=None, help="stage-2 frozen teacher ckpt")
    p.add_argument("--vgg_weights", default=None)
    p.add_argument("--allow_random_vgg", action="store_true")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument(
        "--no_med_selfcheck", action="store_true",
        help="skip the setup-time gate that holds the MED kernels against "
        "their plain versions at this run's shape (a disagreement raises)",
    )
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per step (same update, 1/N activations)")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Returns the trainer's ``fit`` result (history, best, save_path)."""
    args = build_parser().parse_args(argv)
    if args.dtype != "float32":
        raise not_ported(f"--dtype {args.dtype}", "item 10")
    for name, (what, item) in LATER.items():
        if getattr(args, name) is not None:
            raise not_ported(what, item)
    if args.stage == 2 and args.slow:
        raise ValueError("--slow is a stage-1 variant; it does not apply to --stage 2")
    if args.stage == 1 and (args.fix_model is not None or args.a_mr is not None):
        raise ValueError("--fix_model and --a_mr are stage-2 flags; they do not apply to --stage 1")
    cls = Stage2Config if args.stage == 2 else Stage1Config
    # slow reaches the constructor: Stage1Config.__post_init__ applies the
    # Kslow batch default (4, Train_Stage1_Kslow.py:48); --batch_size wins
    extra = {"slow": args.slow} if args.stage == 1 else {}
    cfg = cls(
        **extra,
        model=args.model,
        dataset=args.dataset,
        data_root=args.data_root,
        lists_dir=args.lists_dir,
        crop_size=(args.crop_height, args.crop_width),
        max_disp=args.max_disp,
        min_disp=args.min_disp,
        epoch_size=args.epoch_size,
        workers=args.workers,
        seed=args.seed,
        save_path=args.save_path,
        start_epoch=args.start_epoch,
        pretrained=args.pretrained,
        save_every_steps=args.save_every_steps,
        vgg_weights=args.vgg_weights,
        allow_random_vgg=args.allow_random_vgg,
        grad_accum=args.grad_accum,
        med_selfcheck=not args.no_med_selfcheck,
        weight_decay=args.weight_decay,
        bias_decay=args.bias_decay,
    )
    if args.stage == 2:
        cfg.fix_model = args.fix_model
        if args.a_mr is not None:
            cfg.a_mr = args.a_mr
    if args.no_levels is not None:
        cfg.num_levels = args.no_levels
    if args.milestones is not None:
        cfg.milestones = tuple(args.milestones)
    for name in ("batch_size", "epochs", "lr", "a_p", "a_sm", "beta1", "beta2", "print_freq"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    stage = "stage2" if args.stage == 2 else ("stage1_slow" if args.slow else "stage1")
    result = Trainer(cfg, stage=stage, device=args.device).fit()
    print(f"best {result['best_metric']}:", result["best_value"])
    return result


if __name__ == "__main__":
    main()
