"""Training CLI, the three stages (counterpart of fal_net_tpu/cli/train.py).

    python -m fal_net_torch.cli.train --stage 1 --data_root /data/KITTI \\
        --vgg_weights vgg19.pth --val_root /data/KITTI2015 --model B
    python -m fal_net_torch.cli.train --stage 1 --slow ...     # stage 1 slow
    python -m fal_net_torch.cli.train --stage 2 --fix_model STAGE1.pt ...
    python -m fal_net_torch.cli.train --resume RUN_DIR/checkpoint.pt ...
    python -m fal_net_torch.cli.train --dtype bfloat16 --num_devices 4 ...  # bf16, 4 cards

Runs on the GPU unless ``--device cpu`` is given.  ``--val_root`` validates
on KITTI 2015 every epoch and picks ``model_best`` by the view-synthesis
RMSE; ``--resume`` restores the full training state and continues its run's
directory.  ``--pretrained`` and ``--fix_model`` take a port ``.pt``, a
reference ``.pth.tar`` or a JAX msgpack checkpoint (or its run directory).
``--dtype bfloat16`` runs the backbones in bf16 (parameters, Adam and the
checkpoints stay fp32).  ``--num_devices N`` trains one process per card
(rank *r* on ``cuda:r``, NCCL) under DistributedDataParallel, or N gloo
processes with ``--device cpu``; ``--batch_size`` stays the global batch.
Without it, the run takes the largest number of visible cards that divides
the batch, as JAX does; one runs in this process, with no process group.
``--spatial`` above 1 raises: row sharding (fal_net_tpu/parallel/spatial.py)
is not ported.
"""

from __future__ import annotations

import argparse
import os
import time

from fal_net_torch.data.datasets import REGISTRY as DATASETS, kitti2015
from fal_net_torch.parallel import ddp
from fal_net_torch.parallel.mesh import make_mesh, make_mesh_for_batch
from fal_net_torch.train.config import Stage1Config, Stage2Config
from fal_net_torch.train.trainer import Trainer


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
    p.add_argument("--tbatch_size", "--val_batch_size", dest="val_batch_size", type=int, default=None,
                   help="validation batch size (metrics per image, the same as at 1)")
    p.add_argument("--rel_baset", "--rel_baseline_val", dest="rel_baseline_val", type=float, default=None,
                   help="validation-set baseline scale (Train_Stage1_K.py:36)")
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
    p.add_argument("--resume", default=None,
                   help="full-state resume: params, Adam moments, schedule and step (a checkpoint.pt or "
                   "its run directory); the run continues in that directory")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="also checkpoint mid-epoch every N steps")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="torch.profiler trace of this many first-epoch steps (from step 1) under "
                   "<run dir>/profile")
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
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks, one process per card (default: the most visible cards that divide "
                   "the batch)")
    p.add_argument("--spatial", type=int, default=1, help="row sharding; only 1 (not ported)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _val_dataset(val_root):
    # the _10 pair and its disparity ground truth (load_t1=False: no t+1 decode)
    return kitti2015(val_root, split=0, disp=True, load_t1=False)[1] if val_root else None


def _rank_main(rank: int, world: int, cfg, stage: str, device: str, val_root) -> dict:
    """One rank of ``--num_devices``: its trainer on its device."""
    trainer = Trainer(cfg, stage=stage, device=ddp.rank_device(device, rank), val_dataset=_val_dataset(val_root))
    return trainer.fit()


def main(argv=None) -> dict:
    """Returns the trainer's ``fit`` result (history, best, save_path)."""
    args = build_parser().parse_args(argv)
    if args.spatial != 1:
        raise NotImplementedError(f"--spatial {args.spatial}: row sharding (fal_net_tpu/parallel/spatial.py) is not "
                                  "ported; ROADMAP.md lists it under \"Leave behind\"")
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
        resume=args.resume,
        save_every_steps=args.save_every_steps,
        profile_steps=args.profile_steps,
        vgg_weights=args.vgg_weights,
        allow_random_vgg=args.allow_random_vgg,
        grad_accum=args.grad_accum,
        med_selfcheck=not args.no_med_selfcheck,
        weight_decay=args.weight_decay,
        bias_decay=args.bias_decay,
        compute_dtype=args.dtype,
    )
    if args.stage == 2:
        cfg.fix_model = args.fix_model
        if args.a_mr is not None:
            cfg.a_mr = args.a_mr
    if args.no_levels is not None:
        cfg.num_levels = args.no_levels
    if args.milestones is not None:
        cfg.milestones = tuple(args.milestones)
    for name in ("batch_size", "epochs", "lr", "a_p", "a_sm", "beta1", "beta2", "print_freq", "val_batch_size",
                 "rel_baseline_val"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    stage = "stage2" if args.stage == 2 else ("stage1_slow" if args.slow else "stage1")
    if args.num_devices is not None:
        world = make_mesh(args.num_devices, device=args.device).size
    else:
        world = make_mesh_for_batch(cfg.batch_size, device=args.device).size
    if world == 1:
        result = Trainer(cfg, stage=stage, device=args.device, val_dataset=_val_dataset(args.val_root)).fit()
    else:
        if cfg.batch_size % world:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by --num_devices {world}")
        os.makedirs(cfg.save_path, exist_ok=True)
        store = os.path.join(os.path.abspath(cfg.save_path), f".rendezvous-{os.getpid()}-{time.time_ns()}")
        print(f"=> {world} ranks ({ddp.default_backend(args.device)}), {cfg.batch_size // world} samples each")
        result = ddp.launch(_rank_main, world, (cfg, stage, args.device, args.val_root), store_path=store,
                            device=args.device)[0]
    print(f"best {result['best_metric']}:", result["best_value"])
    return result


if __name__ == "__main__":
    main()
