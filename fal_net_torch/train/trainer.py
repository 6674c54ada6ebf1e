"""The training loop of the three stages (counterpart of
fal_net_tpu/train/trainer.py, reference Train_Stage1_K.py,
Train_Stage1_Kslow.py and Train_Stage2_K.py).

One step is the stage's loss (train/stages.py), its backward and an Adam
update.  On the GPU the model's MED head runs K1 in its forward and K2 in
its backward, once each per step (per microbatch with ``grad_accum``):
stage 1 on the batch, stage 1 slow and stage 2 on the double batch
[view | flipped other view], stage 2 with K1's sub-occlusion masks.  Stage
2's frozen teacher (``fix_model``) adds one disp-only K1 launch per step,
outside autograd.  Setup runs the MED kernel gate (ops/med_selfcheck.py) in
every mode the run launches, which raises on a disagreement.  Validation,
full-state resume and the perceptual term wait for later slices and raise
here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Any, Dict, Optional

import torch

from fal_net_torch.data.datasets import REGISTRY as DATASETS, TRAIN_FACTORIES
from fal_net_torch.data.loader import DataLoader, prefetch_to_device
from fal_net_torch.data.transforms import default_train_transform
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_model_any, read_state_dict
from fal_net_torch.train.checkpoint import save_checkpoint
from fal_net_torch.train.config import Stage2Config, TrainConfig
from fal_net_torch.train.stages import stage1_loss, stage1_slow_loss, stage2_loss
from fal_net_torch.train.state import create_optimizer
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.meters import AverageMeter


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fal_net_torch yet (ROADMAP.md queue 1, {item})"
    )


STAGES = ("stage1", "stage1_slow", "stage2")
# K1's mode in each stage's student forward (ops/med_selfcheck.py MODES)
STUDENT_MODE = {"stage1": "disp+pan", "stage1_slow": "disp+pan", "stage2": "disp+pan+subocc"}


class Trainer:
    def __init__(self, cfg: TrainConfig, stage: str = "stage1", device="cuda"):
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
        if cfg.compute_dtype != "float32":
            raise not_ported(f"compute_dtype={cfg.compute_dtype!r}", "item 10")
        if cfg.resume:
            raise not_ported("full-state resume", "item 10")
        if cfg.profile_steps:
            raise not_ported("profile_steps", "item 10")
        if cfg.batch_size % cfg.grad_accum:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by grad_accum {cfg.grad_accum}")
        self.cfg = cfg
        self.stage = stage
        self.device = resolve_device(device)
        self.model = create_model(
            cfg.model, cfg.num_levels, device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed),
        )
        self._setup_done = False

    def setup(self) -> None:
        cfg = self.cfg
        if cfg.pretrained:
            self.model.load_state_dict(read_state_dict(cfg.pretrained))
        if cfg.a_p > 0:
            if not (cfg.vgg_weights or cfg.allow_random_vgg):
                # The reference always trains a_p>0 against pretrained
                # ImageNet VGG features (loss_functions.py:10,48).
                raise ValueError(
                    f"a_p={cfg.a_p} > 0 enables the perceptual loss but no "
                    "--vgg_weights were given.  Either supply a torchvision "
                    "vgg19 state_dict (--vgg_weights path.pth), disable the "
                    "term (--a_p 0), or explicitly opt into random-init VGG "
                    "features with --allow_random_vgg."
                )
            raise not_ported("the perceptual term (losses/vgg.py)", "item 9")

        # Stage 2's frozen teacher: any variant and N, never optimized.
        self.teacher = None
        if self.stage == "stage2":
            if not (isinstance(cfg, Stage2Config) and cfg.fix_model):
                raise ValueError("stage 2 needs a Stage2Config with fix_model: the frozen stage-1 teacher "
                                 "checkpoint (--fix_model)")
            self.teacher, variant, levels = load_model_any(cfg.fix_model, device=self.device)
            self.teacher.requires_grad_(False).eval()
            print(f"=> frozen teacher: variant {variant}, N={levels}, from {cfg.fix_model}")

        # The MED kernel gate, at this run's exact shape and bounds (number
        # bounds with fix_order, else per-sample tensors of both signs,
        # repeated for the double batch) in every mode the run launches, at
        # the student's and the teacher's plane counts.
        self.med_selfcheck_err = None
        if cfg.med_selfcheck and self.device.type == "cuda" and self.model.med_impl != "reference":
            from fal_net_torch.ops.med_selfcheck import med_selfcheck

            mn, mx = [cfg.min_disp], [cfg.max_disp]
            if not cfg.fix_order:
                mn, mx = mn + [-cfg.min_disp], mx + [-cfg.max_disp]
                if self.stage != "stage1":
                    mn, mx = mn + mn, mx + mx
            # plane count -> (K1 modes, whether K2 runs)
            checks = {self.model.num_levels: ([STUDENT_MODE[self.stage]], True)}
            if self.teacher is not None and cfg.a_mr > 0:
                checks.setdefault(self.teacher.num_levels, ([], False))[0].append("disp")
            self.med_selfcheck_err = 0.0
            for n, (modes, backward) in sorted(checks.items()):
                err = med_selfcheck(
                    cfg.crop_size[0], cfg.crop_size[1], n, mn, mx, self.device,
                    seed=cfg.seed, modes=modes, backward=backward,
                )
                self.med_selfcheck_err = max(self.med_selfcheck_err, err)
                print(f"=> MED kernels ({', '.join(modes)}{', K2' if backward else ''}) agree with their "
                      f"plain versions at {cfg.crop_size}, N={n}: max abs err {err:.3e}")

        factory = DATASETS[cfg.dataset]
        if factory not in TRAIN_FACTORIES:
            train_names = sorted(k for k, f in DATASETS.items() if f in TRAIN_FACTORIES)
            raise ValueError(f"dataset {cfg.dataset!r} is an evaluation set; training takes one of {train_names}")
        train_ds, _ = factory(cfg.data_root, split=1, co_transform=default_train_transform(cfg.crop_size),
                              max_pix=cfg.max_disp, fix=cfg.fix_order, lists_dir=cfg.lists_dir)
        self.train_loader = DataLoader(
            train_ds, batch_size=cfg.batch_size, shuffle=True,
            num_workers=cfg.workers, seed=cfg.seed,
        )
        steps_per_epoch = len(self.train_loader)
        if cfg.epoch_size:
            steps_per_epoch = min(steps_per_epoch, cfg.epoch_size)
        if steps_per_epoch == 0:
            raise ValueError(
                f"{len(train_ds)} training pairs make no batch of {cfg.batch_size}"
            )
        self.steps_per_epoch = steps_per_epoch
        self.step = cfg.start_epoch * steps_per_epoch
        self.optimizer, self.scheduler = create_optimizer(
            self.model,
            lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
            milestones=cfg.milestones, lr_gamma=cfg.lr_gamma,
            steps_per_epoch=steps_per_epoch,
            start_step=self.step,
            weight_decay=cfg.weight_decay, bias_decay=cfg.bias_decay,
        )
        self._setup_done = True

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Loss, backward and one Adam update on a device batch ('left',
        'right' NCHW, optional per-sample 'max_disp').  With grad_accum,
        the batch splits into that many microbatches whose mean gradient is
        applied: the full batch's update at 1/grad_accum the activations."""
        cfg = self.cfg
        accum = cfg.grad_accum
        self.optimizer.zero_grad(set_to_none=True)
        aux_sum: Dict[str, torch.Tensor] = {}
        for micro in range(accum):
            part = {k: v.chunk(accum)[micro] for k, v in batch.items()}
            loss, aux = self._loss(part)
            (loss / accum).backward()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {k: float(v) / accum for k, v in aux_sum.items()}

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """The stage's loss and aux on one (micro)batch (counterpart of
        fal_net_tpu's ``Trainer._loss_fn``)."""
        cfg = self.cfg
        kw = dict(min_disp=cfg.min_disp, max_disp=cfg.max_disp, a_p=cfg.a_p, a_sm=cfg.a_sm)
        if self.stage == "stage1":
            return stage1_loss(self.model, batch, **kw)
        if self.stage == "stage1_slow":
            return stage1_slow_loss(self.model, batch, **kw)
        return stage2_loss(self.model, batch, self.teacher, a_mr=cfg.a_mr, **kw)

    def _meta(self, epoch: int) -> Dict[str, Any]:
        return {
            "epoch": epoch,
            "step": self.step,
            "model_name": self.model.spec.torch_name,
            "num_levels": self.model.num_levels,
            "stage": self.stage,
        }

    def train_epoch(self, epoch: int, save_path: Optional[str] = None) -> Dict[str, float]:
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        self.model.train()
        losses, rec_losses = AverageMeter(), AverageMeter()
        data_time, batch_time = AverageMeter(), AverageMeter()
        end = time.time()
        with contextlib.closing(prefetch_to_device(iter(self.train_loader), self.device)) as it:
            for i, batch in enumerate(it):
                if i >= self.steps_per_epoch:
                    break
                data_time.update(time.time() - end)
                model_batch = {"left": batch["left"], "right": batch["right"]}
                if not cfg.fix_order:
                    # random L/R swaps flip each sample's disparity sign, so the
                    # per-sample x_pix reaches the model (Train_Stage1_K.py:227)
                    model_batch["max_disp"] = batch["max_disp"]
                aux = self.train_step(model_batch)
                losses.update(aux["loss"], cfg.batch_size)
                rec_losses.update(aux["rec_loss"], cfg.batch_size)
                batch_time.update(time.time() - end)
                end = time.time()
                if i % cfg.print_freq == 0:
                    print(
                        f"Epoch: [{epoch}][{i}/{self.steps_per_epoch}] "
                        f"Time {batch_time} Data {data_time} "
                        f"Loss {losses} RecLoss {rec_losses}"
                    )
                if cfg.save_every_steps and save_path and (i + 1) % cfg.save_every_steps == 0:
                    save_checkpoint(save_path, self.model, self._meta(epoch - 1))  # resume re-runs this epoch
        return {"loss": losses.avg, "rec_loss": rec_losses.avg}

    def fit(self) -> Dict[str, Any]:
        """Train ``cfg.start_epoch..cfg.epochs`` and checkpoint each epoch.
        Without validation the best checkpoint is the lowest epoch train
        loss, and its meta says so (best_metric: train_loss)."""
        if not self._setup_done:
            self.setup()
        cfg = self.cfg
        # <save_path>/<dataset>_<stage>/<MM-DD-HH_MM>/<model>,e{E}es{S},b{B},lr{LR}
        # (Train_Stage1_K.py:92-103); a clash in the same minute gets -2, -3, ...
        stamp = datetime.datetime.now().strftime("%m-%d-%H_%M")
        leaf = (
            f"{cfg.model},e{cfg.epochs}es{cfg.epoch_size if cfg.epoch_size > 0 else ''},"
            f"b{cfg.batch_size},lr{cfg.lr}"
        )
        base = os.path.join(cfg.save_path, f"{cfg.dataset}_{self.stage}")
        save_path = os.path.join(base, stamp, leaf)
        n = 2
        while os.path.exists(save_path):
            save_path = os.path.join(base, f"{stamp}-{n}", leaf)
            n += 1
        os.makedirs(save_path, exist_ok=True)
        settings = "\n".join(
            ["-------TRAINING SETTINGS---------"]
            + [f"{k:>15s}: {v}" for k, v in sorted(dataclasses.asdict(cfg).items())]
        )
        print(settings)
        with open(os.path.join(save_path, "settings.txt"), "w") as f:
            f.write(settings + "\n")

        best_value = -1.0
        history = []
        for epoch in range(cfg.start_epoch, cfg.epochs):
            metrics = self.train_epoch(epoch, save_path)
            is_best = best_value < 0 or metrics["loss"] < best_value
            if is_best:
                best_value = metrics["loss"]
            meta = {**self._meta(epoch), "best_metric": "train_loss", "best_value": best_value}
            save_checkpoint(save_path, self.model, meta, is_best=is_best)
            history.append({"epoch": epoch, **metrics})
        return {
            "best_metric": "train_loss",
            "best_value": best_value,
            "history": history,
            "save_path": save_path,
        }
