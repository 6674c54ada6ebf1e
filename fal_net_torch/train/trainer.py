"""The training loop of the three stages (counterpart of
fal_net_tpu/train/trainer.py, reference Train_Stage1_K.py,
Train_Stage1_Kslow.py and Train_Stage2_K.py).

One step is the stage's loss (train/stages.py), its backward and an Adam
update.  On the GPU the model's MED head runs K1 in its forward and K2 in
its backward, once each per step (per microbatch with ``grad_accum``):
stage 1 on the batch, stage 1 slow and stage 2 on the double batch
[view | flipped other view], stage 2 with K1's sub-occlusion masks.  Stage
2's frozen teacher (``fix_model``) adds one disp-only K1 launch per step,
outside autograd.  With ``a_p > 0`` the frozen VGG19 (losses/vgg.py) adds
the perceptual term.  Setup runs the MED kernel gate (ops/med_selfcheck.py)
in every mode the run launches, which raises on a disagreement.

Validation mirrors Train_Stage1_K.py:279-347 on KITTI 2015: view-synthesis
RMSE (the checkpoint-selection metric), sparse real EPE and the 7 KITTI
depth metrics, through K1 in its disp + pan + subocc mode at the frames'
own shapes, each gated once before its first batch (a disagreement raises;
the JAX package validates through its plain head instead).  ``model_best``
is the epoch of lowest RMSE, or of lowest train loss without validation.
Checkpoints hold the full state (model, Adam, schedule, step), and
``resume`` restores it; the resumed run, as JAX's, writes a new run
directory and picks its ``model_best`` among its own epochs.

``cfg.remat`` runs the student's forward under :class:`Remat`: its
activations are recomputed in the backward instead of kept, so K1 launches
twice a student forward (in the forward and in the recompute), K2 once,
with the same gradients.  The teacher stays outside it, under ``no_grad``.

``cfg.compute_dtype`` ``"bfloat16"`` runs the student's and the teacher's
backbones in bf16 (models/falnet.py); parameters, Adam's state and the
checkpoints stay fp32, the MED head and the VGG19 perceptual net fp32.

Inside a process group (parallel/ddp.py: one process per card, as
``cli.train --num_devices`` starts them) the trainer is one rank of a
data-parallel run: the student is wrapped in DistributedDataParallel (the
teacher and VGG19 are not), each rank takes ``batch_size / world`` samples
of every global batch from the sharded loader (shard *r* of one
permutation), ``no_sync`` skips the all-reduce on every microbatch of
``grad_accum`` but the last, and the logged losses are all-reduced.  Rank 0
alone writes the checkpoints (no ``module.`` prefix), ``metrics.jsonl``,
``settings.txt`` and the images, and validates with the unwrapped student;
its metrics and the ``model_best`` choice reach every rank.  Every rank
reads ``resume`` and ``pretrained``.  A global batch's update equals the
one-process step's up to fp32 reduction order: every stage loss is a mean
over equal slices and DDP averages the gradients.  Outside a process group
nothing of this runs.

``spatial`` S > 1 (``cli.train --spatial``, JAX's ``make_2d_mesh``): the
process group's ranks form a (world / S) x S grid (parallel/spatial.py).  The
S ranks of a row take the same samples from the loader, sharded by the row
(the data group), and split every image's rows: the student and the teacher
run ``with_spatial`` (each rank's rows of the levels the rule splits, whole
rows elsewhere, K1 and K2 on its rows of the MED head), the stage loss takes
its rows of the views and its means over the row's ranks, and DDP's
all-reduce (:func:`~fal_net_torch.parallel.spatial.mean_over_data`) sums the
gradients over the spatial ranks and averages them over the data groups: the
global batch's gradient, as JAX's on the same grid.  The MED gate runs at the
rows K1 launches on.  Validation and checkpoints are rank 0's, on whole rows.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fal_net_torch.data.datasets import REGISTRY as DATASETS, TRAIN_FACTORIES
from fal_net_torch.data.loader import DataLoader, prefetch_to_device
from fal_net_torch.data.transforms import RGB_MEAN, default_train_transform, normalize
from fal_net_torch.eval.metrics import (
    KITTI_ERROR_NAMES,
    compute_kitti_errors,
    disps_to_depths_kitti2015,
    image_rmse_np,
)
from fal_net_torch.losses.epe import real_epe, real_epe_np
from fal_net_torch.losses.vgg import build_vgg
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_model_any, read_state_dict
from fal_net_torch.models.falnet import compute_dtype
from fal_net_torch.parallel import ddp, spatial as row_split
from fal_net_torch.train.checkpoint import CKPT_NAME, load_checkpoint, save_checkpoint
from fal_net_torch.train.config import Stage2Config, TrainConfig
from fal_net_torch.train.stages import stage1_loss, stage1_slow_loss, stage2_loss
from fal_net_torch.train.state import create_optimizer
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.logging import MetricsLogger, dump_settings
from fal_net_torch.utils.meters import AverageMeter, MultiAverageMeter
from fal_net_torch.utils.trace import span
from fal_net_torch.utils.viz import disp2rgb


STAGES = ("stage1", "stage1_slow", "stage2")
# K1's mode in each stage's student forward (ops/med_selfcheck.py MODES)
STUDENT_MODE = {"stage1": "disp+pan", "stage1_slow": "disp+pan", "stage2": "disp+pan+subocc"}
VAL_MODE = "disp+pan+subocc"  # K1's mode in validation


class Remat(nn.Module):
    """``model`` with its forward rematerialized: run under non-reentrant
    ``torch.utils.checkpoint``, which keeps only the inputs and recomputes
    the forward, MED head included, when the backward needs its activations
    (JAX's ``jax.checkpoint`` of ``model.apply``,
    fal_net_tpu/train/trainer.py:264-269).  The gradients are the plain
    forward's; the cost is one more forward a backward.  Non-reentrant:
    ``MedOutputs`` carries None fields and the forward takes keyword flags,
    which the reentrant kind refuses."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return checkpoint(self.model, *args, use_reentrant=False, **kwargs)


class Trainer:
    """``train_dataset`` / ``val_dataset`` replace the configured training
    set and supply the validation set (``cli.train --val_root`` passes
    KITTI 2015's); without a validation set, nothing is validated."""

    def __init__(self, cfg: TrainConfig, stage: str = "stage1", device="cuda", train_dataset=None,
                 val_dataset=None, spatial: int = 1):
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.world, self.rank = ddp.world_size(), ddp.rank()
        if self.world % spatial:
            raise ValueError(f"--spatial {spatial} must divide the device count {self.world}")
        self.grid = row_split.make_2d_grid(self.world // spatial, spatial) if spatial > 1 else None
        self.rows = self.grid.rows if self.grid else None
        self.data_groups, self.data_rank = (self.grid.data, self.grid.d) if self.grid else (self.world, self.rank)
        if cfg.batch_size % self.data_groups:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by the {self.data_groups} data groups")
        self.rank_batch = cfg.batch_size // self.data_groups  # this rank's samples of every global batch
        if self.rank_batch % cfg.grad_accum:
            raise ValueError(f"the per-rank batch {self.rank_batch} is not divisible by grad_accum {cfg.grad_accum}")
        self.cfg = cfg
        self.stage = stage
        self.device = resolve_device(device)
        self.model = create_model(
            cfg.model, cfg.num_levels, device=self.device, dtype=self.dtype,
            generator=torch.Generator().manual_seed(cfg.seed),
        )
        self.train_model = self.model  # what the stages call: under Remat and DDP where asked (setup)
        self._external_train = train_dataset
        self.val_dataset = val_dataset
        self.logger: Optional[MetricsLogger] = None
        self.val_checked: Dict[Tuple[str, int, int], float] = {}  # K1 gate at validation: (mode, H, W) -> err
        self._setup_done = False

    def setup(self) -> None:
        cfg = self.cfg
        if cfg.pretrained:
            self.model.load_state_dict(read_state_dict(cfg.pretrained))
        # the frozen perceptual net, once, on the trainer's device
        self.vgg = build_vgg(cfg.vgg_weights, cfg.allow_random_vgg, cfg.a_p, cfg.seed, self.device)

        # Stage 2's frozen teacher: any variant and N (its deconvs as its checkpoint records), never optimized.
        self.teacher = None
        if self.stage == "stage2":
            if not (isinstance(cfg, Stage2Config) and cfg.fix_model):
                raise ValueError("stage 2 needs a Stage2Config with fix_model: the frozen stage-1 teacher "
                                 "checkpoint (--fix_model)")
            self.teacher, variant, levels = load_model_any(cfg.fix_model, device=self.device, dtype=self.dtype)
            self.teacher.requires_grad_(False).eval()
            print(f"=> frozen teacher: variant {variant}, N={levels}, from {cfg.fix_model}")
        if self.rows is not None and self.rank == 0:
            print(f"=> rows over {self.rows.size} ranks, {self.grid.data} data groups at {cfg.crop_size}: "
                  f"{self.rows.describe(cfg.crop_size[0])}")

        # The MED kernel gate, at the rows K1 launches on and this run's bounds (number
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
            h = cfg.crop_size[0]
            if self.rows is not None and self.rows.sharded(h):
                h //= self.rows.size
            for n, (modes, backward) in sorted(checks.items()):
                err = med_selfcheck(
                    h, cfg.crop_size[1], n, mn, mx, self.device,
                    seed=cfg.seed, modes=modes, backward=backward,
                )
                self.med_selfcheck_err = max(self.med_selfcheck_err, err)
                print(f"=> MED kernels ({', '.join(modes)}{', K2' if backward else ''}) agree with their "
                      f"plain versions at {(h, cfg.crop_size[1])}, N={n}: max abs err {err:.3e}")

        train_ds = self._external_train
        if train_ds is None:
            factory = DATASETS[cfg.dataset]
            if factory not in TRAIN_FACTORIES:
                train_names = sorted(k for k, f in DATASETS.items() if f in TRAIN_FACTORIES)
                raise ValueError(
                    f"dataset {cfg.dataset!r} is an evaluation set; training takes one of {train_names}")
            train_ds, _ = factory(cfg.data_root, split=1, co_transform=default_train_transform(cfg.crop_size),
                                  max_pix=cfg.max_disp, fix=cfg.fix_order, lists_dir=cfg.lists_dir)
        self.train_loader = DataLoader(
            train_ds, batch_size=self.rank_batch, shuffle=True,
            num_workers=cfg.workers, seed=cfg.seed, shard_id=self.data_rank, num_shards=self.data_groups,
        )
        steps_per_epoch = len(self.train_loader)
        if cfg.epoch_size:
            steps_per_epoch = min(steps_per_epoch, cfg.epoch_size)
        if steps_per_epoch == 0:
            raise ValueError(
                f"{len(train_ds)} training pairs make no batch of {cfg.batch_size}"
            )
        self.steps_per_epoch = steps_per_epoch
        # a warm restart (--pretrained with --start_epoch) starts the
        # schedule there; a full-state resume restores its own position
        self.step = 0 if cfg.resume else cfg.start_epoch * steps_per_epoch
        self.optimizer, self.scheduler = create_optimizer(
            self.model,
            lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
            milestones=cfg.milestones, lr_gamma=cfg.lr_gamma,
            steps_per_epoch=steps_per_epoch,
            start_step=self.step,
            weight_decay=cfg.weight_decay, bias_decay=cfg.bias_decay,
        )
        if cfg.resume:
            # full state: model, Adam moments, schedule, step (the reference
            # restarts Adam's moments on a restart)
            meta = load_checkpoint(cfg.resume, self)
            if meta.get("epoch") is not None:
                cfg.start_epoch = int(meta["epoch"]) + 1
            print(f"=> resumed {cfg.resume}: step {self.step}, next epoch {cfg.start_epoch}")
        student = self.model.with_spatial(self.rows)
        if self.teacher is not None:
            self.teacher = self.teacher.with_spatial(self.rows)
        student = Remat(student) if cfg.remat else student
        self.train_model = self._wrap_ddp(student) if ddp.active() else student
        self._setup_done = True

    def _wrap_ddp(self, student: nn.Module) -> nn.Module:
        """``student`` under DistributedDataParallel (a :class:`Remat`
        student recomputes inside it, so its recompute runs under DDP's
        reducer hooks).  The parameters that forward never uses (FAL_netA/B's
        declared amask head) are left out of the all-reduce: their gradients
        stay None on every rank, so Adam's state and the checkpoint equal a
        one-process run's."""
        from torch.nn.parallel import DistributedDataParallel

        prefix = f"{self.model.spec.torch_backbone_key}.amask_conv."
        amask = {id(p) for n, p in self.model.named_parameters() if n.startswith(prefix)}
        unused = [n for n, p in student.named_parameters() if id(p) in amask]
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(student, unused)
        ids = [self.device.index] if self.device.type == "cuda" else None
        wrapped = DistributedDataParallel(student, device_ids=ids, output_device=self.device.index if ids else None)
        if self.grid is not None:
            wrapped.register_comm_hook(self.grid.data, row_split.mean_over_data)
        return wrapped

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Loss, backward and one Adam update on a device batch ('left',
        'right' NCHW, optional per-sample 'max_disp'): this rank's share of
        the global batch inside a process group.  With grad_accum, the batch
        splits into that many microbatches whose mean gradient is applied:
        the full batch's update at 1/grad_accum the activations; under DDP
        only the last microbatch's backward all-reduces.  Returns the aux
        losses, averaged over the ranks."""
        cfg = self.cfg
        accum = cfg.grad_accum
        self.optimizer.zero_grad(set_to_none=True)
        aux_sum: Dict[str, torch.Tensor] = {}
        for micro in range(accum):
            part = {k: v.chunk(accum)[micro] for k, v in batch.items()}
            sync = micro == accum - 1 or not ddp.active()
            with contextlib.nullcontext() if sync else self.train_model.no_sync():
                with span("train.loss"):
                    loss, aux = self._loss(part)
                with span("train.backward"):
                    (loss / accum).backward()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        with span("train.optimizer"):
            self.optimizer.step()
            self.scheduler.step()
        self.step += 1
        with span("train.aux"):
            return ddp.all_reduce_mean({k: float(v) / accum for k, v in aux_sum.items()}, self.device)

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """The stage's loss and aux on one (micro)batch (counterpart of
        fal_net_tpu's ``Trainer._loss_fn``)."""
        cfg = self.cfg
        kw = dict(min_disp=cfg.min_disp, max_disp=cfg.max_disp, a_p=cfg.a_p, a_sm=cfg.a_sm, vgg_fn=self.vgg,
                  rows=self.rows)
        if self.stage == "stage1":
            return stage1_loss(self.train_model, batch, **kw)
        if self.stage == "stage1_slow":
            return stage1_slow_loss(self.train_model, batch, **kw)
        return stage2_loss(self.train_model, batch, self.teacher, a_mr=cfg.a_mr, **kw)

    def _meta(self, epoch: int) -> Dict[str, Any]:
        return {
            "epoch": epoch,
            "step": self.step,
            "model_name": self.model.spec.torch_name,
            "num_levels": self.model.num_levels,
            "stage": self.stage,
        }

    def _save(self, save_path: str, meta: Dict[str, Any], is_best: bool = False) -> Optional[str]:
        """Rank 0 writes the checkpoint (the unwrapped model's keys)."""
        if self.rank != 0:
            return None
        return save_checkpoint(save_path, self.model, meta, is_best=is_best, optimizer=self.optimizer,
                               scheduler=self.scheduler)

    def train_epoch(self, epoch: int, save_path: Optional[str] = None) -> Dict[str, float]:
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        self.model.train()
        losses, rec_losses = AverageMeter(), AverageMeter()
        data_time, batch_time = AverageMeter(), AverageMeter()
        self.data_time = data_time
        # torch.profiler over steps [1, 1 + profile_steps) of the first
        # epoch (step 0 builds and gates the kernels), a Chrome trace under
        # <save_path>/profile; a profiler that cannot start only warns, as in
        # the JAX package (no device path is switched by it)
        window = None
        if cfg.profile_steps > 0 and epoch == cfg.start_epoch and save_path and self.rank == 0:
            window = (1, 1 + cfg.profile_steps)
        prof = None

        def profile(i: int, done: bool = False) -> None:
            nonlocal prof
            if window is None:
                return
            try:
                if prof is None and not done and i == window[0]:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.start()
                elif prof is not None and (done or i == window[1]):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.stop()
                    out = os.path.join(save_path, "profile")
                    os.makedirs(out, exist_ok=True)
                    path = os.path.join(out, f"trace_epoch{epoch}_steps{window[0]}-{window[1]}.json")
                    prof.export_chrome_trace(path)
                    prof = None
                    print(f"=> profiler trace in {path}")
            except Exception as e:  # profiling never stops training
                prof = None
                print(f"=> profiler unavailable: {e}")

        end = time.time()
        with contextlib.closing(prefetch_to_device(iter(self.train_loader), self.device)) as it:
            for i, batch in enumerate(it):
                if i >= self.steps_per_epoch:
                    break
                profile(i)
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
                if i % cfg.print_freq == 0 and self.rank == 0:
                    print(
                        f"Epoch: [{epoch}][{i}/{self.steps_per_epoch}] "
                        f"Time {batch_time} Data {data_time} "
                        f"Loss {losses} RecLoss {rec_losses}"
                    )
                    if self.logger is not None:
                        self.logger.scalars(self.step, {"loss": losses.val, "rec_loss": rec_losses.val},
                                            prefix="train/")
                if cfg.save_every_steps and save_path and (i + 1) % cfg.save_every_steps == 0:
                    self._save(save_path, self._meta(epoch - 1))  # resume re-runs this epoch
        profile(self.steps_per_epoch, done=True)  # close a window the epoch ended inside
        return {"loss": losses.avg, "rec_loss": rec_losses.avg}

    # ------------------------------------------------------------------
    def _val_guard(self, height: int, width: int, bounds) -> None:
        """Gate K1 in validation's mode at a validation frame shape before
        its first batch (the setup gate saw only the training crop); a
        disagreement raises."""
        if not self.cfg.med_selfcheck or self.device.type != "cuda" or self.model.med_impl == "reference":
            return
        from fal_net_torch.ops.med_selfcheck import gate_k1

        gate_k1(self.val_checked, VAL_MODE, height, width, self.model.num_levels, bounds, self.device,
                seed=self.cfg.seed, where="the validation shape ")

    def validate(self, dataset, epoch: int = 0, log_images: int = 3) -> Dict[str, float]:
        """KITTI 2015 validation (Train_Stage1_K.py:279-347, counterpart of
        fal_net_tpu's ``Trainer.validate``): view-synthesis RMSE, sparse real
        EPE and the KITTI depth metrics, per image in numpy; the first
        ``log_images`` frames' disparity, masks and pan go to the logger.

        Batches of ``val_batch_size`` in per-shape buckets, a bucket's
        ragged tail zero-padded; the forward at the bounds times
        ``rel_baseline_val`` with disp, pan and the sub-occlusion masks."""
        cfg = self.cfg
        bs = max(1, int(cfg.val_batch_size))
        rb = cfg.rel_baseline_val
        bounds = (cfg.min_disp * rb, cfg.max_disp * rb)
        rmses, epes = AverageMeter(), AverageMeter()
        kitti_errors = MultiAverageMeter(KITTI_ERROR_NAMES)
        mean = np.asarray(RGB_MEAN, np.float32)
        training = self.model.training
        self.model.eval()

        def process(items):
            lefts = np.stack([np.asarray(s["left"]) for _, s in items])
            if lefts.dtype == np.uint8:
                lefts = normalize(lefts)
            lefts = lefts.astype(np.float32, copy=False)
            if len(items) < bs:
                lefts = np.concatenate([lefts, np.zeros((bs - len(items),) + lefts.shape[1:], lefts.dtype)])
            self._val_guard(lefts.shape[1], lefts.shape[2], bounds)
            with torch.inference_mode():
                x = torch.from_numpy(lefts).to(self.device).permute(0, 3, 1, 2).contiguous()
                out = self.model(x, *bounds, ret_disp=True, ret_pan=True, ret_subocc=True)
                pan, disp, mask_l, mask_r = (t.permute(0, 2, 3, 1).cpu().numpy()
                                             for t in (out.pan, out.disp, out.maskL, out.maskR))
            for slot, (i, s) in enumerate(items):
                rmses.update(image_rmse_np(pan[slot], np.asarray(s["right"], np.float32)))
                if self.logger is not None and i < log_images:
                    # the images of Train_Stage1_K.py:322-338
                    if epoch == 0:
                        self.logger.image(0, f"val{i}/input_left", np.clip(lefts[slot] + mean, 0, 1))
                    self.logger.image(epoch, f"val{i}/disparity", disp2rgb(disp[slot]))
                    self.logger.image(epoch, f"val{i}/maskL", disp2rgb(mask_l[slot], 1.0))
                    self.logger.image(epoch, f"val{i}/maskR", disp2rgb(mask_r[slot], 1.0))
                    self.logger.image(epoch, f"val{i}/pan", np.clip(pan[slot] + mean, 0, 1))
                if "targets" in s:
                    target = np.asarray(s["targets"][0])
                    if disp[slot].shape == target.shape:
                        epes.update(real_epe_np(disp[slot][..., 0], target[..., 0]))
                    else:  # the bilinear upsample to the target's size
                        pred = torch.from_numpy(disp[slot][..., 0])[None, None]
                        epes.update(float(real_epe(pred, torch.from_numpy(target[..., 0])[None, None], sparse=True)))
                    gt_d, pred_d = disps_to_depths_kitti2015(target[None, ..., 0], disp[slot][None, ..., 0])
                    kitti_errors.update(compute_kitti_errors(gt_d[0], pred_d[0]))

        buckets: Dict[tuple, list] = {}
        for i in range(len(dataset)):
            s = dataset.get(i)
            shape = np.asarray(s["left"]).shape
            buckets.setdefault(shape, []).append((i, s))
            if len(buckets[shape]) == bs:
                items, buckets[shape] = buckets[shape], []
                process(items)
        for items in buckets.values():
            if items:
                process(items)
        self.model.train(training)
        metrics = {"rmse": rmses.avg, "epe": epes.avg}
        metrics.update(zip(KITTI_ERROR_NAMES, (float(v) for v in kitti_errors.avg)))
        return metrics

    def _run_dir(self) -> str:
        """<save_path>/<dataset>_<stage>/<MM-DD-HH_MM>/<model>,e{E}es{S},b{B},lr{LR}
        (Train_Stage1_K.py:92-103), -2, -3, ... on a clash in the same minute;
        a resumed run too gets a new one, as in JAX."""
        cfg = self.cfg
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
        return save_path

    def fit(self, save_path: Optional[str] = None) -> Dict[str, Any]:
        """Train ``cfg.start_epoch..cfg.epochs`` in ``save_path`` (a new
        stamped run directory when None, :meth:`_run_dir`), validate every
        ``val_freq`` epochs and checkpoint each epoch.  ``model_best`` is the
        epoch of lowest validation RMSE; without a validation set, of lowest
        train loss, and its meta says which (best_metric; best_rmse only when
        it is the RMSE).  Epochs whose validation is skipped do not compete.
        Every run, a resumed one too, starts its best at -1, as JAX's
        (fal_net_tpu/train/trainer.py:336-372): a resumed run writes its own
        directory and picks its best among its own epochs."""
        if not self._setup_done:
            self.setup()
        cfg = self.cfg
        if save_path is None:
            save_path = ddp.broadcast_object(self._run_dir() if self.rank == 0 else None)
        if self.rank == 0:
            dump_settings(save_path, cfg)
            self.logger = MetricsLogger(save_path)
        best_metric = "rmse" if self.val_dataset is not None else "train_loss"
        best_value = -1.0
        history = []
        try:
            for epoch in range(cfg.start_epoch, cfg.epochs):
                train_metrics = self.train_epoch(epoch, save_path)
                val_metrics: Dict[str, float] = {}
                if self.val_dataset is not None and epoch % cfg.val_freq == 0:
                    if self.rank == 0:  # the unwrapped student: a one-process run's metrics
                        val_metrics = self.validate(self.val_dataset, epoch)
                        self.logger.scalars(epoch, val_metrics, prefix="val/")
                    val_metrics = ddp.broadcast_object(val_metrics)
                candidate = val_metrics.get("rmse") if best_metric == "rmse" else train_metrics["loss"]
                is_best = candidate is not None and (best_value < 0 or candidate < best_value)
                if is_best:
                    best_value = candidate
                meta = {**self._meta(epoch), "best_metric": best_metric, "best_value": best_value}
                if best_metric == "rmse":
                    meta["best_rmse"] = best_value  # the reference's key, only when it is the RMSE
                self._save(save_path, meta, is_best=is_best)
                history.append({"epoch": epoch, **train_metrics, **val_metrics})
        finally:
            if self.logger is not None:
                self.logger.close()
        return {
            "best_metric": best_metric,
            "best_value": best_value,
            "history": history,
            "save_path": save_path,
            "checkpoint": os.path.join(save_path, CKPT_NAME),
        }
