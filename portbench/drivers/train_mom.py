"""Stage-2 training (MOM distillation): ``fal_net_torch.train.Trainer`` at
``stage2`` with a frozen teacher loaded through ``fix_model``, its
``train_step`` on device batches, as ``cli.train --stage 2 --fix_model``
runs it and ``Trainer.fit`` calls it.

Traffic parameters: those of the stage-1 driver (drivers/train.py), with
``stage`` "stage2", ``batch`` the pairs of a step (each step runs the
double batch [left | hflip(right)] through the student and [hflip(left) |
right] through the teacher) and ``a_mr`` (the mirror loss's weight).  The
configuration's ``teacher`` gives the teacher's variant and plane count.

Set-up draws the student's, the teacher's (an independent stream) and
VGG19's weights from the seed, writes the teacher as a port ``.pt``
(``models/checkpoint.py::save_checkpoint``) in a temporary directory, and
builds the Trainer, which loads it (``fix_model``) and gates its kernels.
The loop and the window are drivers/train.py's.

Each step launches K1 twice, the teacher's disp and the student's
disp+pan+subocc, and K2 once, on the double batch.  The run is refused
unless the window's launches by mode are exactly that: the mechanism ran
on the kernels, and ``flops_per_call``, one step's convolution FLOPs (the
student's training step on 2 x batch images with VGG19, as
``_work.conv_flops`` counts it, plus the teacher's forward on as many)
over its two K1 launches, is exact for metrics/mfu.py, which counts K1
launches.

``correct``: the plain reference (reference/mom.py, reference/falnet.py,
fp32, TF32 off, Adam written out) takes the same student, teacher and VGG19
weights through the same first three batches.  Compared, as drivers/train.py
defines them: ``loss_gap``, ``grad_gap``, ``update_gap`` and
``grad_diff_ratio``; and ``mirror_gap``, the worst of the three steps'
relative gap of the ``mirror_loss`` aux: the mirror is a small term of the
loss, which a fault in it hardly moves.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import torch

from portbench.drivers.serve import ratio, shapes
from portbench.drivers.train import CHECKED_STEPS, _Epoch, leaf_gap, vgg_shapes
from portbench.harness import guard, inputs, peaks, trace
from portbench.harness.meter import Meter
from portbench.harness.record import Context, Run, SetupParts, checks
from portbench.metrics import _work
from portbench.reference import falnet as ref_falnet, mom as ref_mom, train as ref_train

TEACHER_STREAM = 6  # inputs.weights' stream of the teacher's weights
STEP_MODES = {"disp": 1, "disp+pan+subocc": 1}  # K1 launches by mode per K2 launch


def write_teacher(cfg: dict, weights: dict, path: str) -> str:
    """The teacher's weights as a port checkpoint at ``path``."""
    from fal_net_torch.models import create_model
    from fal_net_torch.models.checkpoint import save_checkpoint

    model = create_model(cfg["teacher"]["variant"], cfg["teacher"]["num_levels"], device="cpu")
    model.load_state_dict(weights)
    save_checkpoint(path, model)
    return path


def build(ctx: Context, weights: dict, vgg_weights: dict, fix_model: str):
    from fal_net_torch.train import Stage2Config, Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    tcfg = Stage2Config(model=cfg["variant"], num_levels=cfg["num_levels"], min_disp=cfg["min_disp"],
                        max_disp=cfg["max_disp"], batch_size=tr["batch"], crop_size=(tr["height"], tr["width"]),
                        a_p=tr["a_p"], a_sm=tr["a_sm"], a_mr=tr["a_mr"], lr=tr["lr"], beta1=tr["beta1"],
                        beta2=tr["beta2"], allow_random_vgg=True, compute_dtype=tr["dtype"], workers=1,
                        seed=ctx.seed % 2 ** 31, fix_model=fix_model)
    trainer = Trainer(tcfg, tr["stage"], device=ctx.device, train_dataset=_Epoch(tr["epoch_pairs"]))
    trainer.setup()
    trainer.model.load_state_dict(weights)
    if trainer.vgg is not None:
        trainer.vgg.load_state_dict(vgg_weights)
    return trainer


def check_launches(before: dict, after: dict) -> None:
    """Raise unless K1 launched exactly ``STEP_MODES`` per K2 launch between
    the two readings of the port's counters."""
    k2 = after["med_bwd"] - before["med_bwd"]
    modes = {k.split(":", 1)[1]: after[k] - before[k] for k in after if k.startswith("med_fwd:")}
    want = {m: STEP_MODES.get(m, 0) * k2 for m in modes}
    if modes != want:
        got = {m: n for m, n in modes.items() if n}
        raise RuntimeError(f"K1 launches by mode in the window {got} for {k2} K2 launches; a stage-2 step "
                           f"launches {STEP_MODES} per K2 launch")


def run(ctx: Context) -> Run:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, b, teacher = ctx.device, tr["batch"], ctx.cell.config["teacher"]
    parts = SetupParts(ctx)
    weights = inputs.weights(shapes(cfg["variant"], cfg["num_levels"]), ctx.seed, dev)
    teacher_weights = inputs.weights(shapes(teacher["variant"], teacher["num_levels"]), ctx.seed, dev,
                                     stream=TEACHER_STREAM)
    vgg_weights = inputs.weights(vgg_shapes(), ctx.seed, dev, stream=5)
    parts.mark("imports_and_weights")
    with tempfile.TemporaryDirectory() as tmp:
        fix_model = write_teacher(cfg, teacher_weights, os.path.join(tmp, "teacher.pt"))
        trainer = build(ctx, weights, vgg_weights, fix_model)
    parts.mark("program")
    left, right = inputs.stereo_pairs(tr["pool"] * b, tr["height"], tr["width"], ctx.seed, dev)
    pool = [{"left": left[i * b:(i + 1) * b], "right": right[i * b:(i + 1) * b]} for i in range(tr["pool"])]
    parts.mark("inputs")
    h, w = tr["height"], tr["width"]
    step_flops = (_work.conv_flops(cfg["variant"], cfg["num_levels"], 2 * b, h, w, train=True, a_p=tr["a_p"],
                                   device=dev)
                  + _work.conv_flops(teacher["variant"], teacher["num_levels"], 2 * b, h, w, device=dev))
    parts.mark("flop_count")

    names = {id(p): n for n, p in trainer.model.named_parameters()}
    beta1 = tr["beta1"]
    losses, mirrors, grad1, change = [], [], {}, {}
    meter = Meter(ctx, ctx.cell.chips)
    k, steps, failed, setup_s, counts = 0, 0, 0, None, None
    start = tr["warm_steps"] + (tr["trace_warm_steps"] if ctx.trace else 0)
    while meter.t0 is None or meter.elapsed() < meter.open_s:
        with trace.span("train_step"):
            aux = trainer.train_step(pool[k % len(pool)])
        k += 1
        if k <= CHECKED_STEPS:
            losses.append(aux["loss"])
            mirrors.append(aux["mirror_loss"])
            if k == 1:
                state = trainer.optimizer.state
                grad1 = {names[id(p)]: state[p]["exp_avg"] / (1 - beta1) for p in state}
            if k == CHECKED_STEPS:
                change = {n: p.detach() - weights[n] for n, p in trainer.model.named_parameters()}
        if meter.t0 is None:
            if k == tr["warm_steps"]:
                setup_s = time.perf_counter() - ctx.t_start
                parts.mark("warm_calls")
                meter.start_profiler()
            if k == start:
                counts = guard.launch_counts()
                meter.open()
            continue
        steps += 1
        failed += not math.isfinite(aux["loss"])
    meter.close(sync=True)
    after = guard.launch_counts()
    meter.stop_profiler()
    check_launches(counts, after)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(ctx, (weights, teacher_weights, vgg_weights), pool[:CHECKED_STEPS], losses, mirrors, grad1,
                      change)
    shape = dict(b=2 * b, n=cfg["num_levels"], h=h, w=w)
    return Run(setup_s=setup_s, window_s=meter.seconds, launches=meter.launches, attempted=steps, failed=failed,
               checks=checks(ctx, numbers), numbers=numbers, device=meter.device,
               calls={"med_subocc": shape, "med_bwd": shape},
               flops_per_call=step_flops / sum(STEP_MODES.values()), conv_peak=peaks.CONV_PEAK[tr["dtype"]],
               pairs=steps * b, trace=meter.reduced, setup_parts=parts.seconds)


def reference_steps(ctx: Context, all_weights: tuple, batches: list, tf32: bool = False):
    """(losses, mirror losses, first gradient, change after the last step)
    of the plain stage-2 step from the same weights on ``batches``, fp32
    with TF32 off (or on, the configuration's own precision, for ``tf32``)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    weights, teacher_weights, vgg_weights = all_weights
    model = ref_falnet.FalNet(cfg["variant"], cfg["num_levels"]).to(ctx.device)
    model.load_state_dict(weights)
    teacher = ref_falnet.FalNet(cfg["teacher"]["variant"], cfg["teacher"]["num_levels"]).to(ctx.device)
    teacher.load_state_dict(teacher_weights)
    teacher.requires_grad_(False)
    vgg = ref_train.Vgg19Pool3().to(ctx.device)
    vgg.load_state_dict(vgg_weights)
    opt = ref_train.Adam(model.parameters(), lr=tr["lr"], betas=(tr["beta1"], tr["beta2"]))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    losses, mirrors, grad1 = [], [], {}
    try:
        for i, batch in enumerate(batches):
            loss, aux = ref_mom.stage2_loss(model, teacher, vgg, batch["left"], batch["right"], cfg["min_disp"],
                                            cfg["max_disp"], tr["a_p"], tr["a_sm"], tr["a_mr"])
            loss.backward()
            losses.append(float(loss.detach()))
            mirrors.append(float(aux["mirror_loss"].detach()))
            if i == 0:
                grad1 = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
            opt.step()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    change = {n: p.detach() - weights[n] for n, p in model.named_parameters()}
    return losses, mirrors, grad1, change


def gaps(got: list, want: list) -> float:
    """The worst relative gap of ``got`` from ``want``, step by step;
    infinite where a step is missing."""
    if len(got) != len(want):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def compare(ctx, all_weights, batches, losses, mirrors, grad1, change) -> dict:
    ref_losses, ref_mirrors, ref_grad1, ref_change = reference_steps(ctx, all_weights, batches)
    grads = sorted(ref_grad1)
    median = sorted(float(ref_grad1[n].norm()) for n in grads)[len(grads) // 2]
    moved = [n for n in grads if float(ref_grad1[n].norm()) >= 1e-3 * median]
    # the seed's own sensitivity: the reference's first step against itself in TF32
    _, _, tf32_grad1, _ = reference_steps(ctx, all_weights, batches[:1], tf32=True)
    diff = lambda got: sorted(float((got[n] - ref_grad1[n]).norm() / ref_grad1[n].norm()) if n in got else 1.0  # noqa
                              for n in grads)
    mid = len(grads) // 2
    d, d32 = diff(grad1)[mid], diff(tf32_grad1)[mid]
    return {"loss_gap": gaps(losses, ref_losses), "grad_gap": leaf_gap(grad1, ref_grad1, grads),
            "update_gap": leaf_gap(change, ref_change, moved), "grad_diff_median": d,
            "grad_diff_tf32_median": d32, "grad_diff_ratio": ratio(d, d32),
            "mirror_gap": gaps(mirrors, ref_mirrors)}
