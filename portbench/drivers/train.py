"""Training: ``fal_net_torch.train.Trainer`` at stage 1, its ``train_step``
on device batches, as ``Trainer.fit`` calls it.

Traffic parameters: ``stage`` ("stage1"), ``batch``, ``height``, ``width``,
``dtype``, ``a_p`` (the perceptual weight; VGG19 to pool3 with random
weights, which compute what pretrained ones do), ``epoch_pairs`` (the
length the trainer's schedule sees: KITTI's 22,600), ``pool`` (distinct
batches made on the device at set-up and cycled; every pair differs),
``warm_steps`` (at least 3), ``trace_warm_steps``, ``trace_seconds``, and
the reference's hyperparameters (Train_Stage1_K.py): ``lr``, ``beta1``,
``beta2``, ``a_sm``, which both sides are given.

One Trainer is built and set up (its kernel gate included), given the
seeded weights of the model and of VGG19, and driven through its first
steps by ``train_step`` on pool batches 0, 1, 2, ...; the window then goes
on with the same object.  A step started before the window's end counts;
the window closes on a synchronised device.

``correct``: the plain reference (reference/falnet.py, reference/train.py,
fp32, TF32 off, torch's Adam written out) takes the same weights through
the same first three batches.  Compared: each of the three losses
(relative gap), the first gradient as Adam holds it after step 1
(exp_avg / (1 - beta1)), and the parameters' change after step 3, the
last two leaf by leaf as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of
the median leaf, the worst leaf.  Leaves whose reference gradient is under
a thousandth of the median leaf's leave the change's comparison: Adam
moves them by round-off.  Norms average rounding away, so none of those
separates a lower precision; the fourth number does: the median over
leaves of the first gradient's relative difference from the reference's,
over the same of the reference's own first step in TF32 (the
configuration's precision), ``grad_diff_ratio``.
"""

from __future__ import annotations

import math
import time

import torch

from portbench.drivers.serve import ratio, shapes
from portbench.harness import inputs, peaks, trace
from portbench.harness.meter import Meter
from portbench.harness.record import Context, Run, SetupParts, checks
from portbench.metrics import _work
from portbench.reference import falnet as ref_falnet, train as ref_train

CHECKED_STEPS = 3


class _Epoch:
    """A training set of ``n`` pairs that is never read: the trainer's
    loader and schedule take its length, the window feeds device batches."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng=None):
        raise RuntimeError("the benchmark feeds device batches; the loader is not read")


def build(ctx: Context, weights: dict, vgg_weights: dict):
    from fal_net_torch.train import Stage1Config, Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    tcfg = Stage1Config(model=cfg["variant"], num_levels=cfg["num_levels"], min_disp=cfg["min_disp"],
                        max_disp=cfg["max_disp"], batch_size=tr["batch"], crop_size=(tr["height"], tr["width"]),
                        a_p=tr["a_p"], a_sm=tr["a_sm"], lr=tr["lr"], beta1=tr["beta1"], beta2=tr["beta2"],
                        allow_random_vgg=True, compute_dtype=tr["dtype"], workers=1,
                        seed=ctx.seed % 2 ** 31)
    trainer = Trainer(tcfg, tr["stage"], device=ctx.device, train_dataset=_Epoch(tr["epoch_pairs"]))
    trainer.setup()
    trainer.model.load_state_dict(weights)
    if trainer.vgg is not None:
        trainer.vgg.load_state_dict(vgg_weights)
    return trainer


def vgg_shapes() -> dict:
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in ref_train.Vgg19Pool3().state_dict().items()}


def run(ctx: Context) -> Run:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, b = ctx.device, tr["batch"]
    parts = SetupParts(ctx)
    weights = inputs.weights(shapes(cfg["variant"], cfg["num_levels"]), ctx.seed, dev)
    vgg_weights = inputs.weights(vgg_shapes(), ctx.seed, dev, stream=5)
    parts.mark("imports_and_weights")
    trainer = build(ctx, weights, vgg_weights)
    parts.mark("program")
    left, right = inputs.stereo_pairs(tr["pool"] * b, tr["height"], tr["width"], ctx.seed, dev)
    pool = [{"left": left[i * b:(i + 1) * b], "right": right[i * b:(i + 1) * b]} for i in range(tr["pool"])]
    parts.mark("inputs")
    flops = _work.conv_flops(cfg["variant"], cfg["num_levels"], b, tr["height"], tr["width"], train=True,
                             a_p=tr["a_p"], device=dev)
    parts.mark("flop_count")

    names = {id(p): n for n, p in trainer.model.named_parameters()}
    beta1 = tr["beta1"]
    losses, grad1, change = [], {}, {}
    meter = Meter(ctx, ctx.cell.chips)
    k, steps, failed, setup_s = 0, 0, 0, None
    start = tr["warm_steps"] + (tr["trace_warm_steps"] if ctx.trace else 0)
    while meter.t0 is None or meter.elapsed() < meter.open_s:
        with trace.span("train_step"):
            aux = trainer.train_step(pool[k % len(pool)])
        k += 1
        if k <= CHECKED_STEPS:
            losses.append(aux["loss"])
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
                meter.open()
            continue
        steps += 1
        failed += not math.isfinite(aux["loss"])
    meter.close(sync=True)
    meter.stop_profiler()
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(ctx, weights, vgg_weights, pool[:CHECKED_STEPS], losses, grad1, change)
    return Run(setup_s=setup_s, window_s=meter.seconds, launches=meter.launches, attempted=steps, failed=failed,
               checks=checks(ctx, numbers), numbers=numbers, device=meter.device,
               calls={"med_fwd": dict(b=b, n=cfg["num_levels"], h=tr["height"], w=tr["width"], pan=True),
                      "med_bwd": dict(b=b, n=cfg["num_levels"], h=tr["height"], w=tr["width"])},
               flops_per_call=flops, conv_peak=peaks.CONV_PEAK[tr["dtype"]], pairs=steps * b,
               trace=meter.reduced, setup_parts=parts.seconds)


def reference_steps(ctx: Context, weights: dict, vgg_weights: dict, batches: list, tf32: bool = False):
    """(losses, first gradient, change after the last step) of the plain
    step from the same weights on ``batches``, fp32 with TF32 off (or on,
    the configuration's own precision, for ``tf32``)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    model = ref_falnet.FalNet(cfg["variant"], cfg["num_levels"]).to(ctx.device)
    model.load_state_dict(weights)
    vgg = ref_train.Vgg19Pool3().to(ctx.device)
    vgg.load_state_dict(vgg_weights)
    opt = ref_train.Adam(model.parameters(), lr=tr["lr"], betas=(tr["beta1"], tr["beta2"]))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    losses, grad1 = [], {}
    try:
        for i, batch in enumerate(batches):
            loss = ref_train.stage1_loss(model, vgg, batch["left"], batch["right"], cfg["min_disp"],
                                         cfg["max_disp"], tr["a_p"], tr["a_sm"])
            loss.backward()
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
            opt.step()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    change = {n: p.detach() - weights[n] for n, p in model.named_parameters()}
    return losses, grad1, change


def leaf_gap(got: dict, want: dict, names) -> float:
    """The worst leaf of ``names``: |‖got‖ - ‖want‖| / max(‖want‖, median
    ‖want‖); a leaf missing from ``got`` reads a norm of 0."""
    norm = lambda d, n: float(d[n].norm()) if n in d else 0.0  # noqa: E731
    wants = {n: norm(want, n) for n in names}
    median = sorted(wants.values())[len(wants) // 2]
    return max(abs(norm(got, n) - wants[n]) / max(wants[n], median) for n in names)


def compare(ctx, weights, vgg_weights, batches, losses, grad1, change) -> dict:
    ref_losses, ref_grad1, ref_change = reference_steps(ctx, weights, vgg_weights, batches)
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses):
        loss_gaps = [float("inf")]
    grads = sorted(ref_grad1)
    median = sorted(float(ref_grad1[n].norm()) for n in grads)[len(grads) // 2]
    moved = [n for n in grads if float(ref_grad1[n].norm()) >= 1e-3 * median]
    # the seed's own sensitivity: the reference's first step against itself in TF32
    _, tf32_grad1, _ = reference_steps(ctx, weights, vgg_weights, batches[:1], tf32=True)
    diff = lambda got: sorted(float((got[n] - ref_grad1[n]).norm() / ref_grad1[n].norm()) if n in got else 1.0  # noqa
                              for n in grads)
    mid = len(grads) // 2
    d, d32 = diff(grad1)[mid], diff(tf32_grad1)[mid]
    return {"loss_gap": max(loss_gaps), "grad_gap": leaf_gap(grad1, ref_grad1, grads),
            "update_gap": leaf_gap(change, ref_change, moved), "grad_diff_median": d,
            "grad_diff_tf32_median": d32, "grad_diff_ratio": ratio(d, d32)}
