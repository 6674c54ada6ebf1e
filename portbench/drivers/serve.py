"""Serving: ``fal_net_torch.eval.pipeline.DisparityPipeline`` over a closed
loop of raw uint8 frames, as ``cli.infer`` runs it.

Traffic parameters: ``batch``, ``height``, ``width``, ``dtype`` (the
model's compute dtype), ``pool`` (distinct frames, cycled; pool and batch
coprime, so a frame meets every slot of a batch), ``warm_batches``,
``trace_warm_batches``, ``trace_seconds`` and ``sample`` (frames whose
answers are checked).

The source always has the next frame: the pipeline pulls frame k when it
asks for it, and hands its disparity back after the next batch is
dispatched.  The window opens when the last warm frame comes back and
counts the frames that come back in it; a frame's latency runs from its
pull to its hand-back.  When the window closes the source stops and the
pipeline drains.

``correct``: the first answer the window handed back for each of
``sample`` pool frames drawn from the seed (copied once, so the check
costs the window a copy a sampled frame and no more), against the plain reference
(reference/falnet.py, fp32, TF32 off) on the same frame and weights.  The
gap in px moves tenfold from seed to seed with how steep the random
weights make the MED softmax, and the reference's own gap when it runs
its convolutions in TF32 (the configuration's precision) moves with it;
so the numbers compared are the program's gap over that one, of the mean
and of the 99th percentile over every pixel of the sample
(``disp_mean_ratio``, ``disp_p99_ratio``).  The raw gaps are reported
beside them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import inputs, trace
from portbench.harness.meter import Meter
from portbench.harness.record import Context, Run, SetupParts, checks
from portbench.metrics import _work
from portbench.harness import peaks
from portbench.reference import falnet as ref_falnet

RGB_MEAN = (0.411, 0.432, 0.45)
# the gap statistics compare() reads; a cell's limits file names those its check compares
GAPS = ("disp_max_px", "disp_mean_px", "disp_mean_tf32_px", "disp_mean_ratio", "disp_p99_ratio")


def shapes(variant: str, levels: int) -> dict:
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in ref_falnet.FalNet(variant, levels).state_dict().items()}


def build(ctx: Context, weights: dict):
    """The program under test: the port's model with the seeded weights,
    behind its pipeline."""
    from fal_net_torch.eval.pipeline import DisparityPipeline
    from fal_net_torch.models import create_model

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    model = create_model(cfg["variant"], cfg["num_levels"], device=ctx.device, dtype=tr["dtype"])
    model.load_state_dict(weights)
    return DisparityPipeline(model, batch_size=tr["batch"], min_disp=cfg["min_disp"], max_disp=cfg["max_disp"],
                             device_normalize=True)


def run(ctx: Context) -> Run:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, b = ctx.device, tr["batch"]
    parts = SetupParts(ctx)
    weights = inputs.weights(shapes(cfg["variant"], cfg["num_levels"]), ctx.seed, dev)
    parts.mark("imports_and_weights")
    pipe = build(ctx, weights)
    parts.mark("program")
    pool = inputs.frames(tr["pool"], tr["height"], tr["width"], ctx.seed, dev)
    pick = torch.randperm(tr["pool"], generator=inputs.generator(ctx.seed, "cpu", 4))[:tr["sample"]].tolist()
    parts.mark("inputs")
    flops = _work.conv_flops(cfg["variant"], cfg["num_levels"], b, tr["height"], tr["width"], device=dev)
    parts.mark("flop_count")

    meter = Meter(ctx, ctx.cell.chips)
    stop, pulled = [False], {}

    def source():
        k = 0
        while not stop[0]:
            with trace.span("source"):
                pulled[k] = time.perf_counter()
                item = (k, pool[k % len(pool)])
            yield item
            k += 1

    warm = tr["warm_batches"] * b
    start = warm + (tr["trace_warm_batches"] * b if ctx.trace else 0)
    setup_s, served, latencies, kept = None, 0, [], {}
    answers = pipe.run(source())
    n = 0
    while True:
        with trace.span("pipeline"):
            item = next(answers, None)
        if item is None:
            break
        k, disp = item
        n += 1
        now = time.perf_counter()
        t_pull = pulled.pop(k)
        if meter.t0 is None:
            if n == warm:
                setup_s = now - ctx.t_start
                parts.mark("warm_calls")
                meter.start_profiler()
            if n == start:
                meter.open()
            continue
        if meter.seconds is None and now - meter.t0 <= meter.open_s:
            served += 1
            latencies.append(now - t_pull)
            if k % len(pool) in pick and k % len(pool) not in kept:
                kept[k % len(pool)] = np.array(disp, copy=True)
        else:
            meter.close(sync=False)
            stop[0] = True
    meter.stop_profiler()
    del answers, pipe
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers, failed = compare(ctx, weights, pool, pick, kept)
    return Run(setup_s=setup_s, window_s=meter.seconds, launches=meter.launches, attempted=served, failed=failed,
               checks=checks(ctx, numbers), numbers=numbers, device=meter.device,
               calls={"med_fwd": dict(b=b, n=cfg["num_levels"], h=tr["height"], w=tr["width"])},
               flops_per_call=flops, conv_peak=peaks.CONV_PEAK[tr["dtype"]], frames=served,
               latencies_s=latencies, trace=meter.reduced, setup_parts=parts.seconds)


def reference_disp(ctx: Context, weights: dict, frames: np.ndarray, tf32: bool = False) -> torch.Tensor:
    """The plain model's disparities (N, H, W) of uint8 HWC frames, fp32 with
    TF32 off (or on, the configuration's own precision, for ``tf32``), in
    blocks of the cell's batch."""
    cfg = ctx.cell.config
    model = ref_falnet.FalNet(cfg["variant"], cfg["num_levels"]).to(ctx.device)
    model.load_state_dict(weights)
    mean = torch.tensor(RGB_MEAN, device=ctx.device).view(1, 3, 1, 1)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    out = []
    try:
        with torch.no_grad():
            for i in range(0, len(frames), ctx.cell.traffic["batch"]):
                x = torch.from_numpy(frames[i:i + ctx.cell.traffic["batch"]]).to(ctx.device)
                x = x.permute(0, 3, 1, 2).to(torch.float32) / 255.0 - mean
                out.append(model(x, cfg["min_disp"], cfg["max_disp"])[0][:, 0].cpu())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return torch.cat(out)


def ratio(a, b) -> float:
    a, b = float(a), float(b)
    return a / b if b else (0.0 if a == 0 else float("inf"))


def compare(ctx: Context, weights: dict, pool: np.ndarray, pick: list, kept: dict):
    """({number: value}, answers failed): the gap statistics of the checked
    answers, in px over every pixel of the sample; a picked frame the window
    never handed back counts as failed and makes every number infinite."""
    missing = [i for i in pick if i not in kept]
    got = [i for i in pick if i in kept]
    numbers = dict.fromkeys(GAPS, float("inf"))
    if not got:
        return numbers, len(missing)
    want = reference_disp(ctx, weights, pool[got])
    gaps = (torch.from_numpy(np.stack([kept[i] for i in got])) - want).abs()
    per_frame = gaps.flatten(1).amax(1)
    failed = len(missing) + int((~torch.isfinite(per_frame)).sum())
    if not missing:
        flat = gaps.flatten().double()
        # the seed's own sensitivity: the reference against itself in TF32
        flat32 = (reference_disp(ctx, weights, pool[got], tf32=True) - want).abs().flatten().double()
        p99 = lambda t: torch.quantile(t[::7], 0.99)  # noqa: E731  every 7th pixel: quantile's size limit
        numbers = {"disp_max_px": float(per_frame.max()), "disp_mean_px": float(flat.mean()),
                   "disp_mean_tf32_px": float(flat32.mean()), "disp_mean_ratio": ratio(flat.mean(), flat32.mean()),
                   "disp_p99_ratio": ratio(p99(flat), p99(flat32))}
    return numbers, failed
