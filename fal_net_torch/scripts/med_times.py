"""Times of the MED kernels and of the paths that run them, on the card.

    python -m fal_net_torch.scripts.med_times

K1 (disp, disp+pan and disp+pan+subocc at (8, 49, 384, 1280); disp+pan at
(8, 49, 192, 640); disp at the evaluation's KITTI shapes (8, 49, 375, 1242)
and its 2/3 shape (8, 49, 250, 828); where the package has K1's direct path,
disp+pan at (8, 49, 16, 11572) beside the ring at (8, 49, 16, 1500)), K2
(disp+pan cotangents, without and with the image gradient, at
(8, 49, 192, 640); and, where the package has K2's direct path, at
(8, 49, 16, 5000) and (8, 49, 16, 11572) beside the ring at
(8, 49, 16, 1500), the same per logit), K5 (the windowed roll at the probe's
(8, 128), wp = 640) beside ``torch.roll`` of the zero-padded row (also in
host microseconds a call, the mean over 5,000 calls, beside one native
single-kernel op, ``torch.neg``, an ``empty_like``, and the events around
an empty call: the launch path's floors), the
FAL_netB N=49 disp forward at batch 8 and batch 1 and 384x1280, and the
stage-1 training step at batch 8 and 192x640: CUDA events around one call,
median of 50 calls after warm-up, on inputs and weights from seed 0.
Prints one JSON object with the card's name.

It calls only entry points that earlier versions of the package have too,
so run as a file with another checkout of the package first on PYTHONPATH
(``PYTHONPATH=OTHER python fal_net_torch/scripts/med_times.py``) it times that
version on the same card, for a comparison inside one machine's run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import fal_net_torch
from fal_net_torch.models import create_model
from fal_net_torch.ops.med_kernel import med_outputs_fused, med_vjp_fused
from fal_net_torch.ops.roll_probe import roll_window
from fal_net_torch.train.stages import stage1_loss
from fal_net_torch.train.state import create_optimizer
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.timing import median_ms

SEED, REPS, B, N = 0, 50, 8, 49
SERVE, TRAIN = (384, 1280), (192, 640)


def host_us(fn, calls: int = 5000) -> float:
    """Host microseconds a call of ``fn``: the mean over ``calls`` calls
    after warm-up, the card drained before and after."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help only
    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED)
    draw = lambda c, hw: torch.from_numpy(rng.standard_normal((B, c, *hw), np.float32)).to(dev)
    out = {}
    lg, im = draw(N, SERVE), draw(3, SERVE)
    for mode, kw in (("disp", {}), ("disp+pan", dict(ret_pan=True)), ("disp+pan+subocc", dict(ret_pan=True, ret_subocc=True))):
        out[f"k1 {mode} {SERVE}"] = median_ms(lambda: med_outputs_fused(lg, im, 2.0, 300.0, ret_disp=True, **kw), REPS)
    del lg, im
    tl, ti, gd, gp = draw(N, TRAIN), draw(3, TRAIN), draw(1, TRAIN), draw(3, TRAIN)
    out[f"k1 disp+pan {TRAIN}"] = median_ms(lambda: med_outputs_fused(tl, ti, 2.0, 300.0, ret_disp=True, ret_pan=True), REPS)
    for img in (False, True):
        out[f"k2 disp+pan{'+g_img' if img else ''} {TRAIN}"] = median_ms(
            lambda: med_vjp_fused(tl, ti, 2.0, 300.0, gd, gp, image_grad=img), REPS
        )
    del tl, ti, gd, gp
    wide = np.random.default_rng(SEED + 1)  # apart, so that the draws below stay as they were
    kitti = np.random.default_rng(SEED + 2)
    for hw in ((375, 1242), (250, 828)):  # the evaluation's bucket shape and its ms-pp shape
        kl, ki = (torch.from_numpy(kitti.standard_normal((B, c, *hw), np.float32)).to(dev) for c in (N, 3))
        out[f"k1 disp {hw}"] = median_ms(lambda: med_outputs_fused(kl, ki, 2.0, 300.0, ret_disp=True), REPS)
        del kl, ki
    for w in (1500, 11572):  # K1's ring, and its direct path (image row unstaged)
        kl, ki = (torch.from_numpy(kitti.standard_normal((B, c, 16, w), np.float32)).to(dev) for c in (N, 3))
        try:
            out[f"k1 disp+pan (16, {w})"] = median_ms(lambda: med_outputs_fused(kl, ki, 2.0, 300.0, ret_disp=True,
                                                                              ret_pan=True), REPS)
        except ValueError:  # a version without K1's direct path refuses W = 11572
            pass
        del kl, ki
    for w in (1500, 5000, 11572):  # K2's ring, and its direct path (image rows unstaged)
        wl, wi, wd, wp = (torch.from_numpy(wide.standard_normal((B, c, 16, w), np.float32)).to(dev) for c in (N, 3, 1, 3))
        try:
            out[f"k2 disp+pan (16, {w})"] = median_ms(lambda: med_vjp_fused(wl, wi, 2.0, 300.0, wd, wp,
                                                                          image_grad=False), REPS)
        except ValueError:  # a version without the direct path refuses W = 5000 (older ones 11572 too)
            pass
        del wl, wi, wd, wp

    row = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal((8, 128), np.float32)).to(dev)
    f = torch.tensor([17], dtype=torch.int32, device=dev)
    padded = row.new_zeros((8, 640))
    padded[:, 128:256] = row
    launches = {
        "k5 roll (8, 128) wp=640": lambda: roll_window(row, f, 640, 128),
        "torch.roll (8, 640) window": lambda: torch.roll(padded, -17, dims=1)[:, 128:256],
    }
    for name, fn in launches.items():
        out[name] = median_ms(fn, REPS)
    floors = {"torch.neg (8, 128)": lambda: torch.neg(row), "empty_like (8, 128)": lambda: torch.empty_like(row)}
    host = {name: host_us(fn) for name, fn in {**launches, **floors}.items()}
    host["events around an empty call (us, median)"] = median_ms(lambda: None, 200) * 1e3

    model = create_model("B", N, generator=torch.Generator().manual_seed(SEED), device=dev)
    left = draw(3, SERVE)
    with torch.inference_mode():
        out[f"forward disp B={B} {SERVE}"] = median_ms(lambda: model(left, 2.0, 300.0, ret_disp=True), REPS)
        out[f"forward disp B=1 {SERVE}"] = median_ms(lambda: model(left[:1], 2.0, 300.0, ret_disp=True), REPS)
    del left
    opt, sched = create_optimizer(
        model, lr=1e-4, beta1=0.5, beta2=0.999, milestones=(30, 40), lr_gamma=0.5, steps_per_epoch=1000
    )
    batch = {"left": draw(3, TRAIN), "right": draw(3, TRAIN)}

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = stage1_loss(model, batch, min_disp=2.0, max_disp=300.0, a_p=0.0, a_sm=0.2 * 2 / 512)
        loss.backward()
        opt.step()
        sched.step()

    out[f"stage-1 step B={B} {TRAIN}"] = median_ms(step, REPS, warmup=5)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {"package": fal_net_torch.__file__, "card": card, "ms": out, "host_us": host}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
