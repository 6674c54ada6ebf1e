"""Times of the MED kernels and of the paths that run them, on the card.

    python -m fal_net_torch.scripts.med_times

K1 and K2 at ``K1_TABLE``'s and ``K2_TABLE``'s shapes: those of PERF.md's
table of the TPU kernels (FAL_netB's N = 49 and FAL_netA/C's N = 33 at the
serving, stage-1 and KITTI shapes in the modes their paths launch, the
validation's subocc batch of 4, the direct paths, K2 also with the image
gradient), the evaluation's 2/3 shape (8, 49, 250, 828) and the ring at
(8, 49, 16, 1500) beside the direct paths (a package without a direct path
refuses W = 5000 and 11572, and the key is left out); K5 (the windowed roll at the probe's
(8, 128), wp = 640) beside ``torch.roll`` of the zero-padded row (also in
host microseconds a call, the mean over 5,000 calls, beside one native
single-kernel op, ``torch.neg``, an ``empty_like``, and the events around
an empty call: the launch path's floors), the
FAL_netB N=49 disp forward at batch 8 and batch 1 and 384x1280, and the
stage-1 training step at batch 8 and 192x640: CUDA events around one call,
median of 50 calls after warm-up, on inputs and weights from seed 0.
Beside K2's times, its accuracy: K2 and the fp32 plain VJP, each against
the plain VJP evaluated in float64 on the same inputs (disp and disp+pan
cotangents at FAL_netA/C's N = 33 and FAL_netB's 49, at the serving and
stage-1 shapes, bounds 2..300), as the largest error over the gradient
tests' tolerance (rtol 1e-4, atol 1e-5; above 1 is a miss).  Prints one
JSON object with the card's name.

L1 (the bf16 logits conv) at ``L1_SHAPES`` beside its bytes bound, the bf16
FAL_netB disp forward at batch 8 (384x1280) and at KITTI's native
375x1242 (batch 8, ``cli.test``'s, and 4, validation's) and the bf16
stage-1 step (batch 8, 192x640) with the fp32 forwards and step beside
them and each forward's peak device memory, and the concat that L1 reads, alone, at the
serving and the evaluation shapes: NCHW ``torch.cat``, a channels-last
concat (the two parts copied into a channels-last buffer) and, where the
package has it, ``pitched_cat`` (the rows on L1's 16-byte pitch).
``--l1`` times only these (python -m fal_net_torch.scripts.med_times --l1).

``--med`` times only K1 and K2 (the tables).

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
from fal_net_torch.ops.logits_conv import logits_conv
from fal_net_torch.ops.med_kernel import med_outputs_fused, med_vjp_fused
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.ops.roll_probe import roll_window
from fal_net_torch.train.stages import stage1_loss
from fal_net_torch.train.state import create_optimizer
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.timing import median_ms

SEED, REPS, B, N = 0, 50, 8, 49
SERVE, TRAIN = (384, 1280), (192, 640)
# L1: ((B, Cin, H, W), Cout, pad_h): the serving forward, batch 1, the stage-1 step, validation, cli.test at
# batch 8 and a rank's halo'd rows under --spatial 4 (as chip_smoke.py's L1_SHAPES)
L1_SHAPES = (((8, 96, 384, 1280), 49, 1), ((1, 96, 384, 1280), 49, 1), ((8, 96, 192, 640), 49, 1),
             ((4, 96, 375, 1242), 49, 1), ((8, 96, 375, 1242), 49, 1), ((8, 96, 98, 640), 49, 0))
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989.4e12  # H100 SXM, NVIDIA data sheet
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # tests/test_med_pallas.py's gradient tests
K2_ERR_SHAPES = ((B, 33, *SERVE), (B, 33, *TRAIN), (B, N, *SERVE), (B, N, *TRAIN))
# K1 and K2 at the shapes of PERF.md's table of the TPU kernels, the evaluation's 2/3 shape and the ring at
# W = 1500: ((B, N, H, W), modes)
K1_TABLE = (((B, N, *SERVE), ("disp", "disp+pan", "disp+pan+subocc")), ((B, N, *TRAIN), ("disp+pan", "disp+pan+subocc")),
            ((4, N, 375, 1242), ("disp+pan+subocc",)), ((B, N, 375, 1242), ("disp",)), ((B, N, 250, 828), ("disp",)),
            ((B, N, 16, 1500), ("disp+pan",)), ((B, N, 16, 11572), ("disp+pan",)),
            ((B, 33, *SERVE), ("disp", "disp+pan", "disp+pan+subocc")), ((B, 33, *TRAIN), ("disp+pan", "disp+pan+subocc")),
            ((B, 33, 375, 1242), ("disp",)))
K2_TABLE = (((B, N, *TRAIN), ("disp+pan", "disp+pan+g_img")), ((B, N, 16, 1500), ("disp+pan",)),
            ((B, N, 16, 5000), ("disp+pan", "disp+pan+g_img")), ((B, N, 16, 11572), ("disp+pan",)),
            ((B, 33, *TRAIN), ("disp+pan",)), ((B, 33, *SERVE), ("disp+pan",)), ((B, 33, 375, 1242), ("disp+pan",)))


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


def peak_gb(fn) -> float:
    """Peak device memory of one call of ``fn``, in GB (here, not imported:
    an older checkout's package may lack it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def k2_errors(dev) -> dict:
    """K2 and the fp32 plain VJP against the plain VJP in float64 at
    K2_ERR_SHAPES (see the module docstring); seeded inputs from SEED + 5."""
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for b, n, h, w in K2_ERR_SHAPES:
        logits, image, g_disp, g_pan = (torch.from_numpy(rng.standard_normal((b, c, h, w), np.float32)).to(dev)
                                        for c in (n, 3, 1, 3))
        for mode, gp in (("disp", None), ("disp+pan", g_pan)):
            k2 = med_vjp_fused(logits, image, 2.0, 300.0, g_disp, gp, image_grad=False)[0]
            f32 = med_vjp(logits, image, 2.0, 300.0, g_disp, gp, image_grad=False)[0]
            up = lambda t: None if t is None else t.double()
            f64 = med_vjp(up(logits), up(image), 2.0, 300.0, up(g_disp), up(gp), image_grad=False)[0]
            over = lambda g: float(((g.double() - f64).abs() / (GRAD_ATOL + GRAD_RTOL * f64.abs())).max())
            out[f"{(b, n, h, w)} {mode}"] = {"k2": over(k2), "plain fp32": over(f32)}
            del k2, f32, f64
        del logits, image, g_disp, g_pan
        torch.cuda.empty_cache()
    return out


def l1_times(dev) -> dict:
    """L1 at L1_SHAPES, its bound, the concat alone, and the bf16 paths that run L1 (see the module
    docstring); inputs drawn on the card from seed SEED + 4."""
    try:  # L1 takes rows on a 16-byte pitch
        from fal_net_torch.ops.logits_conv import pitched_cat, pitched_empty
        pitched = lambda x: pitched_empty(x.shape, x).copy_(x)
    except ImportError:  # an older package takes contiguous NCHW
        pitched, pitched_cat = (lambda x: x.contiguous()), None
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    ms, bounds, cat, paths = {}, {}, {}, {}
    for shape, cout, pad_h in L1_SHAPES:
        cin = shape[1]
        x = pitched(torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16))
        k = (torch.randn((cout, cin, 3, 3), device=dev, generator=gen) / np.sqrt(9 * cin)).to(torch.bfloat16)
        bias = torch.randn(cout, device=dev, generator=gen)
        key = f"{shape} -> {cout} pad_h {pad_h}"
        ms[key] = median_ms(lambda: logits_conv(x, k, bias, pad_h), REPS)
        outs = shape[0] * cout * (shape[2] - 2 + 2 * pad_h) * shape[3]
        moved = x.numel() * 2 + k.numel() * 2 + cout * 4 + outs * 4
        bounds[key] = max(moved / HBM_BYTES_PER_S, 2.0 * outs * 9 * cin / BF16_FLOPS) * 1e3
        del x, k, bias
    for b, h, w in ((B, *SERVE), (B, 375, 1242), (4, 375, 1242)):
        a = torch.randn((b, 64, h, w), device=dev, generator=gen).to(torch.bfloat16)
        c = torch.randn((b, 32, h, w), device=dev, generator=gen).to(torch.bfloat16)

        def channels_last():
            o = torch.empty((b, 96, h, w), device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
            o[:, :64].copy_(a)
            o[:, 64:].copy_(c)
            return o

        fns = {"nchw": lambda: torch.cat([a, c], 1), "channels-last": channels_last}
        if pitched_cat is not None:
            fns["pitched"] = lambda: pitched_cat([a, c])
        for name, fn in fns.items():
            cat[f"{name} {(b, 96, h, w)}"] = median_ms(fn, REPS)
        del a, c
    torch.cuda.empty_cache()
    model = create_model("B", N, generator=torch.Generator().manual_seed(SEED), device=dev)
    for b, hw in ((B, SERVE), (B, (375, 1242)), (4, (375, 1242))):
        left = torch.randn((b, 3, *hw), device=dev, generator=gen)
        for dtype in ("float32", "bfloat16"):
            m = model.with_dtype(dtype)
            with torch.inference_mode():
                fwd = lambda: m(left, 2.0, 300.0, ret_disp=True)
                paths[f"forward disp {dtype} B={b} {hw}"] = median_ms(fwd, REPS)
                paths[f"forward disp {dtype} B={b} {hw} peak GB"] = peak_gb(fwd)
        del left
    opt, sched = create_optimizer(
        model, lr=1e-4, beta1=0.5, beta2=0.999, milestones=(30, 40), lr_gamma=0.5, steps_per_epoch=1000
    )
    batch = {"left": torch.randn((B, 3, *TRAIN), device=dev, generator=gen),
             "right": torch.randn((B, 3, *TRAIN), device=dev, generator=gen)}
    for dtype in ("float32", "bfloat16"):
        m = model.with_dtype(dtype)

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = stage1_loss(m, batch, min_disp=2.0, max_disp=300.0, a_p=0.0, a_sm=0.2 * 2 / 512)
            loss.backward()
            opt.step()
            sched.step()

        paths[f"stage-1 step {dtype} B={B} {TRAIN}"] = median_ms(step, REPS, warmup=5)
    return {"l1": ms, "l1_bound": bounds, "cat": cat, "paths": paths}


def table_times(dev) -> dict:
    """K1 and K2 at K1_TABLE's and K2_TABLE's shapes and modes; inputs drawn
    on the card from seed SEED + 6.  A package without the direct paths
    refuses W = 5000 and 11572: those keys are left out."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    draw = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    out = {}

    def timed(key, fn):
        try:
            out[key] = median_ms(fn, REPS)
        except ValueError:  # no plan fits: no direct path in this package
            pass

    for (b, n, h, w), modes in K1_TABLE:
        logits, image = draw(b, n, h, w), draw(b, 3, h, w)
        for mode in modes:
            kw = dict(ret_disp=True, ret_pan="pan" in mode, ret_subocc="subocc" in mode)
            timed(f"k1 {mode} {(b, n, h, w)}", lambda: med_outputs_fused(logits, image, 2.0, 300.0, **kw))
        del logits, image
    for (b, n, h, w), modes in K2_TABLE:
        logits, image, g_disp, g_pan = draw(b, n, h, w), draw(b, 3, h, w), draw(b, 1, h, w), draw(b, 3, h, w)
        for mode in modes:
            img = "g_img" in mode
            timed(f"k2 {mode} {(b, n, h, w)}", lambda: med_vjp_fused(logits, image, 2.0, 300.0, g_disp, g_pan,
                                                                    image_grad=img))
        del logits, image, g_disp, g_pan
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--l1", action="store_true", help="time only L1, the concat it reads and its bf16 paths")
    parser.add_argument("--med", action="store_true", help="time only K1 and K2 at PERF.md's table's shapes")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    if args.l1:
        return report({}, {}, l1_times(dev))
    out = table_times(dev)
    if args.med:
        return report(out, {}, {})
    rng = np.random.default_rng(SEED)
    draw = lambda c, hw: torch.from_numpy(rng.standard_normal((B, c, *hw), np.float32)).to(dev)

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
    del model, opt, sched, batch
    torch.cuda.empty_cache()
    return report(out, host, {"k2_err_over_tol": k2_errors(dev), **l1_times(dev)})


def report(ms: dict, host: dict, rest: dict) -> dict:
    """Print and return the JSON line, with the card's name and power limit."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {"package": fal_net_torch.__file__, "card": card, "ms": ms, "host_us": host, **rest}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
